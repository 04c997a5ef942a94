"""Solver summaries (solver/solver_summary.hpp:97-340 equivalents)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from povar_tpu_torch.solver.common import ResidualInfo, ResidualItem

# TerminationType (solver_summary.hpp)
NO_CONVERGENCE = "NO_CONVERGENCE"
CONVERGENCE = "CONVERGENCE"
FAILURE = "FAILURE"


@dataclass
class IterationSummary:
    """Per-LM-iteration record (solver_summary.hpp:97-219)."""

    iteration: int = 0
    step_is_valid: bool = False
    step_is_successful: bool = False
    cost: Optional[ResidualInfo] = None
    cost_change: Optional[ResidualInfo] = None
    relative_decrease: float = 0.0
    trust_region_radius: float = 0.0
    linear_solver_iterations: int = 0
    linear_solver_type: str = ""
    linear_solver_message: str = ""
    iteration_time_in_seconds: float = 0.0
    cumulative_time_in_seconds: float = 0.0
    step_solver_time_in_seconds: float = 0.0
    residual_evaluation_time_in_seconds: float = 0.0
    jacobian_evaluation_time_in_seconds: float = 0.0
    scale_landmark_jacobian_time_in_seconds: float = 0.0
    scale_pose_jacobian_time_in_seconds: float = 0.0
    landmark_damping_time_in_seconds: float = 0.0
    prepare_time_in_seconds: float = 0.0
    solve_reduced_system_time_in_seconds: float = 0.0
    back_substitution_time_in_seconds: float = 0.0
    update_cameras_time_in_seconds: float = 0.0
    compute_preconditioner_time_in_seconds: float = 0.0
    stage1_time_in_seconds: float = 0.0
    stage2_time_in_seconds: float = 0.0
    perform_qr_time_in_seconds: float = 0.0
    resident_memory: int = 0
    resident_memory_peak: int = 0


@dataclass
class SolverSummary:
    """Whole-solve record (solver_summary.hpp:223-340)."""

    solver_type: str = ""
    termination_type: str = NO_CONVERGENCE
    message: str = ""
    initial_cost: Optional[ResidualInfo] = None
    final_cost: Optional[ResidualInfo] = None
    num_successful_steps: int = 0
    num_unsuccessful_steps: int = 0
    num_linear_solves: int = 0
    num_residual_evaluations: int = 0
    num_jacobian_evaluations: int = 0
    preprocessor_time_in_seconds: float = 0.0
    minimizer_time_in_seconds: float = 0.0
    postprocessor_time_in_seconds: float = 0.0
    total_time_in_seconds: float = 0.0
    linear_solver_time_in_seconds: float = 0.0
    residual_evaluation_time_in_seconds: float = 0.0
    jacobian_evaluation_time_in_seconds: float = 0.0
    logging_time_in_seconds: float = 0.0
    num_threads_given: int = 0
    num_threads_used: int = 0
    num_threads_available: int = 0
    resident_memory_peak: int = 0
    iterations: List[IterationSummary] = field(default_factory=list)


def finish_iteration(summary: SolverSummary, it: IterationSummary) -> None:
    """bal_bundle_adjustment.cpp:61-93: derived fields + push."""
    it.step_solver_time_in_seconds = (
        it.scale_landmark_jacobian_time_in_seconds
        + it.perform_qr_time_in_seconds
        + it.stage2_time_in_seconds
        + it.solve_reduced_system_time_in_seconds
        + it.back_substitution_time_in_seconds
    )
    it.resident_memory = _current_rss()
    try:
        import resource

        usage = resource.getrusage(resource.RUSAGE_SELF)
        it.resident_memory_peak = usage.ru_maxrss * 1024
    except Exception:
        pass
    summary.iterations.append(it)


def _current_rss() -> int:
    """Current resident set size in bytes (get_memory_info,
    util/system_utils.cpp:52-89 reads /proc/self/statm the same way)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        import os

        return pages * os.sysconf("SC_PAGE_SIZE")
    except Exception:
        return 0


def finish_solve(summary: SolverSummary, solver_type_name: str) -> None:
    """bal_bundle_adjustment.cpp:97-159."""
    summary.solver_type = solver_type_name
    if summary.iterations:
        summary.initial_cost = summary.iterations[0].cost
        for it in reversed(summary.iterations):
            if it.step_is_successful:
                summary.final_cost = it.cost
                break
    summary.num_successful_steps = -1  # don't count iteration 0
    summary.num_unsuccessful_steps = 0
    for it in summary.iterations:
        if it.step_is_successful:
            summary.num_successful_steps += 1
        else:
            summary.num_unsuccessful_steps += 1
    summary.linear_solver_time_in_seconds = sum(
        it.step_solver_time_in_seconds for it in summary.iterations
    )
    summary.residual_evaluation_time_in_seconds = sum(
        it.residual_evaluation_time_in_seconds for it in summary.iterations
    )
    summary.jacobian_evaluation_time_in_seconds = sum(
        it.jacobian_evaluation_time_in_seconds for it in summary.iterations
    )
    try:
        import resource

        usage = resource.getrusage(resource.RUSAGE_SELF)
        summary.resident_memory_peak = usage.ru_maxrss * 1024
    except Exception:
        pass
    # thread-count analogue: the devices the solve may use
    # (solver_summary.hpp:num_threads_*; ScopedTbbThreadLimit has no
    # analogue here)
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    if summary.num_threads_available == 0:
        summary.num_threads_available = n
    if summary.num_threads_given == 0:
        summary.num_threads_given = summary.num_threads_used or n
    if summary.num_threads_used == 0:
        summary.num_threads_used = summary.num_threads_given

"""ba_log.json writer with the reference's actual on-disk schema (a copy
of povar_tpu/utils/ba_log.py: the port's logs have the JAX package's
schema, so povar_tpu.tools and the reference's tooling read them).

The reference writes a FLAT column-major log (ba_log.cpp:60-150): every
BaIteration field becomes a top-level array with one entry per
iteration (`result[name].push_back(value)` per iteration), plus
`_type: "rootba_povar"` (ba_log.cpp:110) and
`_static: {problem_info, timing, solver}` (ba_log.cpp:113,
ba_log.hpp:247-259). Both steps append to ONE iteration list: step 2
does not reset the summary (bal_bundle_adjustment.cpp:556-583 resets
only the num_* counters), so the arrays span step-1 iterations followed
by step-2 iterations with the `iteration` counter restarting at 0.

The reference's offline tooling reads exactly this shape —
`l.cost[it]`, `l.stage1_time.sum()`, `l._static.solver.solver_type`
(python/rootba/metric.py:126-190, log.py:91-99) — and is verified
against our output in tests/test_ba_log_schema.py.

Carry-forward semantics (ba_log_utils.cpp:99-141): unsuccessful
iterations repeat the previous iteration's cost fields (for monotonic
plots) and zero the change/step fields.

In addition to the reference schema we keep our own nested sections
(`problem_info`, `timing`, `solver1`/`iterations1`,
`solver`/`iterations`) — the reference format tolerates extra keys and
povar_tpu.tools reads both layouts.
"""

from __future__ import annotations

import json
from typing import List, Optional

from povar_tpu_torch.problem.problem import DatasetSummary
from povar_tpu_torch.utils.summary import IterationSummary, SolverSummary


def _stats(summary: DatasetSummary) -> dict:
    return {
        "mean": summary.per_lm_obs_mean,
        "min": summary.per_lm_obs_min,
        "max": summary.per_lm_obs_max,
        "stddev": summary.per_lm_obs_stddev,
    }


def _iteration_record(
    it: IterationSummary, prev: Optional[dict] = None
) -> dict:
    """BaIteration fields (ba_log.hpp:147-245 + ba_log_utils.cpp copy).

    Like the flat writer, REJECTED iterations carry the cost/residual
    fields forward from the previous record (the state is unchanged;
    the trial cost — possibly NaN from a wildly-damped trial — is not
    the state's cost)."""
    cost = it.cost
    rec = {
        "iteration": it.iteration,
        "linear_solver_type": it.linear_solver_type,
        "step_is_valid": it.step_is_valid,
        "step_is_nonmonotonic": False,
        "step_is_successful": it.step_is_successful,
        "num_obs": cost.all.num_obs if cost else 0,
        "num_obs_valid": cost.valid.num_obs if cost else 0,
        "cost": cost.all.error if cost else 0.0,
        "cost_valid": cost.valid.error if cost else 0.0,
        "cost_avg_valid": cost.valid.error_avg() if cost else 0.0,
        "residual_block_mean": cost.all.residual_mean() if cost else 0.0,
        "residual_block_valid_mean": (
            cost.valid.residual_mean() if cost else 0.0
        ),
        "relative_decrease": it.relative_decrease,
        "trust_region_radius": it.trust_region_radius,
        "linear_solver_iterations": it.linear_solver_iterations,
        "iteration_time": it.iteration_time_in_seconds,
        "cumulative_time": it.cumulative_time_in_seconds,
        "step_solver_time": it.step_solver_time_in_seconds,
        "residual_evaluation_time": it.residual_evaluation_time_in_seconds,
        "jacobian_evaluation_time": it.jacobian_evaluation_time_in_seconds,
        "scale_landmark_jacobian_time": (
            it.scale_landmark_jacobian_time_in_seconds
        ),
        "scale_pose_jacobian_time": it.scale_pose_jacobian_time_in_seconds,
        "landmark_damping_time": it.landmark_damping_time_in_seconds,
        "prepare_time": it.prepare_time_in_seconds,
        "solve_reduced_system_time": (
            it.solve_reduced_system_time_in_seconds
        ),
        "back_substitution_time": it.back_substitution_time_in_seconds,
        "update_cameras_time": it.update_cameras_time_in_seconds,
        "stage1_time": it.stage1_time_in_seconds,
        "stage2_time": it.stage2_time_in_seconds,
        "perform_qr_time": it.perform_qr_time_in_seconds,
        "compute_preconditioner_time": (
            it.compute_preconditioner_time_in_seconds
        ),
        "resident_memory": it.resident_memory,
        "resident_memory_peak": it.resident_memory_peak,
    }
    if not it.step_is_successful and prev is not None:
        for f in (
            "num_obs", "num_obs_valid", "cost", "cost_valid",
            "cost_avg_valid", "residual_block_mean",
            "residual_block_valid_mean",
        ):
            rec[f] = prev[f]
    return rec


def _iteration_records(iterations) -> List[dict]:
    out: List[dict] = []
    prev = None
    for it in iterations:
        prev = _iteration_record(it, prev)
        out.append(prev)
    return out


def _solver_record(s: SolverSummary) -> dict:
    """BaSolver (ba_log.hpp:107-145)."""
    return {
        "solver_type": s.solver_type,
        "termination_type": s.termination_type,
        "message": s.message,
        "num_successful_steps": s.num_successful_steps,
        "num_unsuccessful_steps": s.num_unsuccessful_steps,
        "logging_time_in_seconds": s.logging_time_in_seconds,
        "grouping_time_in_seconds": 0.0,
        "preprocessor_time_in_seconds": s.preprocessor_time_in_seconds,
        "minimizer_time_in_seconds": s.minimizer_time_in_seconds,
        "postprocessor_time_in_seconds": s.postprocessor_time_in_seconds,
        "total_time_in_seconds": s.total_time_in_seconds,
        "linear_solver_time_in_seconds": s.linear_solver_time_in_seconds,
        "num_linear_solves": s.num_linear_solves,
        "residual_evaluation_time_in_seconds": (
            s.residual_evaluation_time_in_seconds
        ),
        "num_residual_evaluations": s.num_residual_evaluations,
        "jacobian_evaluation_time_in_seconds": (
            s.jacobian_evaluation_time_in_seconds
        ),
        "num_jacobian_evaluations": s.num_jacobian_evaluations,
        "num_threads_given": s.num_threads_given,
        "num_threads_used": s.num_threads_used,
        "num_threads_available": s.num_threads_available,
        "resident_memory_peak": s.resident_memory_peak,
        "fraction_grouped": 0.0,
        "merge_factor": True,
    }


# every BaIteration field (ba_log.hpp:147-245), in declaration order
_REF_ITERATION_FIELDS = [
    "iteration",
    "linear_solver_type",
    "step_is_valid",
    "step_is_nonmonotonic",
    "step_is_successful",
    "num_obs",
    "num_obs_valid",
    "num_obs_valid_change",
    "cost",
    "cost_change",
    "cost_valid",
    "cost_valid_change",
    "cost_avg_valid",
    "cost_avg_valid_change",
    "grad_projected_norm",
    "grad_projected_max_norm",
    "grad_norm",
    "grad_max_norm",
    "residual_block_mean",
    "residual_block_valid_mean",
    "step_norm",
    "relative_decrease",
    "trust_region_radius",
    "linear_solver_iterations",
    "iteration_time",
    "cumulative_time",
    "logging_time",
    "step_solver_time",
    "residual_evaluation_time",
    "jacobian_evaluation_time",
    "scale_landmark_jacobian_time",
    "perform_qr_time",
    "stage1_time",
    "scale_pose_jacobian_time",
    "landmark_damping_time",
    "compute_preconditioner_time",
    "compute_gradient_time",
    "stage2_time",
    "prepare_time",
    "solve_reduced_system_time",
    "back_substitution_time",
    "update_cameras_time",
    "resident_memory",
    "resident_memory_peak",
]

# fields carried forward from the previous iteration on unsuccessful
# steps (ba_log_utils.cpp:125-141, for monotonic plots)
_CARRY_FIELDS = [
    "num_obs",
    "num_obs_valid",
    "cost",
    "cost_valid",
    "cost_avg_valid",
    "residual_block_mean",
    "residual_block_valid_mean",
    "grad_max_norm",
    "grad_norm",
]
# the corresponding change fields zeroed on unsuccessful steps
_ZERO_FIELDS = [
    "num_obs_valid_change",
    "cost_change",
    "cost_valid_change",
    "cost_avg_valid_change",
    "step_norm",
    "relative_decrease",
]


def _flat_record(
    it: IterationSummary,
    prev: Optional[dict],
    prev_raw_cost,
) -> dict:
    """One BaIteration log entry (log_summary, ba_log_utils.cpp:99-186).

    `prev` is the previous EMITTED record (carry-forward source);
    `prev_raw_cost` is the previous iteration's raw summary cost
    (finish_iteration computes cost_change against the raw previous
    record, bal_bundle_adjustment.cpp:75-78, not the carried one).
    """
    cost = it.cost
    rec = dict.fromkeys(_REF_ITERATION_FIELDS, 0.0)
    rec["iteration"] = it.iteration
    rec["linear_solver_type"] = it.linear_solver_type
    rec["step_is_valid"] = bool(it.step_is_valid)
    rec["step_is_nonmonotonic"] = False
    rec["step_is_successful"] = bool(it.step_is_successful)

    if it.step_is_successful or prev is None:
        rec["num_obs"] = cost.all.num_obs if cost else 0
        rec["num_obs_valid"] = cost.valid.num_obs if cost else 0
        rec["cost"] = cost.all.error if cost else 0.0
        rec["cost_valid"] = cost.valid.error if cost else 0.0
        rec["cost_avg_valid"] = cost.valid.error_avg() if cost else 0.0
        rec["residual_block_mean"] = (
            cost.all.residual_mean() if cost else 0.0
        )
        rec["residual_block_valid_mean"] = (
            cost.valid.residual_mean() if cost else 0.0
        )
        rec["relative_decrease"] = it.relative_decrease
        if it.iteration > 0 and prev_raw_cost is not None and cost:
            # "previous - current" (residual_info.cpp:43-53)
            rec["cost_change"] = prev_raw_cost.all.error - cost.all.error
            rec["cost_valid_change"] = (
                prev_raw_cost.valid.error - cost.valid.error
            )
            rec["cost_avg_valid_change"] = (
                prev_raw_cost.valid.error_avg() - cost.valid.error_avg()
            )
            rec["num_obs_valid_change"] = (
                prev_raw_cost.valid.num_obs - cost.valid.num_obs
            )
    else:
        for f in _CARRY_FIELDS:
            rec[f] = prev[f]
        for f in _ZERO_FIELDS:
            rec[f] = 0.0 if f != "num_obs_valid_change" else 0

    rec["trust_region_radius"] = it.trust_region_radius
    rec["linear_solver_iterations"] = it.linear_solver_iterations
    rec["iteration_time"] = it.iteration_time_in_seconds
    rec["cumulative_time"] = it.cumulative_time_in_seconds
    rec["logging_time"] = 0.0
    rec["step_solver_time"] = it.step_solver_time_in_seconds
    rec["residual_evaluation_time"] = (
        it.residual_evaluation_time_in_seconds
    )
    rec["jacobian_evaluation_time"] = (
        it.jacobian_evaluation_time_in_seconds
    )
    rec["scale_landmark_jacobian_time"] = (
        it.scale_landmark_jacobian_time_in_seconds
    )
    rec["perform_qr_time"] = it.perform_qr_time_in_seconds
    rec["stage1_time"] = it.stage1_time_in_seconds
    rec["scale_pose_jacobian_time"] = (
        it.scale_pose_jacobian_time_in_seconds
    )
    rec["landmark_damping_time"] = it.landmark_damping_time_in_seconds
    rec["compute_preconditioner_time"] = (
        it.compute_preconditioner_time_in_seconds
    )
    rec["compute_gradient_time"] = 0.0
    rec["stage2_time"] = it.stage2_time_in_seconds
    rec["prepare_time"] = it.prepare_time_in_seconds
    rec["solve_reduced_system_time"] = (
        it.solve_reduced_system_time_in_seconds
    )
    rec["back_substitution_time"] = it.back_substitution_time_in_seconds
    rec["update_cameras_time"] = it.update_cameras_time_in_seconds
    rec["resident_memory"] = it.resident_memory
    rec["resident_memory_peak"] = it.resident_memory_peak
    return rec


def _static_solver(
    s1: SolverSummary, s2: Optional[SolverSummary]
) -> dict:
    """The reference's single BaSolver static section for the combined
    solve: step 2 appends to the SAME summary object (cpp:556-583), so
    termination/message/timing come from the step-2 finish while
    solver_type names the step-1 solver (finish_solve switches on
    solver_type_step_1, cpp:97-114) and the step counters/time sums run
    over ALL iterations of both steps. The num_* counters are reset at
    the start of step 2 (cpp:581-583) and therefore count step 2 only —
    a reference quirk reproduced faithfully."""
    last = s2 if s2 is not None else s1
    all_iters = list(s1.iterations) + (
        list(s2.iterations) if s2 is not None else []
    )
    # "-1": don't count iteration 0 (cpp:126-128). With two steps both
    # iteration-0 records are successful and only one is discounted,
    # exactly as the reference's single counter behaves.
    n_succ = -1 + sum(1 for it in all_iters if it.step_is_successful)
    n_unsucc = sum(1 for it in all_iters if not it.step_is_successful)
    return {
        "solver_type": s1.solver_type,
        "termination_type": last.termination_type,
        "message": last.message,
        "num_successful_steps": n_succ,
        "num_unsuccessful_steps": n_unsucc,
        "logging_time_in_seconds": 0.0,
        "grouping_time_in_seconds": 0.0,
        "preprocessor_time_in_seconds": last.preprocessor_time_in_seconds,
        "minimizer_time_in_seconds": last.minimizer_time_in_seconds,
        "postprocessor_time_in_seconds": (
            last.postprocessor_time_in_seconds
        ),
        "total_time_in_seconds": last.total_time_in_seconds,
        "linear_solver_time_in_seconds": sum(
            it.step_solver_time_in_seconds for it in all_iters
        ),
        "num_linear_solves": last.num_linear_solves,
        "residual_evaluation_time_in_seconds": sum(
            it.residual_evaluation_time_in_seconds for it in all_iters
        ),
        "num_residual_evaluations": last.num_residual_evaluations,
        "jacobian_evaluation_time_in_seconds": sum(
            it.jacobian_evaluation_time_in_seconds for it in all_iters
        ),
        "num_jacobian_evaluations": last.num_jacobian_evaluations,
        "num_threads_given": last.num_threads_given,
        "num_threads_used": last.num_threads_used,
        "num_threads_available": last.num_threads_available,
        "resident_memory_peak": last.resident_memory_peak,
        "fraction_grouped": 0.0,
        "merge_factor": True,
    }


def build_log(
    dataset_summary: DatasetSummary,
    summary_step1: SolverSummary,
    summary_step2: Optional[SolverSummary] = None,
    timing: Optional[dict] = None,
    device_memory: Optional[dict] = None,
) -> dict:
    """Assemble the full log dict: the reference's flat schema plus our
    nested convenience sections."""
    timing = timing or {}
    problem_info = {
        "type": dataset_summary.type,
        "input_path": dataset_summary.input_path,
        "num_cameras": dataset_summary.num_cameras,
        "num_landmarks": dataset_summary.num_landmarks,
        "num_observations": dataset_summary.num_observations,
        "rcs_sparsity": dataset_summary.rcs_sparsity,
        "per_lm_obs": _stats(dataset_summary),
        "per_host_lms": {
            "mean": 0.0, "min": 0.0, "max": 0.0, "stddev": 0.0
        },
    }
    timing_rec = {
        "total": timing.get("total", 0.0),
        "load": timing.get("load_time", 0.0),
        "preprocess": timing.get("preprocess_time", 0.0),
        "optimize": timing.get("optimize_time", 0.0),
        "postprocess": timing.get("postprocess_time", 0.0),
    }

    # --- the reference's flat column-major arrays over BOTH steps
    log: dict = {name: [] for name in _REF_ITERATION_FIELDS}
    steps = [summary_step1] + (
        [summary_step2] if summary_step2 is not None else []
    )
    prev_rec = None
    for s in steps:
        prev_raw = None  # cost_change does not cross the step boundary
        for it in s.iterations:
            rec = _flat_record(it, prev_rec, prev_raw)
            for name in _REF_ITERATION_FIELDS:
                log[name].append(rec[name])
            prev_rec = rec
            prev_raw = it.cost
    log["_type"] = "rootba_povar"
    log["_static"] = {
        "problem_info": problem_info,
        "timing": timing_rec,
        "solver": _static_solver(summary_step1, summary_step2),
    }

    # --- povar_tpu nested sections (extra keys; tolerated by the
    # reference tooling, used by povar_tpu.tools)
    log["problem_info"] = problem_info
    log["timing"] = timing_rec
    log["solver1"] = _solver_record(summary_step1)
    log["iterations1"] = _iteration_records(summary_step1.iterations)
    if summary_step2 is not None:
        log["solver"] = _solver_record(summary_step2)
        log["iterations"] = _iteration_records(summary_step2.iterations)
    if device_memory:
        # device-side memory view the reference lacks (its RSS sampling
        # is host-only, system_utils.cpp:52-89)
        log["device_memory"] = device_memory
    return log


def save_json(
    path: str,
    dataset_summary: DatasetSummary,
    summary_step1: SolverSummary,
    summary_step2: Optional[SolverSummary] = None,
    timing: Optional[dict] = None,
    save_ubjson: bool = False,
    device_memory: Optional[dict] = None,
) -> None:
    """Write ba_log.json (and optionally .ubjson) in the reference's
    schema (ba_log.cpp save_json:60-150)."""
    log = build_log(
        dataset_summary,
        summary_step1,
        summary_step2,
        timing=timing,
        device_memory=device_memory,
    )
    with open(path, "w") as f:
        json.dump(log, f, indent=1)
    if save_ubjson:
        from povar_tpu_torch.utils import ubjson

        ub_path = path[: -len(".json")] + ".ubjson" if path.endswith(
            ".json"
        ) else path + ".ubjson"
        with open(ub_path, "wb") as f:
            f.write(ubjson.dumps(log))

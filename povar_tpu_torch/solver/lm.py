"""Levenberg-Marquardt trust-region loop of both steps (on the host).

The counterpart of `optimize_step1`, `optimize_step2` and
`_optimize_lm_loop` in povar_tpu/solver/lm.py (host loop, fused trial),
re-implementing the reference LM control flow of optimize_lm_ours_pOSE
(solver/bal_bundle_adjustment.cpp:252-542) and
optimize_homogeneous_joint (cpp:557-843):
  - lambda = 1 / trust_region_radius in [1/max_tr, 1/min_tr]
  - vee-factor backtracking: on reject lambda *= lambda_vee,
    lambda_vee *= vee_factor; on success lambda *= max(1/3,
    1 - (2 rho - 1)^3) clamped to min_lambda, lambda_vee reset
  - non-finite increment => invalid step, raise lambda, count iteration
  - step 1 accepts iff f_diff > 0 (cpp:445-448); step 2 holds a step
    valid iff l_diff > 0 and accepts iff it is valid and its quality
    f_diff / l_diff exceeds min_relative_decrease (cpp:741-747)
  - function_tolerance on |cost_change| <= ftol * cost of the selected
    optimized_cost channel (cpp:179-205), against the previous RECORDED
    trial
  - iteration 0 is error evaluation + logging only
  - unlimited inner backtracking per linearization point, with the outer
    iteration counter advancing every inner trial

Each trial is one `Stage1Solver.trial` / `Stage2Solver.trial` (solve +
apply + cost) followed by ONE device->host transfer of the scalars the
accept/reject rule needs. Under `detailed_timing` the loop runs the
staged trial of the JAX package's `_optimize_lm_loop` with `trial=None`
instead: the solvers' `solve_timed`, the NaN check on the host,
`apply_timed`, then the cost, each stage's spans written into the
iteration's `*_time_in_seconds` fields (solver_summary.hpp:186-212).

`optimize_step1` / `optimize_step2` choose the loop as the JAX
package's do (povar_tpu/solver/lm.py:554-560, 661-666): the device loop
(solver/device_loop.py, no host synchronisation inside a step) where
`slots.use_device_loop` says so, which under `device_lm_loop="auto"`
(the default) is every single-device solve with the fused trial and
without per-stage timing, else this host loop.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from povar_tpu_torch.options import OptimizedCost, SolverOptions, SolverType
from povar_tpu_torch.solver.common import (
    ResidualInfo,
    error_summary_oneline,
    to_host,
)
from povar_tpu_torch.solver.device_loop import (
    DeviceLmRun,
    drive_device_loop,
    wrapper_token,
)
from povar_tpu_torch.solver.slots import use_device_loop
from povar_tpu_torch.solver.stage1 import Stage1Solver
from povar_tpu_torch.solver.stage2 import Stage2Solver
from povar_tpu_torch.utils.summary import (
    CONVERGENCE,
    NO_CONVERGENCE,
    IterationSummary,
    SolverSummary,
    finish_iteration,
    finish_solve,
)
from povar_tpu_torch.utils.timer import Timer


def _compute_cost_decrease(
    before: ResidualInfo, after: ResidualInfo, optimized_cost: OptimizedCost
) -> float:
    """bal_bundle_adjustment.cpp:163-176."""
    if optimized_cost == OptimizedCost.ERROR:
        return before.all.error - after.all.error
    if optimized_cost == OptimizedCost.ERROR_VALID:
        return before.valid.error - after.valid.error
    return before.valid.error_avg() - after.valid.error_avg()


def _function_tolerance_reached(
    cost: ResidualInfo,
    prev_cost: Optional[ResidualInfo],
    options: SolverOptions,
) -> Tuple[bool, str]:
    """bal_bundle_adjustment.cpp:179-205. `prev_cost` is the cost of
    the previous RECORDED trial (after backtracking: the last rejected
    trial's cost, not the linearization point's); a NaN-increment
    record carries no cost (None -> change = cost itself)."""
    prev_all = prev_cost.all.error if prev_cost is not None else 0.0
    prev_valid = prev_cost.valid.error if prev_cost is not None else 0.0
    if options.optimized_cost == OptimizedCost.ERROR:
        c = cost.all.error
        change = abs(prev_all - cost.all.error)
    else:
        c = cost.valid.error
        change = abs(prev_valid - cost.valid.error)
    if change <= options.function_tolerance * c:
        return True, (
            f"Function tolerance reached. |cost_change|/cost: "
            f"{change / c} <= {options.function_tolerance}"
        )
    return False, ""


def damping_factor(q: float) -> float:
    """The LM lambda multiplier on an accepted step,
    max(1/3, 1 - (2 rho - 1)^3) (bal_bundle_adjustment.cpp:452-455), in
    plain f64. The JAX package evaluates it through XLA, which fuses the
    expression into an FMA: the two lambda schedules differ by ~1 ulp."""
    t = 2.0 * q - 1.0
    return max(1.0 / 3, 1.0 - t * t * t)


# the staged spans' IterationSummary fields (povar_tpu/solver/lm.py:91-105)
_TIMING_FIELDS = {
    "jacobian_evaluation": "jacobian_evaluation_time_in_seconds",
    "scale_landmark_jacobian": "scale_landmark_jacobian_time_in_seconds",
    "scale_pose_jacobian": "scale_pose_jacobian_time_in_seconds",
    "perform_qr": "perform_qr_time_in_seconds",
    "stage2": "stage2_time_in_seconds",
    "landmark_damping": "landmark_damping_time_in_seconds",
    "prepare": "prepare_time_in_seconds",
    "compute_preconditioner": "compute_preconditioner_time_in_seconds",
    "solve_reduced_system": "solve_reduced_system_time_in_seconds",
    "back_substitution": "back_substitution_time_in_seconds",
    "update_cameras": "update_cameras_time_in_seconds",
}


def _set_timings(it_summary: IterationSummary, tdict: dict) -> None:
    """Copy staged per-stage wall times into the iteration summary."""
    for k, v in tdict.items():
        setattr(it_summary, _TIMING_FIELDS[k], float(v))


def _optimize_lm_loop(
    *,
    options: SolverOptions,
    max_lm_iter: int,
    compute_error: Callable[[], ResidualInfo],
    linearize: Callable[[], Optional[dict]],
    accept: Callable[[], None],
    reject: Callable[[], None],
    summary: SolverSummary,
    timer_total: Timer,
    log: Callable[[str], None],
    accept_rule: str,  # "step1" (f_diff > 0) or "step2" (quality gate)
    initialize: Optional[Callable[[], None]] = None,
    trial: Optional[Callable[[float],
                             Tuple[bool, int, float, ResidualInfo]]] = None,
    solve: Optional[Callable[[float], Tuple[bool, int, dict]]] = None,
    apply_step: Optional[Callable[[], Tuple[float, dict]]] = None,
) -> None:
    """The LM loop of both steps (the reference duplicates this loop
    twice; the accept rule and the stage callbacks are the only
    differences). With `trial` each trial is the fused solve + apply +
    cost; without it, the staged one: `solve(lam)` -> (increment finite,
    inner iterations, spans), the NaN check, `apply_step()` -> (l_diff,
    spans), `compute_error()`; `linearize` returns its spans or None."""
    min_lambda = 1.0 / options.max_trust_region_radius
    max_lambda = 1.0 / options.min_trust_region_radius
    lam = 1.0 / options.initial_trust_region_radius
    lambda_vee = options.initial_vee

    valid_first = options.use_projection_validity_check()
    terminated = False
    it = 0
    first = True
    cached_ri = None  # error of the current state from the last accept

    while it <= max_lm_iter and not terminated:
        it_summary = IterationSummary(iteration=it)
        timer_iteration = Timer()

        if first and initialize is not None:
            initialize()
        # the reference re-evaluates the cost at the top of every outer
        # iteration (bal_bundle_adjustment.cpp:301-305); after an accept
        # the state is unchanged since ri2, so reuse it
        ri = cached_ri if cached_ri is not None else compute_error()
        first = False
        log(f"Iteration {it}, {error_summary_oneline(ri, valid_first)}")
        if not ri.is_numerically_valid:
            raise FloatingPointError(
                "did not expect numerical failure during linearization"
            )

        if it == 0:
            it_summary.cost = ri
            it_summary.trust_region_radius = 1.0 / lam
            it_summary.iteration_time_in_seconds = timer_iteration.elapsed()
            it_summary.cumulative_time_in_seconds = timer_total.elapsed()
            it_summary.step_is_successful = True
            it_summary.step_is_valid = True
            finish_iteration(summary, it_summary)
            it += 1
            continue

        t_stage1 = Timer()
        t_lin = linearize()
        it_summary.stage1_time_in_seconds = t_stage1.elapsed()
        if t_lin is None:
            it_summary.jacobian_evaluation_time_in_seconds = (
                it_summary.stage1_time_in_seconds
            )
        else:
            _set_timings(it_summary, t_lin)
        summary.num_jacobian_evaluations += 1

        # inner backtracking loop (unlimited, cpp:337-340)
        j = 0
        while it <= max_lm_iter and not terminated:
            if j > 0:
                log(f"Iteration {it}, backtracking")
                it_summary = IterationSummary(iteration=it)
                timer_iteration = Timer()
            j += 1

            if trial is not None:
                # solve + apply + cost as one trial; the whole span lands
                # in solve_reduced_system_time
                t_solve = Timer()
                step_ok, lin_iters, l_diff, ri2 = trial(lam)
                it_summary.solve_reduced_system_time_in_seconds = (
                    t_solve.elapsed()
                )
            else:
                step_ok, lin_iters, t_sol = solve(lam)
                _set_timings(it_summary, t_sol)
            it_summary.linear_solver_iterations = int(lin_iters)
            summary.num_linear_solves += 1

            if not step_ok:
                # NaN increment: invalid step (cpp:362-401)
                it_summary.step_is_valid = False
                it_summary.step_is_successful = False
                log(
                    f"\t[Invalid] Numeric issues when computing increment "
                    f"(contains NaNs), lambda: {lam:.1e}"
                )
                lam = lambda_vee * lam
                lambda_vee *= options.vee_factor
                it_summary.trust_region_radius = 1.0 / lam
                it_summary.iteration_time_in_seconds = (
                    timer_iteration.elapsed()
                )
                it_summary.cumulative_time_in_seconds = timer_total.elapsed()
                finish_iteration(summary, it_summary)
                it += 1
                if lam > max_lambda:
                    terminated = True
                    summary.termination_type = NO_CONVERGENCE
                    summary.message = (
                        "Solver did not converge and reached maximum "
                        f"damping lambda of {max_lambda}"
                    )
                continue

            if trial is None:
                l_diff, t_app = apply_step()
                _set_timings(it_summary, t_app)
                t_res = Timer()
                ri2 = compute_error()
                it_summary.residual_evaluation_time_in_seconds = (
                    t_res.elapsed()
                )
            summary.num_residual_evaluations += 1
            it_summary.cost = ri2

            if not ri2.is_numerically_valid:
                it_summary.step_is_valid = False
                it_summary.step_is_successful = False
                log(
                    "\t[EVAL] failed to evaluate cost: "
                    + error_summary_oneline(ri2, valid_first)
                )
            else:
                f_diff = _compute_cost_decrease(
                    ri, ri2, options.optimized_cost
                )
                if options.optimized_cost == OptimizedCost.ERROR_VALID_AVG:
                    l_diff = l_diff / ri.valid.num_obs
                step_quality = f_diff / l_diff if l_diff != 0 else math.inf
                log(
                    f"\t[EVAL] f_diff {f_diff:.4e} l_diff {l_diff:.4e} "
                    f"ri1 {ri.valid.error:.4e} ri2 {ri2.valid.error:.4e}"
                )
                it_summary.relative_decrease = step_quality
                if accept_rule == "step1":
                    # cpp:445-448
                    it_summary.step_is_valid = True
                    it_summary.step_is_successful = f_diff > 0
                else:
                    # cpp:741-747
                    it_summary.step_is_valid = l_diff > 0
                    it_summary.step_is_successful = (
                        it_summary.step_is_valid
                        and step_quality > options.min_relative_decrease
                    )

            if it_summary.step_is_successful:
                accept()
                log(
                    f"\t[Success] error: {ri2.all.error:.4e}, "
                    f"lambda: {lam:.1e}, it_time: "
                    f"{timer_iteration.elapsed():.3f}s, total_time: "
                    f"{timer_total.elapsed():.3f}s"
                )
                lam *= damping_factor(it_summary.relative_decrease)
                lam = max(min_lambda, lam)
                lambda_vee = options.initial_vee

                it_summary.trust_region_radius = 1.0 / lam
                it_summary.iteration_time_in_seconds = (
                    timer_iteration.elapsed()
                )
                it_summary.cumulative_time_in_seconds = timer_total.elapsed()
                # the ftol check compares against the cost of the
                # previous RECORDED trial (cpp:476/776)
                prev_rec_cost = (
                    summary.iterations[-1].cost
                    if summary.iterations
                    else None
                )
                finish_iteration(summary, it_summary)
                it += 1

                cached_ri = ri2
                reached, msg = _function_tolerance_reached(
                    ri2, prev_rec_cost, options
                )
                if reached:
                    terminated = True
                    summary.termination_type = CONVERGENCE
                    summary.message = msg
                break  # leave inner loop
            else:
                reason = "Reject" if it_summary.step_is_valid else "Invalid"
                log(
                    f"\t[{reason}] error: {ri2.all.error:.4e}, "
                    f"lambda: {lam:.1e}, it_time: "
                    f"{timer_iteration.elapsed():.3f}s, total_time: "
                    f"{timer_total.elapsed():.3f}s"
                )
                lam = lambda_vee * lam
                lambda_vee *= options.vee_factor

                it_summary.trust_region_radius = 1.0 / lam
                it_summary.iteration_time_in_seconds = (
                    timer_iteration.elapsed()
                )
                it_summary.cumulative_time_in_seconds = timer_total.elapsed()
                it_summary.step_is_successful = False
                finish_iteration(summary, it_summary)
                reject()
                it += 1
                if lam > max_lambda:
                    terminated = True
                    summary.termination_type = NO_CONVERGENCE
                    summary.message = (
                        "Solver did not converge and reached maximum "
                        f"damping lambda of {max_lambda}"
                    )

    if not terminated:
        summary.termination_type = NO_CONVERGENCE
        summary.message = (
            "Solver did not converge after maximum number of "
            f"{max_lm_iter} iterations"
        )


# summary names of the step-1 solvers (povar_tpu/solver/lm.py:423)
_SOLVER_TYPE_NAMES = {
    SolverType.PCG: "bal_pcg",
    SolverType.POWER_SCHUR_COMPLEMENT: "bal_power_sc",
    SolverType.POWER_VARPROJ: "power_variable_projection",
    SolverType.CHOLESKY: "variable_projection",
}


class _State:
    """Mutable {current, trial} state pair replacing the reference's
    in-place update + backup/restore (bal_problem.cpp:647-708)."""

    def __init__(self, cams, lms):
        self.cams = cams
        self.lms = lms
        self.trial = None  # (cams, lms)

    def stage(self, cams, lms):
        self.trial = (cams, lms)

    # the reference applies the step to the problem in place, evaluates
    # the cost, and restores on reject; "current" is therefore the trial
    # state while one is staged
    @property
    def cur_cams(self):
        return self.trial[0] if self.trial is not None else self.cams

    @property
    def cur_lms(self):
        return self.trial[1] if self.trial is not None else self.lms

    def accept(self):
        self.cams, self.lms = self.trial
        self.trial = None

    def reject(self):
        self.trial = None


_ERR_KEYS = (
    "num_obs_all", "error_all", "residual_sum_all",
    "num_obs_valid", "error_valid", "residual_sum_valid",
    "is_numerically_valid",
)


def _trial_step(solver, state: _State, lin_box: dict):
    """The loop's trial callback: the solver's fused solve+apply+cost,
    then ONE batched host transfer of the decision scalars and cost
    buckets. The new state is staged only when the increment is finite
    (a NaN trial is discarded)."""

    def trial_step(lam):
        new_cams, new_lms, ok, iters, l_diff, err = solver.trial(
            state.cams, state.lms, lin_box["lin"], lam
        )
        vals = to_host(ok, l_diff, *(err[k] for k in _ERR_KEYS))
        ok, l_diff = bool(vals[0]), vals[1]
        ri2 = ResidualInfo.from_values(*vals[2:])
        if ok:
            state.stage(new_cams, new_lms)
        return ok, int(iters), float(l_diff), ri2

    return trial_step


def _staged_steps(solver, state: _State, lin_box: dict):
    """The staged trial's callbacks under `detailed_timing` (solve_with_lam
    / apply_step of the JAX package's optimize_step1 / optimize_step2):
    the solve, whose increment's finiteness is read on the host, and the
    apply, which stages the trial state and reads l_diff; each returns
    its spans."""

    def solve(lam):
        lin_box["lam"] = lam
        inc, iters, t = solver.solve_timed(lin_box["lin"], lam)
        lin_box["inc"] = inc
        return bool(torch.isfinite(inc).all()), int(iters), t

    def apply_step():
        new_cams, new_lms, l_diff, t = solver.apply_timed(
            state.cams, state.lms, lin_box["lin"], lin_box.pop("inc"),
            lin_box["lam"])
        state.stage(new_cams, new_lms)
        return float(l_diff), t

    return solve, apply_step


def _run(solver, state: _State, options: SolverOptions, accept_rule: str,
         max_lm_iter: int, summary: SolverSummary, timer_total: Timer,
         log: Callable[[str], None], initialize=None) -> None:
    lin_box = {}
    detailed = options.detailed_timing

    def compute_error():
        return ResidualInfo.from_device(
            solver.compute_error(state.cur_cams, state.cur_lms)
        )

    def linearize():
        if detailed:
            lin_box["lin"], t = solver.linearize_timed(state.cams, state.lms)
            return t
        lin_box["lin"] = solver.linearize(state.cams, state.lms)
        return None

    if detailed:
        solve, apply_step = _staged_steps(solver, state, lin_box)
        steps = dict(solve=solve, apply_step=apply_step)
    else:
        steps = dict(trial=_trial_step(solver, state, lin_box))
    _optimize_lm_loop(
        options=options,
        max_lm_iter=max_lm_iter,
        compute_error=compute_error,
        linearize=linearize,
        accept=state.accept,
        reject=state.reject,
        summary=summary,
        timer_total=timer_total,
        log=log,
        accept_rule=accept_rule,
        initialize=initialize,
        **steps,
    )


def _run_device_loop(solver, state: _State, options: SolverOptions,
                     accept_rule: str, max_lm_iter: int,
                     summary: SolverSummary, timer_total: Timer,
                     log: Callable[[str], None]) -> None:
    """The device loop from `state`: the initial cost stays on the device
    and is fetched with the traces. The loop (on the card, its captured
    graph) is kept on the solver (`device_runs`) for the next call with
    the same accept rule, iteration limit, loop options and kernel
    wrappers; a call with others replaces it."""
    err0 = solver.compute_error(state.cams, state.lms)
    key = (accept_rule, max_lm_iter, options.device_loop_cache_token(),
           wrapper_token())
    runs = solver.device_runs
    if key not in runs:
        # one loop a solver: another's graph and pool go first
        runs.clear()
        runs[key] = DeviceLmRun(solver, options, accept_rule, max_lm_iter)
    drive_device_loop(runs[key], state, options, max_lm_iter, summary,
                      timer_total, log, err0)


def optimize_step1(
    solver: Stage1Solver,
    cam_space: torch.Tensor,
    lm_p: torch.Tensor,
    options: SolverOptions,
    summary: SolverSummary,
    timer_total: Timer,
    log: Callable[[str], None] = print,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step 1: pOSE VarProj LM (optimize_lm_ours_pOSE, cpp:252-542) with
    the solver's trial (POWER_VARPROJ, POWER_SCHUR_COMPLEMENT, PCG or
    CHOLESKY, whose staging in the JAX package only marks its jit
    boundaries), or under `detailed_timing` its staged, timed trial.
    Returns the optimized (cam_space [N, 3, 4], lm_p [M, 3])."""
    state = _State(cam_space, lm_p)

    def initialize():
        # thread the landmark state through the loop in L space
        # (slots.LmState)
        state.lms = solver.lm_pack(solver.initialize_varproj(state.cams))

    if use_device_loop(options, solver, options.detailed_timing):
        initialize()
        _run_device_loop(solver, state, options, "step1",
                         options.max_num_iterations_step_1, summary,
                         timer_total, log)
    else:
        _run(solver, state, options, "step1",
             options.max_num_iterations_step_1, summary, timer_total, log,
             initialize=initialize)
    summary.minimizer_time_in_seconds = timer_total.elapsed()
    finish_solve(summary, _SOLVER_TYPE_NAMES[options.solver_type_step_1])
    return state.cams, solver.lm_unpack(state.lms)


def optimize_step2(
    solver: Stage2Solver,
    cam_space: torch.Tensor,
    lm_p_h: torch.Tensor,
    options: SolverOptions,
    summary: SolverSummary,
    timer_total: Timer,
    log: Callable[[str], None] = print,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step 2: Riemannian joint refinement (optimize_homogeneous_joint,
    cpp:557-843) with the solver's trial (RIPOBA or RIPCG), or under
    `detailed_timing` its staged, timed trial. Returns the optimized
    (cam_space [N, 3, 4], lm_p_h [M, 4])."""
    state = _State(cam_space, solver.lm_pack(lm_p_h))
    if use_device_loop(options, solver, options.detailed_timing):
        _run_device_loop(solver, state, options, "step2",
                         options.max_num_iterations_step_2, summary,
                         timer_total, log)
    else:
        _run(solver, state, options, "step2",
             options.max_num_iterations_step_2, summary, timer_total, log)
    summary.minimizer_time_in_seconds = timer_total.elapsed()
    summary.total_time_in_seconds = timer_total.elapsed()
    finish_solve(
        summary, "riemannian_" + options.solver_type_step_2.value.lower()
    )
    return state.cams, solver.lm_unpack(state.lms)

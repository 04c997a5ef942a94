"""The device LM loop of povar_tpu_torch (solver/device_loop.py) against
the port's host loop and against povar_tpu's device loop, on the CPU.

On the CPU the loop runs eagerly (device_loop.EagerControl) through the
same body as on the card, with the bookkeeping kernel's plain version
(ops/lm_kernels.lm_step_ref) and the device forms of the inner solves
(solver/pcg.py). Inputs come from one seed through numpy.

  - Port device loop ("on") against port host loop ("off") in pure f64
    (`mixed_precision_solves=False`, the unstructured f64 layout), in
    the shape of tests/test_device_loop.py: step 1 POWER_VARPROJ,
    POWER_SCHUR_COMPLEMENT and PCG on synthetic_bal_problem(8, 60, 5,
    seed=7), step 2 RIPOBA and RIPCG from `ring_case`
    (tools/step2_spread.py). Decisions, validity and inner counts
    identical; accepted costs, radii and relative decreases within
    LOOPS_RTOL = 1e-12 relative. Measured: equal bit for bit (the two
    loops run the same operations in the same order on the CPU), so
    the final states are compared exactly too.
  - Port device loop against the JAX package's (`device_lm_loop="on"`),
    pure f64, four JAX configurations built once each (step 1
    POWER_VARPROJ and PCG, step 2 RIPOBA and RIPCG): decisions and
    counts identical, costs and radii within the f64 parity tolerances
    of tests/test_torch_f64_steps.py (1e-10, 1e-9).
  - Each termination: the function tolerance (a loose ftol, as JAX's
    test), the max-lambda ceiling (step 2 with a high
    min_relative_decrease and a low ceiling), the iteration limit.
  - A NaN-increment trial (a solver whose increment is NaN below a
    lambda threshold): the same [Invalid] records and lambda steps.
  - The replayed log lines equal the host loop's up to `it_time`.
  - The f32 state and `pallas_kernels="off"` (mixed precision) against
    the host loop: identical decisions, counts and costs.
  - Eligibility: CHOLESKY, `detailed_timing` and a mesh take the host
    loop under "auto" and raise ValueError under "on".
  - The bookkeeping kernel's plain version against the JAX body's
    arithmetic (povar_tpu/solver/device_loop.py:243-292, its damping
    factor through `lm_damping_factor`) on edge cases: l_diff = 0
    (quality inf), lambda at its floor, the ftol test, the max-lambda
    test, a NaN increment.
  - The CLI's --solver-device-lm-loop: "on" and "auto" reach the device
    loop, "off" the host loop, and ba_log.json keeps its schema.
"""

import copy
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from povar_tpu.options import SolverOptions as JaxOptions
from povar_tpu.problem.synthetic import synthetic_bal_problem
from povar_tpu.solver.device_loop import lm_damping_factor
from povar_tpu.solver.lm import optimize_step1 as jax_optimize_step1
from povar_tpu.solver.lm import optimize_step2 as jax_optimize_step2
from povar_tpu.solver.stage1 import Stage1Solver as JaxStage1
from povar_tpu.solver.stage2 import Stage2Solver as JaxStage2
from povar_tpu.solver.stage2 import create_homogeneous as jax_create_homogeneous
from povar_tpu.utils.summary import SolverSummary as JaxSummary
from povar_tpu.utils.timer import Timer as JaxTimer
from povar_tpu_torch import (
    SolverOptions,
    SolverSummary,
    Stage1Solver,
    Stage2Solver,
    Timer,
    bundle_adjust,
    create_homogeneous,
    from_numpy,
    make_mesh,
    optimize_step1,
    optimize_step2,
)
from povar_tpu_torch.ops import launches, lm_kernels
from povar_tpu_torch.solver import lm as lm_mod
from povar_tpu_torch.solver.slots import use_device_loop
from povar_tpu_torch.tools.step2_spread import ring_case

ITERS = 8
LOOPS_RTOL = 1e-12
COST_RTOL, RADIUS_RTOL = 1e-10, 1e-9


def _options(cls, mode, **kw):
    """Pure f64 under `device_lm_loop=mode`, `kw` on top (solver types by
    name)."""
    opts = cls()
    opts.mixed_precision_solves = False
    opts.device_lm_loop = mode
    opts.max_num_iterations_step_1 = ITERS
    opts.max_num_iterations_step_2 = ITERS
    for k, v in kw.items():
        if isinstance(v, str) and k.startswith("solver_type"):
            v = type(getattr(opts, k))[v]  # an enum member, by name
        setattr(opts, k, v)
    return opts


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors go to the plain versions: no kernel launch counted."""
    launches.reset_launch_counts()
    yield
    assert not any(launches.launch_counts().values())


@pytest.fixture(scope="module")
def problem():
    return synthetic_bal_problem(n_cams=8, n_lms=60, obs_per_lm=5, seed=7)[0]


def _args(problem):
    return (problem.obs_cam, problem.obs_lm, problem.obs_uv,
            problem.num_cameras, problem.num_landmarks)


def _step1(problem, opts, cls=Stage1Solver, dtype=torch.float64):
    s = cls(*_args(problem), opts, dtype=dtype, device="cpu")
    summary, lines = SolverSummary(), []
    cams, lms = optimize_step1(
        s, torch.as_tensor(problem.cam_space, dtype=dtype),
        torch.as_tensor(problem.lm_p, dtype=dtype), opts, summary, Timer(),
        log=lines.append)
    return summary, cams, lms, lines, s


def _step2(opts, dtype=torch.float64):
    args, cam0, lm0 = ring_case()
    s = Stage2Solver(*args, opts, dtype=dtype, device="cpu")
    summary, lines = SolverSummary(), []
    cams, lms = optimize_step2(
        s, *create_homogeneous(torch.as_tensor(cam0, dtype=dtype),
                               torch.as_tensor(lm0, dtype=dtype)),
        opts, summary, Timer(), log=lines.append)
    return summary, cams, lms, lines, s


def _decisions(summary):
    return [(it.step_is_successful, it.step_is_valid,
             it.linear_solver_iterations, it.cost is None)
            for it in summary.iterations]


def _same_trajectory(a, b, cost_rtol, radius_rtol, rel_dec=True):
    """Decisions, validity and inner counts identical; accepted costs,
    every trust radius and (with `rel_dec`) every relative decrease
    within the tolerances; the same termination. Returns the largest
    relative gap of those values."""
    assert _decisions(a) == _decisions(b)
    gap = 0.0
    for ia, ib in zip(a.iterations, b.iterations):
        pairs = [(ia.trust_region_radius, ib.trust_region_radius,
                  radius_rtol)]
        if ia.step_is_successful:
            pairs += [(ia.cost.all.error, ib.cost.all.error, cost_rtol),
                      (ia.cost.valid.error, ib.cost.valid.error, cost_rtol)]
            if rel_dec:
                pairs.append((ia.relative_decrease, ib.relative_decrease,
                              cost_rtol))
        for x, y, tol in pairs:
            g = abs(x - y) / max(abs(y), 1e-300)
            assert g <= tol, (ia.iteration, x, y)
            gap = max(gap, g)
    assert a.termination_type == b.termination_type
    assert a.num_successful_steps == b.num_successful_steps
    assert a.num_unsuccessful_steps == b.num_unsuccessful_steps
    return gap


@pytest.mark.parametrize("solver", ["POWER_VARPROJ", "POWER_SCHUR_COMPLEMENT",
                                    "PCG"])
def test_step1_device_loop_matches_host_loop(problem, solver):
    """Pure f64 step 1, 15 iterations: the device loop walks the host
    loop's trajectory, equal bit for bit on the CPU."""
    runs = {}
    for mode in ("off", "on"):
        runs[mode] = _step1(problem, _options(
            SolverOptions, mode, solver_type_step_1=solver,
            max_num_iterations_step_1=15))
    off, on = runs["off"], runs["on"]
    assert _same_trajectory(off[0], on[0], LOOPS_RTOL, LOOPS_RTOL) == 0.0
    assert sum(it.step_is_successful for it in on[0].iterations[1:]) >= 5
    assert torch.equal(off[1], on[1]) and torch.equal(off[2], on[2])
    assert on[4].device_runs and not off[4].device_runs


@pytest.mark.parametrize("solver", ["RIPOBA", "RIPCG"])
def test_step2_device_loop_matches_host_loop(solver):
    """Pure f64 step 2 from one homogenized `ring_case` state: the
    device loop walks the host loop's trajectory, equal bit for bit."""
    runs = {mode: _step2(_options(SolverOptions, mode,
                                  solver_type_step_2=solver,
                                  max_num_iterations_step_2=12))
            for mode in ("off", "on")}
    off, on = runs["off"], runs["on"]
    assert _same_trajectory(off[0], on[0], LOOPS_RTOL, LOOPS_RTOL) == 0.0
    assert torch.equal(off[1], on[1]) and torch.equal(off[2], on[2])


@pytest.fixture(scope="module")
def jax_step1_runs(problem):
    """JAX's device loop, pure f64: step 1 with POWER_VARPROJ and PCG
    (two of the file's four JAX configurations)."""
    out = {}
    for solver in ("POWER_VARPROJ", "PCG"):
        jo = _options(JaxOptions, "on", solver_type_step_1=solver)
        js = JaxStage1(*_args(problem), jo)
        jsum = JaxSummary()
        jc, jl = jax_optimize_step1(
            js, jnp.asarray(problem.cam_space), jnp.asarray(problem.lm_p),
            jo, jsum, JaxTimer(), log=lambda s: None)
        out[solver] = (jsum, np.asarray(jc), np.asarray(jl))
    return out


@pytest.mark.parametrize("solver", ["POWER_VARPROJ", "PCG"])
def test_step1_device_loop_matches_jax(problem, jax_step1_runs, solver):
    """Pure f64 step 1, 8 iterations, both packages' device loops: the
    same decisions and counts, costs within 1e-10 and radii within 1e-9
    (f64 sums in another order), the final states within 1e-8."""
    jsum, jc, jl = jax_step1_runs[solver]
    tsum, tc, tl, _lines, _s = _step1(problem, _options(
        SolverOptions, "on", solver_type_step_1=solver))
    _same_trajectory(tsum, jsum, COST_RTOL, RADIUS_RTOL, rel_dec=False)
    assert tsum.solver_type == jsum.solver_type
    np.testing.assert_allclose(tc.numpy(), jc, rtol=0, atol=1e-8)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=1e-8)


@pytest.mark.parametrize("solver", ["RIPOBA", "RIPCG"])
def test_step2_device_loop_matches_jax(solver):
    """Pure f64 step 2 from one homogenized `ring_case` state, both
    packages' device loops (the file's other two JAX configurations):
    the same decisions and counts, costs within 1e-10, radii within
    1e-9, the final states within 1e-8."""
    args, cam0, lm0 = ring_case()
    jo = _options(JaxOptions, "on", solver_type_step_2=solver)
    jsum = JaxSummary()
    jc, jl = jax_optimize_step2(
        JaxStage2(*args, jo), *jax_create_homogeneous(
            jnp.asarray(cam0), jnp.asarray(lm0)),
        jo, jsum, JaxTimer(), log=lambda s: None)
    tsum, tc, tl, _lines, _s = _step2(_options(SolverOptions, "on",
                                               solver_type_step_2=solver))
    _same_trajectory(tsum, jsum, COST_RTOL, RADIUS_RTOL, rel_dec=False)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-8)


def test_ftol_termination(problem):
    """A loose function tolerance (1e-2, as tests/test_device_loop.py):
    both loops stop at the same iteration on CONVERGENCE."""
    runs = {}
    for mode in ("off", "on"):
        opts = _options(SolverOptions, mode, max_num_iterations_step_1=60)
        opts.function_tolerance = 1e-2
        runs[mode] = _step1(problem, opts)[0]
    _same_trajectory(runs["off"], runs["on"], LOOPS_RTOL, LOOPS_RTOL)
    assert runs["on"].termination_type == "CONVERGENCE"
    assert len(runs["on"].iterations) < 61
    assert runs["on"].message.startswith("Function tolerance reached")


def test_max_lambda_termination():
    """Step 2 accepting only steps of quality above 0.9999, with lambda
    capped at 1e2 (min_trust_region_radius 1e-2): rejections double
    lambda's factor until it passes the cap, and both loops stop there
    on the same record with the same message."""
    runs = {}
    for mode in ("off", "on"):
        opts = _options(SolverOptions, mode, max_num_iterations_step_2=40)
        opts.min_relative_decrease = 0.9999
        opts.min_trust_region_radius = 1e-2
        runs[mode] = _step2(opts)[0]
    off, on = runs["off"], runs["on"]
    _same_trajectory(off, on, LOOPS_RTOL, LOOPS_RTOL)
    assert on.termination_type == "NO_CONVERGENCE"
    assert on.message == off.message
    assert "maximum damping lambda of 100.0" in on.message
    assert len(on.iterations) < 41
    assert not on.iterations[-1].step_is_successful


def test_max_iterations_termination(problem):
    """The iteration limit: exactly max_num_iterations_step_1 trials,
    the same message in both loops."""
    runs = {mode: _step1(problem, _options(SolverOptions, mode))[0]
            for mode in ("off", "on")}
    assert len(runs["on"].iterations) == ITERS + 1
    assert runs["on"].message == runs["off"].message == (
        f"Solver did not converge after maximum number of {ITERS} "
        "iterations")


class _NanBelow(Stage1Solver):
    """A step-1 solver whose increment is NaN where the trial's lambda
    lies below NAN_BELOW (a Python float under the host loop, a 0-d
    tensor under the device loop): the first trial (lambda 1e-4) and any
    later one whose lambda falls back under it."""

    NAN_BELOW = 1.5e-4

    def solve(self, lin, lam, ctl=None):
        inc, n = super().solve(lin, lam, ctl)
        bad = torch.as_tensor(lam, dtype=torch.float64) < self.NAN_BELOW
        return inc * torch.where(bad, math.nan, 1.0).to(inc.dtype), n


def test_nan_increment_trial(problem):
    """A NaN increment is an invalid trial with no cost: the same
    records, [Invalid] log lines and lambda steps in both loops."""
    runs = {mode: _step1(problem, _options(SolverOptions, mode),
                         cls=_NanBelow) for mode in ("off", "on")}
    off, on = runs["off"], runs["on"]
    _same_trajectory(off[0], on[0], LOOPS_RTOL, LOOPS_RTOL)
    first = on[0].iterations[1]
    assert first.cost is None and not first.step_is_valid
    assert first.trust_region_radius == 1.0 / (2.0 * 1e-4)
    nan_lines = [ln for ln in on[3] if "contains NaNs" in ln]
    assert nan_lines and nan_lines == [ln for ln in off[3]
                                       if "contains NaNs" in ln]
    assert any(it.step_is_successful for it in on[0].iterations[2:])


def _strip(lines):
    return [ln.split(", it_time:")[0] for ln in lines]


def test_log_replay_matches_host_lines(problem):
    """The device loop's replayed log lines carry the host loop's
    content, line for line, up to the per-iteration wall times."""
    logs = {mode: _strip(_step1(problem, _options(
        SolverOptions, mode, solver_type_step_1="POWER_SCHUR_COMPLEMENT",
        max_num_iterations_step_1=12))[3]) for mode in ("off", "on")}
    assert logs["off"] == logs["on"]
    assert any("[Reject]" in ln for ln in logs["on"])
    assert any("backtracking" in ln for ln in logs["on"])


@pytest.mark.parametrize("config", ["f32_state", "unstructured"])
def test_mixed_precision_configurations(problem, config):
    """Mixed precision (f32 inner solves): the f32 LM state (structured
    layout, defaults) and pallas_kernels="off" (the unstructured
    layout), each step against the host loop: identical decisions,
    counts and costs (the same f32 operations in the same order on the
    CPU)."""
    kw = dict(mixed_precision_solves=True)
    dtype = torch.float64
    if config == "f32_state":
        dtype = torch.float32
    else:
        kw["pallas_kernels"] = "off"
    one = {m: _step1(problem, _options(SolverOptions, m, **kw), dtype=dtype)
           for m in ("off", "on")}
    _same_trajectory(one["off"][0], one["on"][0], LOOPS_RTOL, LOOPS_RTOL)
    two = {m: _step2(_options(SolverOptions, m, **kw), dtype=dtype)
           for m in ("off", "on")}
    _same_trajectory(two["off"][0], two["on"][0], LOOPS_RTOL, LOOPS_RTOL)
    assert two["on"][1].dtype == dtype


def _ran_device_loop(monkeypatch):
    """Record whether optimize_step1 / optimize_step2 took the device
    loop."""
    seen = []
    real = lm_mod._run_device_loop

    def spy(*a, **k):
        seen.append(a[3])
        return real(*a, **k)

    monkeypatch.setattr(lm_mod, "_run_device_loop", spy)
    return seen


def test_eligibility_cholesky_and_detailed_timing(problem, monkeypatch):
    """CHOLESKY has no fused trial in the JAX package: "auto" runs its
    host loop, "on" raises the JAX ValueError. `detailed_timing` (not
    ported: its solver raises NotImplementedError, ROADMAP item 14) is
    refused by the rule the same way. POWER_VARPROJ under "auto" takes
    the device loop."""
    seen = _ran_device_loop(monkeypatch)
    _step1(problem, _options(SolverOptions, "auto",
                             solver_type_step_1="CHOLESKY"))
    assert seen == []
    with pytest.raises(ValueError, match="requires the fused trial"):
        _step1(problem, _options(SolverOptions, "on",
                                 solver_type_step_1="CHOLESKY"))
    s = Stage1Solver(*_args(problem), _options(SolverOptions, "auto"),
                     device="cpu")
    for mode, want in (("auto", False), ("off", False)):
        assert use_device_loop(_options(SolverOptions, mode), s, True) is want
    with pytest.raises(ValueError, match="detailed_timing=False"):
        use_device_loop(_options(SolverOptions, "on"), s, True)
    assert use_device_loop(_options(SolverOptions, "auto"), s, False)
    _step1(problem, _options(SolverOptions, "auto"))
    assert seen == ["step1"]


def test_eligibility_mesh(problem, monkeypatch):
    """On a mesh (the SPMD solvers, mixed precision) "auto" takes the
    host loop in both steps and "on" raises ValueError, as in the JAX
    package."""
    seen = _ran_device_loop(monkeypatch)
    opts = SolverOptions(max_num_iterations_step_1=2,
                         max_num_iterations_step_2=2)
    p, _c, _l = from_numpy(*_args(problem)[:3], problem.cam_space,
                           problem.lm_p, device="cpu")
    _, s1, s2 = bundle_adjust(copy.deepcopy(p), opts, log=lambda s: None,
                              device="cpu", mesh=make_mesh(1, "cpu"))
    assert seen == [] and len(s1.iterations) == 3
    opts.device_lm_loop = "on"
    with pytest.raises(ValueError, match="device_lm_loop='on'"):
        bundle_adjust(copy.deepcopy(p), opts, log=lambda s: None,
                      device="cpu", mesh=make_mesh(1, "cpu"))
    bundle_adjust(copy.deepcopy(p), opts, log=lambda s: None, device="cpu")
    assert seen == ["step1", "step2"]


def _jax_body(trial, st, p):
    """The JAX while-body's arithmetic after the trial
    (povar_tpu/solver/device_loop.py:243-292) on one lm_step input:
    (accept, valid, lam2, vee2, term, relin) as numpy."""
    f2, n2 = jnp.asarray(trial[:4]), jnp.asarray(trial[4:6])
    cur_f, cur_n = jnp.asarray(st[4:8]), jnp.asarray(st[8:10])
    prev_f = jnp.asarray(st[10:14])
    ok, nv = bool(trial[6]), bool(trial[7])
    l_diff = jnp.float64(trial[8])
    lam, vee, it = jnp.float64(st[2]), jnp.float64(st[3]), int(st[0])

    def channel(f, n):
        if p.oc == 0:
            return f[0]
        if p.oc == 1:
            return f[2]
        return f[2] / jnp.maximum(n[1], 1).astype(jnp.float64)

    f_diff = channel(cur_f, cur_n) - channel(f2, n2)
    l_eff = (l_diff / jnp.maximum(cur_n[1], 1).astype(jnp.float64)
             if p.oc == 2 else l_diff)
    quality = jnp.where(l_eff != 0.0, f_diff / l_eff, jnp.float64(math.inf))
    if p.step1:
        valid = ok & nv
        accept = valid & (f_diff > 0)
    else:
        valid = ok & nv & (l_eff > 0)
        accept = valid & (quality > p.min_rel_dec)
    lam_acc = jnp.maximum(jnp.float64(p.min_lambda),
                          lam * lm_damping_factor(quality))
    lam2 = jnp.where(accept, lam_acc, vee * lam)
    vee2 = jnp.where(accept, jnp.float64(p.initial_vee), vee * p.vee_factor)
    c_new = f2[0] if p.oc == 0 else f2[2]
    change = jnp.abs((prev_f[0] if p.oc == 0 else prev_f[2]) - c_new)
    ftol = accept & (change <= p.ftol * c_new)
    overflow = (~accept) & (lam2 > p.max_lambda)
    term = jnp.where(ftol, 1, jnp.where(overflow, 2, 0))
    relin = accept & (term == 0) & (it < p.T)
    return tuple(np.asarray(v) for v in (accept, valid, lam2, vee2, term,
                                         relin))


# (trial row, state vector) edge cases: a plain accept, a reject (l_diff
# < 0 in step 2, a cost rise in step 1), l_diff = 0 (quality inf),
# lambda at its floor, the ftol test met, a rejection past the
# max-lambda ceiling, a NaN increment, the last iteration
_ROW = [10.0, 3.0, 9.0, 2.5, 100.0, 90.0]
_ST = [1.0, 0.0, 1e-4, 2.0, 12.0, 4.0, 11.0, 3.0, 100.0, 90.0,
       12.0, 4.0, 11.0, 3.0, 100.0, 90.0]
_EDGE = {
    "accept": ([], [1, 1, 2.5, 4], {}),
    "reject": ([(0, 13.0), (2, 12.0)], [1, 1, -2.5, 4], {}),
    "l_diff_zero": ([], [1, 1, 0.0, 3], {}),
    "lam_floor": ([], [1, 1, 2.5, 1], {2: 1e-16}),
    "ftol": ([], [1, 1, 2.5, 1], {10: 10.0 + 1e-9, 12: 9.0 + 1e-9}),
    "max_lambda": ([(0, 13.0), (2, 12.0)], [1, 1, -2.5, 1],
                   {2: 1e31, 3: 64.0}),
    "nan_increment": ([], [0, 1, 2.5, 5], {}),
    "last_iteration": ([], [1, 1, 2.5, 1], {0: 5.0}),
}


@pytest.mark.parametrize("case", list(_EDGE))
@pytest.mark.parametrize("oc, step1", [(0, 1), (1, 0), (2, 1), (2, 0)])
def test_lm_step_plain_version_matches_jax_body(case, oc, step1):
    """lm_step's plain version against the JAX body's arithmetic: the
    same accept, validity, termination and relinearization; lambda and
    vee equal to the last bit but where JAX's FMA-contracted damping
    factor rounds once fewer (within 4 ulp); the trace row records what
    the decision saw (radius 1 / lambda, the cost row, inner count)."""
    p = lm_kernels.LmParams(min_lambda=1e-16, max_lambda=1e32, ftol=1e-6,
                            min_rel_dec=0.0, vee_factor=2.0,
                            initial_vee=2.0, T=5, oc=oc, step1=step1)
    edits, tail, head = _EDGE[case]
    row = list(_ROW)
    for k, v in edits:
        row[k] = v
    st = list(_ST)
    for k, v in head.items():
        st[k] = v
    trial = torch.tensor(row + tail, dtype=torch.float64)
    s = torch.tensor(st, dtype=torch.float64)
    trace = torch.zeros((p.T, len(lm_kernels.TRACE_COLS)),
                        dtype=torch.float64)
    flags = torch.zeros(3, dtype=torch.bool)
    lm_kernels.lm_step(trial, s, trace, flags, p)
    accept, valid, lam2, vee2, term, relin = _jax_body(
        trial.numpy(), np.asarray(st), p)
    col = {c: j for j, c in enumerate(lm_kernels.TRACE_COLS)}
    k = int(st[0]) - 1
    assert bool(flags[0]) == bool(accept)
    assert bool(flags[1]) == bool(relin)
    assert bool(trace[k, col["valid"]]) == bool(valid)
    assert int(s[1]) == int(term)
    np.testing.assert_allclose(float(s[2]), float(lam2), rtol=4e-16)
    np.testing.assert_allclose(float(s[3]), float(vee2), rtol=0)
    assert float(trace[k, col["radius"]]) == 1.0 / float(s[2])
    assert trace[k, :6].tolist() == row[:6]
    assert float(trace[k, col["lin_iters"]]) == tail[3]
    assert bool(flags[2]) == (term == 0 and st[0] + 1 <= p.T)
    if case == "l_diff_zero" and accept:
        assert math.isinf(float(trace[k, col["rel_dec"]]))
    if case == "nan_increment":
        assert not flags[0] and s[10:16].abs().sum() == 0


def test_cli_flag_reaches_the_device_loop(tmp_path, monkeypatch):
    """The CLI's --solver-device-lm-loop: "on" and "auto" (the default)
    take the device loop in both steps, "off" the host loop, on the
    committed BAL fixture with --device cpu; ba_log.json keeps one
    schema, and the logs' decisions and counts agree."""
    import json
    import shutil

    from povar_tpu_torch import cli

    fixture = "mini-bal-12-48-pre.txt"
    here = __file__.rsplit("/", 1)[0]
    seen = _ran_device_loop(monkeypatch)
    logs = {}
    for mode in ("off", "on", "auto"):
        work = tmp_path / mode
        work.mkdir()
        shutil.copy(f"{here}/data/{fixture}", work / fixture)
        monkeypatch.chdir(work)
        with pytest.raises(SystemExit):
            cli.main(["--input", fixture, "--create-dataset"])
        del seen[:]
        argv = ["--input", f"data_custom/{fixture}", "--device", "cpu",
                "--solver-max-num-iterations-step-2", "7"]
        if mode != "auto":
            argv += ["--solver-device-lm-loop", mode]
        assert cli.main(argv) == 0
        assert seen == ([] if mode == "off" else ["step1", "step2"])
        logs[mode] = json.loads((work / "ba_log.json").read_text())

    def keys(d, prefix=""):
        out = set()
        for k, v in d.items():
            out.add(prefix + k)
            if isinstance(v, dict):
                out |= keys(v, prefix + k + ".")
            elif isinstance(v, list) and v and isinstance(v[0], dict):
                out |= keys(v[0], prefix + k + "[].")
        return out

    for mode in ("on", "auto"):
        assert keys(logs[mode]) == keys(logs["off"])
        for step in ("iterations1", "iterations"):
            assert [(it["step_is_successful"],
                     it["linear_solver_iterations"])
                    for it in logs[mode][step]] == [
                (it["step_is_successful"], it["linear_solver_iterations"])
                for it in logs["off"][step]]

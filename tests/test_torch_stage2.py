"""Step 2 and `bundle_adjust` of povar_tpu_torch against povar_tpu: the
modules of the step-2 solve one by one, the step-2 LM trajectory, and
the two-step pipeline as a whole.

JAX side: Stage2Solver with pallas_kernels="on" (the Pallas kernels in
interpret mode) and device_lm_loop="off"; the module tests run the
composed power term (fused_power_term=False), the solve, trajectory and
pipeline tests also SolverOptions() defaults (the fused term) and the CG
solvers (RIPCG; PCG in step 1). Port side: the same options on the CPU
(device="cpu"), where every kernel call runs its plain PyTorch version.

The module and trajectory tests run on tests/test_pallas_pose2.py's
consistent near-optimum geometry (12 ring cameras, 80 landmarks, 4
observations each, 1e-3 measurement noise, cameras and landmarks
perturbed by 1e-2): from random states the projective division is
chaotic and any f32 reordering changes the trajectory. Both packages
evaluate the linearization and the inner solve in f32 with sums in
different orders, so module outputs agree to f32 rounding amplified by
the problem's conditioning; tolerances are relative to the largest
magnitude of each output, stated per test with the gap measured here.

Most of this file's time is the JAX package's Pallas interpret runs;
the three pipeline tests take about 20 s each.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from povar_tpu.ops import linalg as jax_linalg
from povar_tpu.options import SolverOptions as JaxOptions
from povar_tpu.problem.synthetic import synthetic_bal_problem
from povar_tpu.solver.lm import optimize_step2 as jax_optimize_step2
from povar_tpu.solver.pipeline import bundle_adjust as jax_bundle_adjust
from povar_tpu.solver.stage2 import Stage2Solver as JaxStage2
from povar_tpu.solver.stage2 import create_homogeneous as jax_create_homogeneous
from povar_tpu.utils.summary import SolverSummary as JaxSummary
from povar_tpu.utils.timer import Timer as JaxTimer
from povar_tpu_torch import (
    SolverOptions,
    SolverSummary,
    Stage2Solver,
    Timer,
    bundle_adjust,
    create_homogeneous,
    from_numpy,
    optimize_step2,
)
from povar_tpu_torch.ops import launches
from povar_tpu_torch.ops import linalg
from povar_tpu_torch.parallel import spmd as tspmd
from povar_tpu_torch.solver.slots import LmState
from povar_tpu_torch.solver.stage2 import Lin2S
from povar_tpu_torch.tools.step2_spread import ring_case

# one torch thread a test process: the CPU tests' tensors are small,
# and a parallel run's xdist workers share the host's cores
torch.set_num_threads(1)

ITERS = 8


# the configurations of the solve, trajectory and pipeline tests: the
# composed power term, SolverOptions() defaults (the fused term) and the
# CG solvers (RIPCG with SCHUR_JACOBI; PCG in step 1)
CONFIGS = {
    "composed": dict(fused_power_term=False),
    "defaults": {},
    "cg": dict(solver_type_step_1="PCG", solver_type_step_2="RIPCG"),
}


def _slice_options(cls, config="composed", **kw):
    opts = cls()
    opts.device_lm_loop = "off"
    opts.max_num_iterations_step_2 = ITERS
    for k, v in {**CONFIGS[config], **kw}.items():
        if isinstance(v, str) and k.startswith("solver_type"):
            v = type(getattr(opts, k))[v]  # an enum member, by name
        setattr(opts, k, v)
    return opts


def _solver_pair(args, config):
    """(JAX Stage2Solver with the Pallas kernels on, port Stage2Solver on
    the CPU) under CONFIGS[config]."""
    js = JaxStage2(*args, _slice_options(JaxOptions, config,
                                         pallas_kernels="on"))
    assert js.use_pallas
    assert (js._e0_meta is None) == (config == "composed")
    ts = Stage2Solver(*args, _slice_options(SolverOptions, config),
                      device="cpu")
    assert (ts.e0_plan is None) == (config == "composed")
    return js, ts


@pytest.fixture(scope="module")
def geometry():
    """tests/test_pallas_pose2.py:141-160: a consistent geometry near its
    optimum (numpy; `ring_case` of tools/step2_spread.py)."""
    return ring_case()


@pytest.fixture(scope="module")
def solvers(geometry):
    args, cam0, lm0 = geometry
    js, ts = _solver_pair(args, "composed")
    jcams, jlms = jax_create_homogeneous(jnp.asarray(cam0), jnp.asarray(lm0))
    tcams, tlms = create_homogeneous(torch.as_tensor(cam0),
                                     torch.as_tensor(lm0))
    return js, ts, (jcams, jlms), (tcams, tlms)


@pytest.fixture(scope="module")
def lin_point(solvers):
    """JAX's linearization at the initial state, and the same arrays as
    torch tensors: the solve and apply tests feed both packages the same
    inputs."""
    js, _ts, (jcams, jlms), _t = solvers
    jlin = js.linearize(jcams, js.lm_pack(jlms))
    tlin = Lin2S(*[torch.as_tensor(np.array(v)) for v in jlin])
    return jlin, tlin


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("shape", [(12, 9), (4, 33)], ids=["cams", "lms"])
def test_nullspace_of_rowf(shape):
    """The exact Householder basis, not merely the same subspace:
    measured gap 1.2e-7 (cameras) and 0 (landmarks), the same f32
    operations up to the order of one sum."""
    v = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    v[0, :3] = [0.0, -1e-3, 2.0]  # both signs of v0, and v0 = 0
    want = np.asarray(jax_linalg.nullspace_of_rowf(jnp.asarray(v)))
    got = linalg.nullspace_of_rowf(torch.as_tensor(v))
    assert got.dtype == torch.float32
    _close(got.numpy(), want, 1e-6)
    # orthonormal columns orthogonal to v
    n = shape[0]
    g = got.numpy().astype(np.float64)
    np.testing.assert_allclose(np.einsum("ijk,ik->jk", g, v), 0, atol=1e-5)
    np.testing.assert_allclose(
        np.einsum("ijk,ilk->jlk", g, g),
        np.broadcast_to(np.eye(n - 1)[:, :, None], (n - 1, n - 1, shape[1])),
        atol=1e-5,
    )


def test_frobenius_normalize_and_create_homogeneous(geometry):
    _args, cam0, lm0 = geometry
    want = np.asarray(jax_linalg.frobenius_normalize(jnp.asarray(cam0)))
    got = linalg.frobenius_normalize(torch.as_tensor(cam0))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-15)
    jc, jl = jax_create_homogeneous(jnp.asarray(cam0), jnp.asarray(lm0))
    tc, tl = create_homogeneous(torch.as_tensor(cam0), torch.as_tensor(lm0))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-15)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_linearize(solvers):
    """Every Lin2S field, each package linearizing the same f64 state.
    Per-observation fields and the bases: 1e-5 (measured <= 1.6e-6, r_w);
    slot and per-camera sums (hll_raw, bl_raw, jl_scale, pose_scale, kps):
    1e-4 (measured <= 1.9e-6, bl_raw)."""
    js, ts, (jcams, jlms), (tcams, tlms) = solvers
    jlin = js.linearize(jcams, js.lm_pack(jlms))
    tlin = ts.linearize(tcams, ts.lm_pack(tlms))
    sums = {"hll_raw", "bl_raw", "jl_scale", "pose_scale", "kps"}
    for f in Lin2S._fields:
        got = getattr(tlin, f)
        assert got.dtype == torch.float32, f
        _close(got.numpy(), getattr(jlin, f), 1e-4 if f in sums else 1e-5)


@pytest.fixture(scope="module")
def fused_solvers(geometry):
    return _solver_pair(geometry[0], "defaults")


@pytest.mark.parametrize("term", ["composed", "fused"])
@pytest.mark.parametrize("lam", [1e-4, 1e2])
def test_solve_power(solvers, fused_solvers, lin_point, lam, term):
    """One RIPOBA solve from the same linearization, with the composed and
    with the fused power term in both packages: the same number of power
    terms, the increment within 1e-4 (measured 1.8e-5 at 1e-4, 1.1e-7 at
    1e2: f32 rounding in another summation order, amplified by the
    reduced camera system's conditioning)."""
    js, ts = solvers[:2] if term == "composed" else fused_solvers
    jlin, tlin = lin_point
    jinc, jn = js.solve_power(jlin, jnp.asarray(lam))
    tinc, tn = ts.solve_power(tlin, lam)
    assert tn == int(jn)
    assert tinc.dtype == torch.float64 and tuple(tinc.shape) == (11, 12)
    _close(tinc.numpy(), jinc, 1e-4)


def test_apply_and_compute_error(solvers, lin_point):
    """The apply (back-substitution, l_diff, camera lift and retraction)
    of one increment, and the f64 cost of the result: cameras within
    1e-8 (measured 3.5e-10: the f32 lift sums in another order),
    landmarks 1e-6 (measured 4.2e-9), l_diff 1e-4 (measured 5.4e-8), and
    the cost of the SAME state to 1e-12 against the JAX double-float
    kernel (measured 9.4e-14)."""
    js, ts, (jcams, jlms), (tcams, tlms) = solvers
    jlin, tlin = lin_point
    lam = 1e-4
    jinc, _ = js.solve_power(jlin, jnp.asarray(lam))
    jnc, jnl, jld = js.apply(jcams, js.lm_pack(jlms), jlin, jinc,
                             jnp.asarray(lam))
    tnc, tnl, tld = ts.apply(tcams, ts.lm_pack(tlms), tlin,
                             torch.as_tensor(np.array(jinc)), lam)
    _close(tnc.numpy(), jnc, 1e-8)
    assert isinstance(tnl, LmState) and tnl.rows.dtype == torch.float64
    _close(tnl.rows.numpy(), jnl.rows, 1e-6)
    assert float(tld) > 0
    _close(float(tld), float(jld), 1e-4)

    for state_j, state_t in (
        ((jcams, jlms), (tcams, tlms)),
        ((jnc, jnl), (torch.as_tensor(np.array(jnc)),
                      LmState(torch.as_tensor(np.array(jnl.rows))))),
    ):
        je = js.compute_error(*state_j)
        te = ts.compute_error(*state_t)
        for k in ("error_all", "error_valid"):
            np.testing.assert_allclose(float(te[k]), float(je[k]),
                                       rtol=1e-12)
        for k in ("residual_sum_all", "residual_sum_valid"):
            np.testing.assert_allclose(float(te[k]), float(je[k]),
                                       rtol=1e-7)
        for k in ("num_obs_all", "num_obs_valid", "is_numerically_valid"):
            assert int(te[k]) == int(je[k]), k


def _trajectory(summary):
    return [
        (it.step_is_successful, it.step_is_valid,
         it.linear_solver_iterations,
         it.cost.all.error if it.cost is not None else None)
        for it in summary.iterations
    ]


@pytest.mark.parametrize("config", list(CONFIGS))
def test_step2_trajectory_matches_jax(geometry, solvers, fused_solvers,
                                      config):
    """optimize_step2 for eight iterations from the same state, with the
    composed term, SolverOptions() defaults (the fused term) and RIPCG:
    identical accept/reject decisions and power-term or CG iteration
    counts; every cost within 1e-6 of the initial cost (the JAX package's
    own structured-vs-XLA bound on this geometry,
    tests/test_pallas_pose2.py:187; measured 3.3e-9 composed). The port's
    wrappers launch no kernel on CPU tensors."""
    js, ts, (jcams, jlms), (tcams, tlms) = solvers
    if config == "defaults":
        js, ts = fused_solvers
    elif config != "composed":
        js, ts = _solver_pair(geometry[0], config)
    jsum = JaxSummary()
    jax_optimize_step2(js, jcams, jlms, js.opts, jsum, JaxTimer(),
                       log=lambda s: None)
    tsum = SolverSummary()
    launches.reset_launch_counts()
    out_cams, out_lms = optimize_step2(ts, tcams, tlms, ts.opts, tsum,
                                       Timer(), log=lambda s: None)
    assert all(v == 0 for v in launches.launch_counts().values())
    assert tuple(out_cams.shape) == (12, 3, 4)
    assert tuple(out_lms.shape) == (80, 4)
    np.testing.assert_allclose(out_lms[:, 3].numpy(), 1.0)
    ta, tb = _trajectory(tsum), _trajectory(jsum)
    # RIPCG converges by the function tolerance after four iterations
    assert len(ta) == len(tb) == (5 if config == "cg" else ITERS + 1)
    c_init = tb[0][3]
    for a, b in zip(ta, tb):
        assert a[:3] == b[:3], (ta, tb)
        if a[3] is not None or b[3] is not None:
            assert abs(a[3] - b[3]) <= 1e-6 * c_init, (ta, tb)
    assert tsum.termination_type == jsum.termination_type
    assert tsum.solver_type == jsum.solver_type


@pytest.mark.parametrize("config", list(CONFIGS))
def test_bundle_adjust_matches_jax(config):
    """The two-step pipeline on synthetic_bal_problem(8, 60, 5, seed=7)
    with 1e-3 pixel noise (tools/step2_spread.py's `small_case`), step 1
    capped at 6 iterations and step 2 at 10, in both packages, with the
    composed term and with SolverOptions() defaults (the fused term).
    With noise-free data the step-2 optimum is a zero cost (no relative
    comparison means anything there) and step 2 does not settle within a
    test's budget; with noise it converges by the function tolerance in 3
    iterations, to the same optimum from either package's step-1 result
    (and from 8 or 12 step-1 iterations alike). Accept/reject decisions
    and power-term counts are identical in both steps; both final costs
    are held to 1e-4 relative (measured 3.2e-5 for step 1: the f32 inner
    solves compound over the accepted steps, as in
    tests/test_torch_stage1.py; 5.4e-12 for step 2).

    PCG + RIPCG ("cg") runs step 1 for 11 iterations: the step-2 start
    is chaotic in the step-1 state (after 6 PCG iterations 3.2e-4 apart
    in cost, the two packages' step-2 starts were 2.5x apart and their
    RIPCG decisions parted), and from 11 on both step 2s reach the same
    optimum with identical decisions and CG counts (final costs measured
    1.5e-10 apart). Step 1's decisions are identical, its CG counts on
    the first 9 records; from record 9 on (the states 3.7e-3 apart in
    cost by then) they may differ by one iteration (measured 10 against
    9 at record 9), and its final cost is held to 1e-2 (measured
    6.4e-3)."""
    cg = config == "cg"
    opts = dict(max_num_iterations_step_1=11 if cg else 6,
                max_num_iterations_step_2=10)
    jp, _ = synthetic_bal_problem(n_cams=8, n_lms=60, obs_per_lm=5, seed=7,
                                  noise=1e-3)
    jo = _slice_options(JaxOptions, config, pallas_kernels="on", **opts)
    tp, _c, _l = from_numpy(jp.obs_cam, jp.obs_lm, jp.obs_uv, jp.cam_space,
                            jp.lm_p, device="cpu")
    _, j1, j2 = jax_bundle_adjust(copy.deepcopy(jp), jo, log=lambda s: None)
    out, t1, t2 = bundle_adjust(tp, _slice_options(SolverOptions, config,
                                                   **opts),
                                log=lambda s: None, device="cpu")
    for step, t, j in ((1, t1, j1), (2, t2, j2)):
        assert [it.step_is_successful for it in t.iterations] == [
            it.step_is_successful for it in j.iterations
        ]
        assert t.termination_type == j.termination_type
        assert t.solver_type == j.solver_type
        tn = [it.linear_solver_iterations for it in t.iterations]
        jn = [it.linear_solver_iterations for it in j.iterations]
        if cg and step == 1:
            assert tn[:9] == jn[:9]
            assert all(abs(a - b) <= 1 for a, b in zip(tn, jn)), (tn, jn)
        else:
            assert tn == jn
        tol = 1e-2 if cg and step == 1 else 1e-4
        np.testing.assert_allclose(t.final_cost.all.error,
                                   j.final_cost.all.error, rtol=tol)
    assert t2.termination_type == "CONVERGENCE"
    assert out is tp and out.lm_p_h.shape == (60, 4)
    np.testing.assert_allclose(out.lm_p, out.lm_p_h[:, :3] / out.lm_p_h[:, 3:])
    np.testing.assert_allclose(
        np.sqrt((out.cam_space ** 2).sum(axis=(1, 2))), 1.0, atol=1e-12
    )


def test_bundle_adjust_default_options_raise(geometry):
    """SolverOptions() defaults with CHOLESKY in pure f64, which both
    steps refused (ROADMAP item 11) until pure f64 was ported: the name
    is kept; bundle_adjust now runs it on the CPU, one LM iteration a
    step, each accepted with a falling cost, and writes the optimized
    state back to the problem."""
    args, cam0, lm0 = geometry
    p, _c, _l = from_numpy(args[0], args[1], args[2], cam0, lm0,
                           device="cpu")
    before = p.cam_space.copy()
    opts = SolverOptions(mixed_precision_solves=False,
                         max_num_iterations_step_1=1,
                         max_num_iterations_step_2=1)
    opts.solver_type_step_1 = type(opts.solver_type_step_1)["CHOLESKY"]
    out, s1, s2 = bundle_adjust(p, opts, log=lambda s: None, device="cpu")
    for s in (s1, s2):
        assert len(s.iterations) == 2 and s.iterations[1].step_is_successful
        assert s.final_cost.all.error < s.initial_cost.all.error
    assert out is p and not np.array_equal(p.cam_space, before)
    assert np.isfinite(p.cam_space).all() and np.isfinite(p.lm_p_h).all()


def _cfg(**kw):
    return _slice_options(SolverOptions, **kw)


# `match`: the ROADMAP item a refused configuration names. The cases
# with none run: pure f64 (`mixed_precision_solves=False` with an f64
# state, under "auto" and "off"), refused as item 11 until it was ported
# (tests/test_torch_f64_steps.py holds it to the JAX package), and
# device_lm_loop="on", refused as item 8 until the device loop was
# ported (tests/test_torch_device_loop.py holds it to the host loop and
# the JAX package), and detailed_timing, refused as item 14 until its
# staged loop was ported (tests/test_torch_timing.py).
@pytest.mark.parametrize(
    "opts, dtype, match",
    [
        (_cfg(mixed_precision_solves=False), torch.float64, None),
        (_cfg(pallas_kernels="off", device_lm_loop="on"), torch.float32,
         None),
        (_cfg(pallas_kernels="off", mixed_precision_solves=False),
         torch.float64, None),
        (_cfg(device_lm_loop="on"), torch.float64, None),
        (_cfg(detailed_timing=True), torch.float64, None),
    ],
    ids=["f64_solves", "f32_state_unstructured", "unstructured",
         "device_loop", "detailed_timing"],
)
def test_configurations_outside_the_slice_raise(geometry, opts, dtype,
                                                match):
    """A refused configuration raises NotImplementedError naming its
    ROADMAP item; one that runs (no `match`: pure f64, on the
    unstructured layout with f64 solves, the device loop, or the staged
    loop of detailed_timing) builds on the CPU and takes one LM iteration
    from the homogenized ring state whose cost falls."""
    args, cam0, lm0 = geometry
    if match is not None:
        with pytest.raises(NotImplementedError, match=match):
            Stage2Solver(*args, opts, dtype=dtype, device="cpu")
        return
    opts.max_num_iterations_step_2 = 1
    s = Stage2Solver(*args, opts, dtype=dtype, device="cpu")
    if not opts.mixed_precision_solves:
        assert s.unstructured and s.solve_dtype == torch.float64
    summary = SolverSummary()
    optimize_step2(s, *create_homogeneous(torch.as_tensor(cam0),
                                          torch.as_tensor(lm0)),
                   opts, summary, Timer(), log=lambda line: None)
    assert len(summary.iterations) == 2
    assert summary.iterations[1].step_is_successful
    assert (summary.final_cost.all.error
            < summary.initial_cost.all.error)


def test_too_many_cameras_raise():
    """One device runs step 2 at any camera count: 1025 cameras build;
    a mesh past 1024 cameras raises naming ROADMAP item 13
    (tests/test_torch_stage1.py runs that refusal through
    bundle_adjust)."""
    s = Stage2Solver(np.array([0, 1024]), np.array([0, 0]),
                     np.zeros((2, 2)), 1025, 1, _cfg(), device="cpu")
    assert s.n_cams == 1025
    why = tspmd.spmd_unsupported(_cfg(), 1025, torch.float64)
    assert "item 13" in why


def test_default_device_is_the_card(geometry):
    """Stage2Solver and bundle_adjust run on the card unless the caller
    asks for the CPU: without a CUDA device (as where the tests run) the
    default raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args, cam0, lm0 = geometry
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Stage2Solver(*args, _cfg())
    p, _c, _l = from_numpy(args[0], args[1], args[2], cam0, lm0,
                           device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bundle_adjust(p, _cfg(), log=lambda s: None)

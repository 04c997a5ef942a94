"""Step 1 of povar_tpu_torch against povar_tpu on one problem
(synthetic_bal_problem(n_cams=8, n_lms=60, obs_per_lm=5, seed=7)): the
modules of the solve one by one, then the slice as a whole.

JAX side: Stage1Solver with pallas_kernels="on" (the Pallas kernels in
interpret mode, as tests/test_pallas_pose.py runs them) and
device_lm_loop="off"; the module tests run the composed power term
(fused_power_term=False), the solve and slice tests also run
SolverOptions() defaults (the fused term) and PCG. Port side: the same
options on the CPU, where every kernel call runs its plain PyTorch
version.

Both packages evaluate the linearization and the inner solve in f32
with sums in different orders, so module outputs agree to f32 rounding
amplified by the problem's conditioning; tolerances are relative to the
largest magnitude of each output and stated per test with the gap
measured on this problem. Costs are f64 and agree to 1e-12 on equal
states. Decisions (accept/reject, power-series term counts) must be
identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from povar_tpu.options import SolverOptions as JaxOptions
from povar_tpu.problem.synthetic import synthetic_bal_problem
from povar_tpu.solver.lm import optimize_step1 as jax_optimize_step1
from povar_tpu.solver.stage1 import Stage1Solver as JaxStage1
from povar_tpu.utils.summary import SolverSummary as JaxSummary
from povar_tpu.utils.timer import Timer as JaxTimer
from povar_tpu_torch import (
    SolverOptions,
    SolverSummary,
    Stage1Solver,
    Timer,
    bundle_adjust,
    from_numpy,
    make_mesh,
    optimize_step1,
)
from povar_tpu_torch.options import RobustNorm, SolverType
from povar_tpu_torch.ops import launches, pose_kernels
from povar_tpu_torch.solver.stage1 import LmState

# one torch thread a test process: the CPU tests' tensors are small,
# and a parallel run's xdist workers share the host's cores
torch.set_num_threads(1)

ITERS = 6


# the configurations the slice tests run: the composed power term,
# SolverOptions() defaults (the fused term) and PCG (SCHUR_JACOBI)
CONFIGS = {
    "composed": dict(fused_power_term=False),
    "defaults": {},
    "pcg": dict(solver_type_step_1="PCG"),
}


def _slice_options(cls, config="composed"):
    opts = cls()
    opts.max_num_iterations_step_1 = ITERS
    opts.device_lm_loop = "off"
    for k, v in CONFIGS[config].items():
        if isinstance(v, str):  # an enum member, by name
            v = type(getattr(opts, k))[v]
        setattr(opts, k, v)
    return opts


def _solver_pair(problem, config):
    """(JAX Stage1Solver with the Pallas kernels on, port Stage1Solver on
    the CPU) under CONFIGS[config]."""
    jopts = _slice_options(JaxOptions, config)
    jopts.pallas_kernels = "on"
    args = (problem.obs_cam, problem.obs_lm, problem.obs_uv,
            problem.num_cameras, problem.num_landmarks)
    js = JaxStage1(*args, jopts)
    assert js.use_pallas
    assert (js._e0_meta is None) == (config == "composed")
    ts = Stage1Solver(*args, _slice_options(SolverOptions, config),
                      device="cpu")
    assert (ts.e0_plan is None) == (config == "composed")
    return js, ts


@pytest.fixture(scope="module")
def problem():
    return synthetic_bal_problem(n_cams=8, n_lms=60, obs_per_lm=5, seed=7)[0]


@pytest.fixture(scope="module")
def solvers(problem):
    return _solver_pair(problem, "composed")


@pytest.fixture(scope="module")
def fused_solvers(problem):
    return _solver_pair(problem, "defaults")


@pytest.fixture(scope="module")
def lin_point(problem, solvers):
    """JAX's linearization at the VarProj-initialized state, and the
    same arrays as torch tensors: module tests feed both packages the
    same inputs."""
    js, ts = solvers
    cams = jnp.asarray(problem.cam_space)
    lms = js.initialize_varproj(cams)
    jlin = js.linearize(cams, js.lm_pack(lms))
    tlin = type(ts.linearize(torch.as_tensor(problem.cam_space),
                             torch.as_tensor(np.array(lms))))(
        *[torch.as_tensor(np.array(v)) for v in jlin]
    )
    return cams, lms, jlin, tlin


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def test_initialize_varproj(problem, solvers):
    """Measured gap 3.9e-7; tolerance 1e-5."""
    js, ts = solvers
    want = js.initialize_varproj(jnp.asarray(problem.cam_space))
    got = ts.initialize_varproj(torch.as_tensor(problem.cam_space))
    assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
    _close(got.numpy(), want, 1e-5)


def test_linearize(problem, solvers, lin_point):
    """Each package linearizes at its own initialized state. Measured
    gaps <= 7e-7 (r_w), 2e-7 (pose_scale); tolerance 1e-5. bl_raw is
    analytically zero there (the landmarks minimize the cost for these
    cameras), so both hold rounding noise: bounded by 1e-5 of the
    |hll_raw| x |x| scale instead."""
    js, ts = solvers
    _cams, lms, jlin, _tlin = lin_point
    tlms = ts.initialize_varproj(torch.as_tensor(problem.cam_space))
    tlin = ts.linearize(torch.as_tensor(problem.cam_space), ts.lm_pack(tlms))
    for f in ("ct", "x", "r_w", "sw", "hll_raw", "jl_scale", "pose_scale"):
        _close(getattr(tlin, f).numpy(), getattr(jlin, f), 1e-5)
    scale = np.abs(np.asarray(jlin.hll_raw)).max() * np.abs(
        np.asarray(jlin.x)).max()
    assert np.abs(tlin.bl_raw.numpy()).max() <= 1e-5 * scale
    assert np.abs(np.asarray(jlin.bl_raw)).max() <= 1e-5 * scale


def test_hpp_b(solvers, lin_point):
    """The per-camera normal equations of one linearization (hpp
    undamped, b) from the same linearization. Measured gap 3.0e-7
    (hpp), 1.6e-7 (b); tolerance 1e-4 (per-camera sums)."""
    js, ts = solvers
    _cams, _lms, jlin, tlin = lin_point
    lam = jnp.asarray(1e-4, jnp.float32)
    _hi, jhib, jjls, _lh = js._hll_pieces_s(js.obs, jlin, lam, False)
    jhpp, jb = js._hpp_b_s(js.obs, jlin, jhib, jjls)
    _hi, thib, tjls, _lh = ts._hll_pieces_s(tlin)
    _close(thib.numpy(), jhib, 1e-5)
    thpp, tb = ts._hpp_b_s(tlin, thib, tjls)
    _close(thpp.numpy(), jhpp, 1e-4)
    _close(tb.numpy(), jb, 1e-4)


@pytest.mark.parametrize("term", ["composed", "fused"])
@pytest.mark.parametrize("lam", [1e-4, 1e2])
def test_power_series_increment(solvers, fused_solvers, lin_point, lam,
                                term):
    """One POWER_VARPROJ solve from the same linearization, with the
    composed and with the fused power term in both packages: the same
    number of power terms (the slice test below covers the full m = 10
    terms), the increment within 1e-4 (measured 4.4e-6 at lam=1e-4: f32
    rounding in another summation order, amplified by the reduced
    camera system's conditioning)."""
    js, ts = solvers if term == "composed" else fused_solvers
    _cams, _lms, jlin, tlin = lin_point
    jinc, jn = js.solve_power(jlin, jnp.asarray(lam))
    tinc, tn = ts.solve_power(tlin, lam)
    assert tn == int(jn)
    assert tinc.dtype == torch.float64
    _close(tinc.numpy(), jinc, 1e-4)


def test_apply_and_compute_error(solvers, lin_point):
    """The apply (camera update + VarProj back-substitution) of one
    increment and the f64 cost of the result: cameras agree exactly
    (the same f32 unscaling), landmarks to 1e-5 (measured 2.4e-6),
    l_diff to 1e-4 (measured 8e-9), and the cost of the SAME state to
    1e-12 against the JAX double-float kernel (measured 1e-15)."""
    js, ts = solvers
    cams, lms, jlin, tlin = lin_point
    jinc, _ = js.solve_power(jlin, jnp.asarray(1e-4))
    tcams = torch.as_tensor(np.array(cams))
    jnc, jnl, jld = js.apply(cams, js.lm_pack(lms), jlin, jinc)
    tnc, tnl, tld = ts.apply(
        tcams, ts.lm_pack(torch.as_tensor(np.array(lms))), tlin,
        torch.as_tensor(np.array(jinc)),
    )
    np.testing.assert_array_equal(tnc.numpy(), np.asarray(jnc))
    assert isinstance(tnl, LmState)
    _close(tnl.rows.numpy(), jnl.rows, 1e-5)
    _close(float(tld), float(jld), 1e-4)

    for state_j, state_t in (
        ((cams, lms), (tcams, torch.as_tensor(np.array(lms)))),
        ((jnc, jnl), (torch.as_tensor(np.array(jnc)),
                      LmState(torch.as_tensor(np.array(jnl.rows))))),
    ):
        je = js.compute_error(*state_j)
        te = ts.compute_error(*state_t)
        np.testing.assert_allclose(
            float(te["error_all"]), float(je["error_all"]), rtol=1e-12
        )
        np.testing.assert_allclose(
            float(te["residual_sum_all"]), float(je["residual_sum_all"]),
            rtol=1e-7,
        )
        assert te["num_obs_all"] == int(je["num_obs_all"])
        assert bool(te["is_numerically_valid"])


@pytest.mark.parametrize("call", ["back_substitution", "initialization"])
def test_prepare_without_sums_in_the_solver(problem, solvers, lin_point,
                                            monkeypatch, call):
    """The VarProj back-substitution (`_back_sub_s`, reached through
    `apply`) and the landmark initialization read ata / atr of `prepare`
    alone, so they ask for no per-camera sums (sums=False, one call
    each); with the sums computed as before they give the same bits:
    new_lm_p and l_diff, the initial landmarks. The six-iteration VarProj
    trajectories against JAX's are test_step1_slice_matches_jax's."""
    _js, ts = solvers
    cams, lms, _jlin, tlin = lin_point
    tcams = torch.as_tensor(np.array(cams))
    real = pose_kernels.prepare
    asked = []

    def spy(*args, **kw):
        asked.append(kw.get("sums", True))
        return real(*args, **kw)

    def with_sums(*args, **kw):
        return real(*args, **dict(kw, sums=True))

    if call == "back_substitution":
        inc, _terms = ts.solve_power(tlin, 1e-4)

        def run():
            lm = ts.lm_pack(torch.as_tensor(np.array(lms)))
            return ts.apply(tcams, lm, tlin, inc)
    else:
        def run():
            return (ts.initialize_varproj(tcams),)
    monkeypatch.setattr(pose_kernels, "prepare", spy)
    got = run()
    assert asked == [False]
    monkeypatch.setattr(pose_kernels, "prepare", with_sums)
    want = run()
    for g, w in zip(got, want):
        g, w = (x.rows if isinstance(x, LmState) else x for x in (g, w))
        assert torch.equal(g, w)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_step1_slice_matches_jax(problem, solvers, config):
    """optimize_step1 for six iterations in both packages from the same
    numpy problem, with the composed term, SolverOptions() defaults (the
    fused term) and PCG: identical accept/reject decisions and power-term
    or CG iteration counts; costs within 1e-3 (measured 1.0e-4 composed:
    f32 inner-solve rounding compounds over the accepted steps, as
    between the JAX package's own structured and XLA paths,
    tests/test_pallas_pose.py:398) and the lambda schedule within 1e-4
    (measured 1.2e-5: the damping factor is a function of the cost
    decrease, so it inherits the costs' noise)."""
    js, ts = solvers if config == "composed" else _solver_pair(problem,
                                                               config)
    jsum = JaxSummary()
    jax_optimize_step1(
        js, jnp.asarray(problem.cam_space), jnp.asarray(problem.lm_p),
        js.opts, jsum, JaxTimer(), log=lambda s: None,
    )
    _p, cams, lms = from_numpy(
        problem.obs_cam, problem.obs_lm, problem.obs_uv, problem.cam_space,
        problem.lm_p, device="cpu",
    )
    tsum = SolverSummary()
    launches.reset_launch_counts()
    out_cams, out_lms = optimize_step1(
        ts, cams, lms, ts.opts, tsum, Timer(), log=lambda s: None
    )
    assert all(v == 0 for v in launches.launch_counts().values())
    assert tuple(out_cams.shape) == (problem.num_cameras, 3, 4)
    assert tuple(out_lms.shape) == (problem.num_landmarks, 3)
    assert len(tsum.iterations) == len(jsum.iterations) == ITERS + 1
    for t, j in zip(tsum.iterations, jsum.iterations):
        assert t.step_is_successful == j.step_is_successful
        assert t.step_is_valid == j.step_is_valid
        assert t.linear_solver_iterations == j.linear_solver_iterations
        np.testing.assert_allclose(
            t.cost.all.error, j.cost.all.error, rtol=1e-3
        )
        np.testing.assert_allclose(
            t.trust_region_radius, j.trust_region_radius, rtol=1e-4
        )
    assert tsum.termination_type == jsum.termination_type
    assert tsum.solver_type == jsum.solver_type
    np.testing.assert_allclose(
        tsum.final_cost.all.error, jsum.final_cost.all.error, rtol=1e-3
    )


def _cfg(**kw):
    opts = _slice_options(SolverOptions)
    for k, v in kw.items():
        setattr(opts, k, v)
    return opts


# the configurations that stay refused (`match`: their ROADMAP item,
# NotImplementedError at construction), and the ones that run (no
# `match`): pure f64, refused as ROADMAP item 11 until it was ported
# (tests/test_torch_f64_steps.py holds it to the JAX package), and
# device_lm_loop="on", refused as item 8 until the device loop was
# ported (tests/test_torch_device_loop.py holds it to the host loop and
# the JAX package), which runs POWER_VARPROJ's loop on the device and
# refuses CHOLESKY with the JAX package's ValueError (`match`
# "ValueError"), and detailed_timing, refused as item 14 until its staged
# loop was ported (tests/test_torch_timing.py holds it to the fused host
# loop and the JAX package). The ids are the names these cases have
# carried since each was added.
@pytest.mark.parametrize(
    "opts, dtype, match",
    [
        (_cfg(solver_type_step_1=SolverType.CHOLESKY,
              mixed_precision_solves=False), torch.float64, None),
        (_cfg(solver_type_step_1=SolverType.CHOLESKY,
              device_lm_loop="on"), torch.float64, "ValueError"),
        (_cfg(solver_type_step_1=SolverType.CHOLESKY, fused_power_term=False,
              detailed_timing=True), torch.float64, None),
        (_cfg(mixed_precision_solves=False), torch.float64, None),
        (_cfg(mixed_precision_solves=False, fused_power_term=False),
         torch.float64, None),
        (_cfg(pallas_kernels="off", mixed_precision_solves=False),
         torch.float64, None),
        (_cfg(pallas_kernels="off", device_lm_loop="on"), torch.float32,
         None),
        (_cfg(device_lm_loop="on"), torch.float64, None),
        (_cfg(detailed_timing=True), torch.float64, None),
    ],
    ids=["opts0-dtype0-item 9", "opts1-dtype1-item 9",
         "opts2-dtype2-CHOLESKY", "opts3-dtype3-item 11",
         "opts4-dtype4-item 11", "opts5-dtype5-item 9",
         "opts6-dtype6-item 9", "opts7-dtype7-item 8",
         "opts8-dtype8-item 14"],
)
def test_configurations_outside_the_slice_raise(problem, opts, dtype, match):
    """A refused configuration raises NotImplementedError naming its
    ROADMAP item, or (CHOLESKY under device_lm_loop="on") builds and
    raises the JAX package's ValueError when its loop starts; one that
    runs (no `match`: pure f64, on the unstructured layout with f64
    solves, the device loop, or the staged loop of detailed_timing)
    builds on the CPU and takes one LM iteration whose cost falls."""
    args = (problem.obs_cam, problem.obs_lm, problem.obs_uv,
            problem.num_cameras, problem.num_landmarks)
    if match is not None and match.startswith("item"):
        with pytest.raises(NotImplementedError, match=match):
            Stage1Solver(*args, opts, dtype=dtype, device="cpu")
        return
    opts.max_num_iterations_step_1 = 1
    s = Stage1Solver(*args, opts, dtype=dtype, device="cpu")
    if not opts.mixed_precision_solves:
        assert s.unstructured and s.solve_dtype == torch.float64
    summary = SolverSummary()
    run = lambda: optimize_step1(  # noqa: E731
        s, torch.as_tensor(problem.cam_space),
        torch.as_tensor(problem.lm_p), opts, summary, Timer(),
        log=lambda line: None)
    if match == "ValueError":
        with pytest.raises(ValueError, match="device_lm_loop='on'"):
            run()
        return
    run()
    assert len(summary.iterations) == 2
    assert summary.iterations[1].step_is_successful
    assert (summary.final_cost.all.error
            < summary.initial_cost.all.error)


@pytest.mark.parametrize("mixed", [True, False])
def test_f32_state_solves_in_f32(problem, mixed):
    """An f32 LM state solves in f32 whether or not mixed precision is
    asked for, as in the JAX package (stage1.py:676-680): neither raises,
    and POWER_SCHUR_COMPLEMENT constructs with it."""
    opts = _cfg(mixed_precision_solves=mixed,
                solver_type_step_1=SolverType.POWER_SCHUR_COMPLEMENT)
    s = Stage1Solver(problem.obs_cam, problem.obs_lm, problem.obs_uv,
                     problem.num_cameras, problem.num_landmarks, opts,
                     dtype=torch.float32, device="cpu")
    assert s.dtype == s.solve_dtype == torch.float32 and s.poba


def test_too_many_cameras_raise():
    """One device runs any camera count (the 1024 of the TPU's one-hot
    limit is no limit of the port's): 1025 cameras build. A mesh keeps
    the limit (ROADMAP.md queue 1 item 13, the mesh's larger-N plan)."""
    Stage1Solver(np.array([0, 1024]), np.array([0, 0]), np.zeros((2, 2)),
                 1025, 1, _cfg(), device="cpu")
    problem = synthetic_bal_problem(n_cams=1025, n_lms=60, obs_per_lm=5,
                                    seed=7)[0]
    with pytest.raises(NotImplementedError, match="item 13"):
        bundle_adjust(problem, SolverOptions(), device="cpu",
                      mesh=make_mesh(1, "cpu"))


def test_too_many_cameras_cholesky_raise():
    """CHOLESKY's dense solve runs up to DENSE_CHOL_MAX = 1536 cameras,
    as the JAX package's; past it the solver no longer raises but builds
    the JAX package's banded plan (solver/band_chol.py): at 1537 cameras
    one landmark seen by cameras 0 and 1536 sits in one band row (bw 1,
    K 32, S 49 supernodes), the JAX package's plan bit for bit."""
    from povar_tpu.solver import band_chol as jax_band

    chol = _cfg(solver_type_step_1=SolverType.CHOLESKY)
    s = Stage1Solver(np.array([0, 1535]), np.array([0, 0]),
                     np.zeros((2, 2)), 1536, 1, chol, device="cpu")
    assert s._band_plan is None and not s._chol_pcg_fallback
    s = Stage1Solver(np.array([0, 1536]), np.array([0, 0]),
                     np.zeros((2, 2)), 1537, 1, chol, device="cpu")
    assert not s._chol_pcg_fallback
    meta = s._band_plan.meta
    assert (meta.n_cams, meta.bw, meta.K, meta.S) == (1537, 1, 32, 49)
    w = s.obs.weight.numpy()
    want = jax_band.build_band_plan(s.obs.cam.numpy(), s.obs.lm.numpy(),
                                    1537, 1, live=w, allow_dense=True)
    assert tuple(want.meta) == tuple(meta)
    for f in ("pos", "diag_rows", "d_idx", "e_idx"):
        np.testing.assert_array_equal(getattr(s._band_plan.arrays, f),
                                      getattr(want.arrays, f))


def test_default_options_and_huber_run(problem):
    """SolverOptions() defaults (the fused power term; device loop 'auto'
    = the host loop here) and a HUBER configuration both construct and
    take a step whose cost falls."""
    for robust in (RobustNorm.NONE, RobustNorm.HUBER):
        opts = SolverOptions()
        opts.max_num_iterations_step_1 = 2
        opts.residual.robust_norm = robust
        s = Stage1Solver(problem.obs_cam, problem.obs_lm, problem.obs_uv,
                         problem.num_cameras, problem.num_landmarks, opts,
                         device="cpu")
        summ = SolverSummary()
        optimize_step1(s, torch.as_tensor(problem.cam_space),
                       torch.as_tensor(problem.lm_p), opts, summ, Timer(),
                       log=lambda s_: None)
        costs = [it.cost.all.error for it in summ.iterations]
        assert costs[-1] < costs[0]


def test_cuda_device_without_a_card_raises(problem):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Stage1Solver(problem.obs_cam, problem.obs_lm, problem.obs_uv,
                     problem.num_cameras, problem.num_landmarks, _cfg(),
                     device="cuda")


def test_default_device_is_the_card(problem):
    """Stage1Solver runs on the card unless the caller asks for the
    CPU: without a CUDA device (as where the tests run) the default
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Stage1Solver(problem.obs_cam, problem.obs_lm, problem.obs_uv,
                     problem.num_cameras, problem.num_landmarks, _cfg())

"""The banded CHOLESKY (povar_tpu_torch/solver/band_chol.py) against
povar_tpu/solver/band_chol.py on the CPU.

At the JAX package's own test sizes (tests/test_band_chol.py): 48
cameras and 600 landmarks (synthetic_bal_problem_fast(48, 600, 5,
seed=3, locality=8): RCM bandwidth 9, K = 32, S = 2 supernodes, so the
factorization couples two of them), with DENSE_CHOL_MAX lowered to 8 in
both packages by a module-scoped MonkeyPatch, undone at teardown; the
full band on the JAX test's adversarial problem with MAX_SUPERNODE 4;
the PCG fallback on its 4096-camera adversarial problem. Every input
comes from one seed through numpy; each JAX solver is built once in the
module and shared.

- the plan bit for bit (pos, diag_rows, every pair chunk with its
  padded reduce, d_idx, e_idx, the meta), banded and full band, and the
  two RuntimeWarnings word for word;
- assemble_band against the JAX package's on the same WL, hpp and
  lambda: f32 within 1e-6 of the band's largest entry (measured 2.0e-7),
  f64 within 1e-14 (measured 3.7e-16);
- the banded increment against numpy's dense solve of the same S,
  assembled from the solver's own pieces: 5e-3 relative in f32, as the
  JAX package's test (measured 3.6e-5), 1e-9 in f64 (measured 1.0e-13);
- optimize_step1 over 6 CHOLESKY iterations on the banded problem in
  both packages: identical decisions, costs within 1e-10 in pure f64
  (measured 9.1e-12) and 1e-3 in mixed precision, the tolerance of the
  dense route's trajectory test (tests/test_torch_unstructured.py;
  measured 1.6e-4: the f32 factorizations differ, JAX's a 12-wide
  blocked Cholesky, the port's LAPACK's, and the rounding compounds over
  the accepted steps);
- tools/large_scale.band_residual (chip_smoke.py's check of the banded
  increment at the scales no dense route reaches): small for the banded
  increment, 1000 times larger with the coupling blocks dropped;
- the PCG fallback (port side): solve_cholesky is solve_pcg bit for
  bit, with at least one CG iteration.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from povar_tpu.options import SolverOptions as JaxOptions
from povar_tpu.problem.synthetic import (
    synthetic_bal_problem_adversarial,
    synthetic_bal_problem_fast,
)
from povar_tpu.solver import band_chol as jax_band
from povar_tpu.solver import stage1 as jax_stage1
from povar_tpu.solver.lm import optimize_step1 as jax_optimize_step1
from povar_tpu.utils.summary import SolverSummary as JaxSummary
from povar_tpu.utils.timer import Timer as JaxTimer
from povar_tpu_torch import SolverOptions, SolverSummary, Timer, optimize_step1
from povar_tpu_torch.ops import launches, linalg
from povar_tpu_torch.solver import band_chol
from povar_tpu_torch.solver import stage1 as torch_stage1

# one torch thread a test process: the CPU tests' tensors are small,
# and a parallel run's xdist workers share the host's cores
torch.set_num_threads(1)

ITERS = 6
# the optimize_step1 costs: pure f64, mixed precision
COST_RTOL = {"f64": 1e-10, "mixed": 1e-3}


@pytest.fixture(scope="module")
def patched():
    """DENSE_CHOL_MAX lowered to 8 in both packages for the module."""
    from _pytest.monkeypatch import MonkeyPatch

    mp = MonkeyPatch()
    mp.setattr(jax_stage1, "DENSE_CHOL_MAX", 8)
    mp.setattr(torch_stage1, "DENSE_CHOL_MAX", 8)
    yield mp
    mp.undo()


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors go to the plain versions: no kernel launch counted."""
    launches.reset_launch_counts()
    yield
    assert not any(launches.launch_counts().values())


@pytest.fixture(scope="module")
def problem():
    return synthetic_bal_problem_fast(48, 600, 5, seed=3, locality=8)


def _args(p):
    return (p.obs_cam, p.obs_lm, p.obs_uv, p.num_cameras, p.num_landmarks)


def _options(cls, config, **kw):
    """CHOLESKY with the host LM loop, in mixed precision or pure f64."""
    opts = cls()
    opts.solver_type_step_1 = type(opts.solver_type_step_1)["CHOLESKY"]
    opts.device_lm_loop = "off"
    opts.mixed_precision_solves = config == "mixed"
    for k, v in kw.items():
        setattr(opts, k, v)
    return opts


@pytest.fixture(scope="module")
def solvers(patched, problem):
    """{config: (JAX solver, port solver)}, both on the banded route."""
    out = {}
    for config in ("mixed", "f64"):
        js = jax_stage1.Stage1Solver(*_args(problem),
                                     _options(JaxOptions, config))
        ts = torch_stage1.Stage1Solver(*_args(problem),
                                       _options(SolverOptions, config),
                                       device="cpu")
        assert js._band_plan is not None and ts._band_plan is not None
        out[config] = (js, ts)
    return out


def _same_plan(tp, jp):
    """The port's plan is the JAX package's, array for array."""
    assert tuple(tp.meta) == tuple(jp.meta)
    ta, ja = tp.arrays, jp.arrays
    for f in ("pos", "diag_rows", "d_idx", "e_idx"):
        t, j = np.asarray(getattr(ta, f)), np.asarray(getattr(ja, f))
        assert t.dtype == j.dtype, f
        np.testing.assert_array_equal(t, j, err_msg=f)
    assert len(ta.pair_chunks) == len(ja.pair_chunks) >= 1
    for (tia, tib, tr), (jia, jib, jr) in zip(ta.pair_chunks, ja.pair_chunks):
        np.testing.assert_array_equal(tia, jia)
        np.testing.assert_array_equal(tib, jib)
        assert tia.dtype == jia.dtype == np.int32
        assert len(tr.idx) == len(jr.idx)
        for t, j in zip(tr.idx + tr.mask + (tr.inv_order,),
                        jr.idx + jr.mask + (jr.inv_order,)):
            j = np.asarray(j)
            assert t.numpy().dtype == j.dtype
            np.testing.assert_array_equal(t.numpy(), j)


def _warned(fn):
    """(fn's result, the messages of the RuntimeWarnings it raised)."""
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(w.message) for w in got
                 if issubclass(w.category, RuntimeWarning)]


@pytest.mark.parametrize("route", ["banded", "full_band"])
def test_plan_matches_jax(patched, problem, solvers, monkeypatch, route):
    """The plan bit for bit: banded (48 cameras, S = 2) through the
    solvers' construction, and the full band (the JAX test's adversarial
    problem with MAX_SUPERNODE 4 in both packages: bw = N - 1, one
    supernode chain), whose "FULL dense RCS" warning is the JAX
    package's word for word."""
    if route == "banded":
        js, ts = solvers["mixed"]
        assert ts._band_plan.meta.S >= 2 and ts._band_plan.meta.bw < 47
        _same_plan(ts._band_plan, js._band_plan)
        # the device copy holds the same arrays
        np.testing.assert_array_equal(ts._band_arrays.d_idx.numpy(),
                                      js._band_plan.arrays.d_idx)
        return
    monkeypatch.setattr(jax_band, "MAX_SUPERNODE", 4)
    monkeypatch.setattr(band_chol, "MAX_SUPERNODE", 4)
    p = synthetic_bal_problem_adversarial(
        48, 600, mean_obs_per_lm=5.0, loop_closure_frac=0.5, seed=7)
    js, jw = _warned(lambda: jax_stage1.Stage1Solver(
        *_args(p), _options(JaxOptions, "mixed", pallas_kernels="off")))
    ts, tw = _warned(lambda: torch_stage1.Stage1Solver(
        *_args(p), _options(SolverOptions, "mixed"), device="cpu"))
    assert ts._band_plan.meta.bw == p.num_cameras - 1
    assert not ts._chol_pcg_fallback
    assert len(jw) == 1 and "FULL dense RCS" in jw[0]
    assert tw == jw
    _same_plan(ts._band_plan, js._band_plan)
    # one supernode chain, no coupling panels: the direct solve of the
    # JAX test at lambda 1e-2 (measured 3.8e-6 from numpy's)
    cams = torch.as_tensor(p.cam_space)
    lin = ts.linearize(cams, ts.initialize_varproj(cams))
    inc, n_it = ts.solve_cholesky(lin, 1e-2)
    s_mat, b = _numpy_rcs(ts, lin, float(ts._solve_scalar(1e-2)))
    want = -np.linalg.solve(s_mat, b.T.reshape(-1)).reshape(-1, 12).T
    gap = np.linalg.norm(inc.numpy() - want) / np.linalg.norm(want)
    print(f"full band increment: relative gap {gap:.2e}")
    assert n_it == 0 and gap <= 5e-3


@pytest.mark.parametrize("config", ["mixed", "f64"])
def test_assemble_band_matches_jax(solvers, config):
    """assemble_band on the same seeded WL [12, 3, O], hpp [12, 12, N]
    and lambda in both packages: f32 within 1e-6 of the band's largest
    entry, f64 within 1e-14."""
    js, ts = solvers[config]
    rng = np.random.default_rng(11)
    o, n = int(ts.obs.cam.shape[0]), ts.n_cams
    dt = np.float32 if config == "mixed" else np.float64
    wl = rng.standard_normal((12, 3, o)).astype(dt)
    hpp = rng.standard_normal((12, 12, n)).astype(dt)
    lam = dt(0.37)
    got = band_chol.assemble_band(
        ts._band_plan.meta, ts._band_arrays, torch.as_tensor(wl),
        torch.as_tensor(hpp), float(lam)).numpy()
    want = np.asarray(jax_band.assemble_band(
        js._band_meta, js._band_arrays, jnp.asarray(wl), jnp.asarray(hpp),
        jnp.asarray(lam)))
    assert got.dtype == want.dtype == dt
    assert got.shape == want.shape == (ts._band_plan.meta.nb, 144)
    gap = np.abs(got - want).max() / np.abs(want).max()
    print(f"assemble_band {config}: largest gap {gap:.2e}")
    assert gap <= (1e-6 if config == "mixed" else 1e-14)


def _numpy_rcs(ts, lin, lam):
    """The dense RCS in numpy from the port solver's own pieces (the JAX
    test's `_numpy_rcs`): (S [12N, 12N], b [12, N]) in f64."""
    hll_inv, hll_inv_bl = ts._hll_inv_u(lin.Jl, lin.r, None)
    hpp, b = ts._hpp_b_u(lin.Jp, lin.Jl, lin.r, hll_inv_bl)
    w = torch.einsum("kio,kjo->ijo", lin.Jp, lin.Jl)
    wl = torch.einsum("ijo,jko->iko", w, ts._gather_lm_x(
        linalg.cholesky_smallf(hll_inv))).double().numpy()  # [12, 3, O]
    cam, lm = ts.obs.cam.long().numpy(), ts.obs.lm.long().numpy()
    n, o = ts.n_cams, wl.shape[-1]
    a_mat = np.zeros((n * 12, ts.n_lms * 3))
    rows = cam[None, :] * 12 + np.arange(12)[:, None]  # [12, O]
    cols = lm[None, :] * 3 + np.arange(3)[:, None]  # [3, O]
    np.add.at(a_mat, (rows[:, None, :],
                      np.broadcast_to(cols[None], (12, 3, o))), wl)
    s_mat = -a_mat @ a_mat.T
    hpp_np = hpp.double().numpy()
    for i in range(n):
        s_mat[i * 12:(i + 1) * 12, i * 12:(i + 1) * 12] += (
            hpp_np[:, :, i] + lam * np.eye(12))
    return s_mat, b.double().numpy()


@pytest.mark.parametrize("config", ["mixed", "f64"])
def test_banded_increment_matches_numpy_rcs(problem, solvers, config):
    """The banded increment against numpy's dense solve of the same
    reduced camera system at lambda 1e-3: 5e-3 relative in f32 (the JAX
    package's test), 1e-9 in pure f64; 0 linear-solver iterations."""
    _js, ts = solvers[config]
    cams = torch.as_tensor(problem.cam_space)
    lin = ts.linearize(cams, ts.initialize_varproj(cams))
    lam = 1e-3
    inc, n_it = ts.solve_cholesky(lin, lam)
    assert n_it == 0 and inc.dtype == torch.float64
    s_mat, b = _numpy_rcs(ts, lin, float(ts._solve_scalar(lam)))
    want = -np.linalg.solve(s_mat, b.T.reshape(-1)).reshape(-1, 12).T
    got = inc.numpy()
    assert np.isfinite(got).all()
    gap = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"banded increment {config}: relative gap {gap:.2e}")
    assert gap <= (5e-3 if config == "mixed" else 1e-9)


@pytest.mark.parametrize("config", ["mixed", "f64"])
def test_band_residual_sees_the_coupling(problem, solvers, monkeypatch,
                                         config):
    """tools/large_scale.band_residual, the check chip_smoke.py makes of
    the banded increment where no dense route fits: ||S x - b|| / ||b||
    with S applied matrix-free is small for the banded increment
    (measured 2.0e-7 in f32, 5.5e-16 in f64; held to 2e-6 and 1e-13) and
    over 1000 times larger (7.3e-2) where the coupling blocks E_s
    between the two supernodes are dropped (e_idx pointed at the block
    table's zero block)."""
    from povar_tpu_torch.tools.large_scale import band_residual

    _js, ts = solvers[config]
    assert ts._band_plan.meta.S >= 2
    cams = torch.as_tensor(problem.cam_space)
    lin = ts.linearize(cams, ts.initialize_varproj(cams))
    good = band_residual(ts, lin, 1e-3)
    arrs, nb = ts._band_arrays, ts._band_plan.meta.nb
    monkeypatch.setattr(ts, "_band_arrays", arrs._replace(
        e_idx=torch.full_like(arrs.e_idx, 2 * nb)))
    bad = band_residual(ts, lin, 1e-3)
    print(f"band_residual {config}: {good:.2e}, coupling dropped {bad:.2e}")
    assert good <= (2e-6 if config == "mixed" else 1e-13)
    assert bad >= 1000 * good


@pytest.mark.parametrize("config", ["mixed", "f64"])
def test_step1_matches_jax(problem, solvers, config):
    """optimize_step1 over 6 CHOLESKY iterations on the banded route in
    both packages from the same numpy state: identical decisions and
    validity, 0 linear-solver iterations, costs within COST_RTOL."""
    js, ts = solvers[config]
    jo = _options(JaxOptions, config, max_num_iterations_step_1=ITERS)
    jsum = JaxSummary()
    jax_optimize_step1(js, jnp.asarray(problem.cam_space),
                       jnp.asarray(problem.lm_p), jo, jsum, JaxTimer(),
                       log=lambda s: None)
    to = _options(SolverOptions, config, max_num_iterations_step_1=ITERS)
    tsum = SolverSummary()
    optimize_step1(ts, torch.as_tensor(problem.cam_space),
                   torch.as_tensor(problem.lm_p), to, tsum, Timer(),
                   log=lambda s: None)
    assert len(tsum.iterations) == len(jsum.iterations) == ITERS + 1
    worst = 0.0
    for k, (t, j) in enumerate(zip(tsum.iterations, jsum.iterations)):
        assert t.step_is_successful == j.step_is_successful, k
        assert t.step_is_valid == j.step_is_valid, k
        assert t.linear_solver_iterations == j.linear_solver_iterations, k
        worst = max(worst, abs(t.cost.all.error - j.cost.all.error)
                    / abs(j.cost.all.error))
    print(f"step 1 {config}: decisions "
          f"{[it.step_is_successful for it in tsum.iterations]}, largest "
          f"cost gap {worst:.2e}")
    assert worst <= COST_RTOL[config]
    assert tsum.termination_type == jsum.termination_type


def test_pcg_fallback():
    """CHOLESKY on the JAX test's 4096-camera adversarial problem (no
    band within MAX_SUPERNODE, past DENSE_UNBANDED_MAX): the port warns
    the JAX package's "falling back to PCG" word for word, builds no
    plan, and solve_cholesky is solve_pcg bit for bit, with at least one
    CG iteration and a finite increment."""
    p = synthetic_bal_problem_adversarial(
        4096, 6000, mean_obs_per_lm=5.0, loop_closure_frac=0.3, seed=11)
    js, jw = _warned(lambda: jax_stage1.Stage1Solver(
        *_args(p), _options(JaxOptions, "mixed", pallas_kernels="off")))
    ts, tw = _warned(lambda: torch_stage1.Stage1Solver(
        *_args(p), _options(SolverOptions, "mixed"), device="cpu"))
    assert js._chol_pcg_fallback and ts._chol_pcg_fallback
    assert ts._band_plan is None and ts._band_arrays is None
    assert len(jw) == 1 and "falling back to PCG" in jw[0]
    assert tw == jw
    cams = torch.as_tensor(p.cam_space)
    lin = ts.linearize(cams, ts.initialize_varproj(cams))
    inc, n_it = ts.solve_cholesky(lin, 1e-4)
    want, n_want = ts.solve_pcg(lin, 1e-4)
    assert n_it == n_want >= 1
    assert torch.equal(inc, want)
    assert bool(torch.isfinite(inc).all())

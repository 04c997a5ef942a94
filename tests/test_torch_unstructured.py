"""Step 1 on the unstructured layout (`Lin1`: `pallas_kernels="off"`,
and CHOLESKY whatever that option says) of povar_tpu_torch against
povar_tpu's `pallas_kernels="off"` path, on one problem
(synthetic_bal_problem(n_cams=8, n_lms=60, obs_per_lm=5, seed=7)): the
VarProj initialization, one linearization field by field, one solve of
each step-1 solver (POWER_VARPROJ, POWER_SCHUR_COMPLEMENT, PCG with
SCHUR_JACOBI, CHOLESKY) from the same linearization, both applies, and
the 6-iteration LM trajectory of each solver; then, without JAX, the
unstructured layout against the structured one (`Lin1S`) in the port
itself, and the dense solve's answer to a matrix that is not positive
definite.

JAX side: Stage1Solver with pallas_kernels="off" and
device_lm_loop="off" (its camera side is a one-hot incidence matmul on
the CPU), one per solver, built once per module. Port side: the same
options on the CPU, where the camera-table kernels run their plain
versions (ops/cam_ref.py). Both packages evaluate the Jacobians and the
inner solve in f32 with sums in other orders, so outputs agree to f32
rounding amplified by the problem's conditioning; the tolerances are
relative to each output's largest magnitude and stated per test with
the gap measured here. Decisions and inner counts must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from povar_tpu.options import SolverOptions as JaxOptions
from povar_tpu.problem.synthetic import synthetic_bal_problem
from povar_tpu.solver.lm import optimize_step1 as jax_optimize_step1
from povar_tpu.solver.stage1 import Lin1 as JaxLin1
from povar_tpu.solver.stage1 import Stage1Solver as JaxStage1
from povar_tpu.utils.summary import SolverSummary as JaxSummary
from povar_tpu.utils.timer import Timer as JaxTimer
from povar_tpu_torch import (
    SolverOptions,
    SolverSummary,
    Stage1Solver,
    Timer,
    optimize_step1,
)
from povar_tpu_torch.ops import launches, linalg
from povar_tpu_torch.solver.stage1 import Lin1, Lin1S

# one torch thread a test process: the CPU tests' tensors are small,
# and a parallel run's xdist workers share the host's cores
torch.set_num_threads(1)

ITERS = 6
SOLVERS = ("POWER_VARPROJ", "POWER_SCHUR_COMPLEMENT", "PCG", "CHOLESKY")


def _options(cls, solver, **kw):
    opts = cls()
    opts.max_num_iterations_step_1 = ITERS
    opts.device_lm_loop = "off"
    opts.pallas_kernels = "off"
    opts.solver_type_step_1 = type(opts.solver_type_step_1)[solver]
    for k, v in kw.items():
        setattr(opts, k, v)
    return opts


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


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


@pytest.fixture(scope="module")
def solvers(problem):
    """(JAX solver, port solver) per step-1 solver, built on first use."""
    cache = {}

    def get(solver):
        if solver not in cache:
            js = JaxStage1(*_args(problem), _options(JaxOptions, solver))
            assert not js.use_pallas
            ts = Stage1Solver(*_args(problem), _options(SolverOptions, solver),
                              device="cpu")
            assert ts.unstructured and ts.e0_plan is None
            cache[solver] = (js, ts)
        return cache[solver]

    return get


@pytest.fixture(scope="module")
def lin_point(problem, solvers):
    """The VarProj-initialized state and JAX's linearization there (the
    POWER_VARPROJ storage, Jl scaled), with the same arrays as torch
    tensors."""
    js, _ts = solvers("POWER_VARPROJ")
    cams = jnp.asarray(problem.cam_space)
    lms = js.initialize_varproj(cams)
    jlin = js.linearize(cams, lms)
    assert isinstance(jlin, JaxLin1)
    tlin = Lin1(*[torch.as_tensor(np.array(v)) for v in jlin])
    return cams, lms, jlin, tlin


def test_initialize_varproj(problem, solvers):
    """The unstructured init in the state dtype (f64) from f64-gathered
    cameras, as JAX's. Measured gap 5.1e-16; tolerance 1e-12."""
    js, ts = solvers("POWER_VARPROJ")
    want = js.initialize_varproj(jnp.asarray(problem.cam_space))
    got = ts.initialize_varproj(torch.as_tensor(problem.cam_space))
    assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
    _close(got.numpy(), want, 1e-12)


def test_linearize(problem, solvers, lin_point):
    """One linearization at the same state, field by field. Measured
    gaps <= 1.4e-7; tolerance 1e-5. The landmark state stays canonical
    (lm_pack is the identity on this layout)."""
    _js, ts = solvers("POWER_VARPROJ")
    _cams, lms, jlin, _tlin = lin_point
    tlms = torch.as_tensor(np.array(lms))
    assert ts.lm_pack(tlms) is tlms
    tlin = ts.linearize(torch.as_tensor(problem.cam_space), tlms)
    assert isinstance(tlin, Lin1)
    for f in Lin1._fields:
        got, want = getattr(tlin, f), getattr(jlin, f)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("solver, lam, tol", [
    ("POWER_VARPROJ", 1e-4, 1e-4),
    ("POWER_SCHUR_COMPLEMENT", 1e-4, 1e-4),
    ("PCG", 1e-4, 1e-4),
    ("CHOLESKY", 1e-4, 1e-2),
    ("CHOLESKY", 1e-2, 1e-4),
])
def test_solve(solvers, lin_point, solver, lam, tol):
    """One solve of each step-1 solver from the same linearization: the
    same power-term or CG count (0 for CHOLESKY) and the increment within
    `tol`. The iterative solvers at lambda = 1e-4: measured 8.4e-6
    (POWER_VARPROJ, POWER_SCHUR_COMPLEMENT) and 2.4e-5 (PCG): f32
    rounding in another summation order, amplified by the reduced camera
    system's conditioning. CHOLESKY forms S = Hpp + lam I - A A^T
    explicitly in f32, a difference that loses digits as lambda falls:
    measured 1.3e-3 at lambda = 1e-4, 1.2e-5 at 1e-2."""
    js, ts = solvers(solver)
    _cams, _lms, jlin, tlin = lin_point
    jinc, jn = js.solve(jlin, jnp.asarray(lam))
    tinc, tn = ts.solve(tlin, lam)
    assert tn == int(jn)
    assert tinc.dtype == torch.float64 and tuple(tinc.shape) == jinc.shape
    _close(tinc.numpy(), jinc, tol)


@pytest.mark.parametrize("solver", ["POWER_VARPROJ", "POWER_SCHUR_COMPLEMENT"])
def test_apply(solvers, lin_point, solver):
    """The VarProj apply and the poBA apply (POWER_SCHUR_COMPLEMENT) of
    one increment: cameras equal bit for bit (the same f32 unscaling),
    landmarks within 1e-4 (measured 8.1e-6 VarProj, whose exact landmark
    step solves f32 normal equations of fresh Jacobians; 2.9e-8 poBA),
    l_diff within 1e-4 (measured <= 1.5e-7), and the f64 cost of the
    result within 1e-12 of JAX's unstructured f64 cost of the same
    state."""
    js, ts = solvers(solver)
    cams, lms, jlin, tlin = lin_point
    jinc, _ = js.solve(jlin, jnp.asarray(1e-4))
    tinc = torch.as_tensor(np.array(jinc))
    tcams, tlms = torch.as_tensor(np.array(cams)), torch.as_tensor(np.array(lms))
    if solver == "POWER_SCHUR_COMPLEMENT":
        jout = js.apply_poba(cams, lms, jlin, jinc, jnp.asarray(1e-4))
        tout = ts.apply_poba(tcams, tlms, tlin, tinc, 1e-4)
    else:
        jout = js.apply(cams, lms, jlin, jinc)
        tout = ts.apply(tcams, tlms, tlin, tinc)
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    assert tout[1].dtype == torch.float64
    _close(tout[1].numpy(), jout[1], 1e-4)
    assert tout[2].dtype == torch.float64 and tout[2].shape == ()
    _close(float(tout[2]), float(jout[2]), 1e-4)
    je = js.compute_error(jout[0], jout[1])
    te = ts.compute_error(torch.as_tensor(np.array(jout[0])),
                          torch.as_tensor(np.array(jout[1])))
    np.testing.assert_allclose(float(te["error_all"]),
                               float(je["error_all"]), rtol=1e-12)


@pytest.mark.parametrize("solver", SOLVERS)
def test_step1_trajectory_matches_jax(problem, solvers, solver):
    """optimize_step1 for six iterations in both packages from the same
    numpy problem: identical accept/reject decisions and inner counts;
    costs within 1e-3 (measured 6.7e-5 POWER_VARPROJ, 1.5e-4
    POWER_SCHUR_COMPLEMENT, 6.1e-4 PCG on its rejected trials, 8.4e-5
    CHOLESKY: f32 inner-solve rounding compounds over the accepted
    steps) and the lambda schedule within 1e-2 (measured <= 1.6e-5,
    except 1.5e-3 at CHOLESKY's last accepted step: the damping factor of
    a step whose quality is a ratio of two small differences)."""
    js, ts = solvers(solver)
    jsum = JaxSummary()
    jax_optimize_step1(js, jnp.asarray(problem.cam_space),
                       jnp.asarray(problem.lm_p), js.opts, jsum, JaxTimer(),
                       log=lambda s: None)
    tsum = SolverSummary()
    _out_cams, out_lms = optimize_step1(
        ts, torch.as_tensor(problem.cam_space), torch.as_tensor(problem.lm_p),
        ts.opts, tsum, Timer(), log=lambda s: None,
    )
    assert tuple(out_lms.shape) == (problem.num_landmarks, 3)
    assert len(tsum.iterations) == len(jsum.iterations) == ITERS + 1
    for t, j in zip(tsum.iterations, jsum.iterations):
        assert t.step_is_successful == j.step_is_successful
        assert t.step_is_valid == j.step_is_valid
        assert t.linear_solver_iterations == j.linear_solver_iterations
        np.testing.assert_allclose(t.cost.all.error, j.cost.all.error,
                                   rtol=1e-3)
        np.testing.assert_allclose(t.trust_region_radius,
                                   j.trust_region_radius, rtol=1e-2)
    assert tsum.solver_type == jsum.solver_type
    assert tsum.termination_type == jsum.termination_type


# ---- the port alone: the two layouts, and the dense solve


@pytest.mark.parametrize("solver", ["POWER_VARPROJ", "PCG"])
def test_layouts_agree(problem, solver):
    """The unstructured (`Lin1`) and structured (`Lin1S`) layouts of the
    port from one state: the same cost and the increment of one solve within 1e-4 of the structured one,
    with the same term or CG count (measured <= 4.6e-6). No JAX."""
    cams = torch.as_tensor(problem.cam_space)
    out = {}
    for off in (False, True):
        opts = _options(SolverOptions, solver,
                        pallas_kernels="off" if off else "auto")
        s = Stage1Solver(*_args(problem), opts, device="cpu")
        lms = s.lm_pack(s.initialize_varproj(cams))
        lin = s.linearize(cams, lms)
        assert isinstance(lin, Lin1 if off else Lin1S)
        out[off] = (float(s.compute_error(cams, lms)["error_all"]),
                    *s.solve(lin, 1e-4))
    (c_s, inc_s, n_s), (c_u, inc_u, n_u) = out[False], out[True]
    np.testing.assert_allclose(c_u, c_s, rtol=1e-12)
    assert n_u == n_s
    _close(inc_u.numpy(), inc_s.numpy(), 1e-4)


def test_cholesky_runs_under_auto(problem):
    """CHOLESKY takes the unstructured layout whatever pallas_kernels
    says, as in the JAX package (stage1.py:713-717)."""
    s = Stage1Solver(*_args(problem),
                     _options(SolverOptions, "CHOLESKY", pallas_kernels="auto"),
                     device="cpu")
    assert s.unstructured
    cams = torch.as_tensor(problem.cam_space)
    lin = s.linearize(cams, s.initialize_varproj(cams))
    inc, n = s.solve(lin, 1e-4)
    assert isinstance(lin, Lin1) and n == 0 and bool(torch.isfinite(inc).all())


def test_dense_solve_not_positive_definite():
    """solve_psd_dense returns the solution of an SPD system and all NaN
    for a matrix that is not positive definite (the JAX package's square
    root of a negative pivot), so the LM loop rejects the step."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((12, 12))
    spd = torch.as_tensor(a @ a.T + 12 * np.eye(12), dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal(12), dtype=torch.float32)
    x = linalg.solve_psd_dense(spd, b)
    _close((spd.double() @ x.double()).numpy(), b.numpy(), 1e-5)
    bad = spd.clone()
    bad[3, 3] = -1.0
    assert bool(torch.isnan(linalg.solve_psd_dense(bad, b)).all())


@pytest.mark.parametrize("argv, solver_type", [
    (["--solver-solver-type-step-1", "CHOLESKY"], "variable_projection"),
    (["--solver-pallas-kernels", "off"], "power_variable_projection"),
])
def test_cli_runs_unstructured(tmp_path, monkeypatch, argv, solver_type):
    """`python -m povar_tpu_torch.cli` with CHOLESKY and with
    `--solver-pallas-kernels off` on the committed BAL fixture (after
    --create-dataset, on the CPU): it exits 0 and logs the step-1 solver
    and accepted costs that fall, followed by step 2."""
    import json
    import os
    import shutil

    from povar_tpu_torch import cli

    name = "mini-bal-12-48-pre.txt"
    shutil.copy(os.path.join(os.path.dirname(__file__), "data", name),
                tmp_path / name)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        cli.main(["--input", name, "--create-dataset"])
    assert e.value.code in (0, None)
    assert cli.main(["--input", os.path.join("data_custom", name),
                     "--device", "cpu", *argv,
                     "--solver-max-num-iterations-step-1", "8",
                     "--solver-max-num-iterations-step-2", "4"]) == 0
    log = json.loads((tmp_path / "ba_log.json").read_text())
    assert log["solver1"]["solver_type"] == solver_type
    accepted = [it["cost"] for it in log["iterations1"]
                if it["step_is_successful"]]
    assert len(accepted) > 1
    assert all(b < a for a, b in zip(accepted, accepted[1:]))
    assert len(log["iterations"]) == 5

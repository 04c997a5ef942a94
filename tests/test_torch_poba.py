"""POWER_SCHUR_COMPLEMENT (PSC) in povar_tpu_torch against povar_tpu:
the two kernels of its apply, one trial from one linearization, the
step-1 LM trajectory and a short PSC + RIPOBA `bundle_adjust`.

Kernels: `poba_t3` and `apply_ldiff_stored` against the Pallas kernels
in interpret mode, on the O = 1024, N = 13 fixture of
tests/test_torch_pose_kernels.py (~5% dead rows), at that file's
tolerances relative to the largest magnitude: 1e-5 for the elementwise
t3, 1e-4 for the l_diff sum.

Solver: tests/test_torch_stage2.py's consistent geometry (12 ring
cameras, 80 landmarks, 4 observations each, 1e-3 measurement noise,
cameras and landmarks perturbed by 1e-2), where step 1 descends on every
step and step 2 settles near the noise floor from either package's
step-1 result; on synthetic_bal_problem(8, 60, 5, seed=7) PSC's step 1
leaves a state from which step 2 is chaotic (starts 0.7% apart after
four iterations, then diverging trajectories). JAX side: the Stage1Solver
with pallas_kernels="on" and device_lm_loop="off", built once per module
and shared by every test (its jitted trial is the costly part), and a
Stage2Solver for the pipeline; port side: the same options on the CPU,
where every kernel call runs its plain version. Decisions and power-term
counts must be identical; the tolerances of the costs and states are
stated per test with the gaps measured here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from povar_tpu.ops import pallas_pose as pp
from povar_tpu.options import SolverOptions as JaxOptions
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
    Timer,
    bundle_adjust,
    from_numpy,
    optimize_step1,
)
from povar_tpu_torch.ops import launches
from povar_tpu_torch.ops import pose_kernels as pk
from povar_tpu_torch.solver.slots import LmState
from povar_tpu_torch.solver.stage1 import Lin1S
from povar_tpu_torch.tools.step2_spread import ring_case

# one torch thread a test process: the CPU tests' tensors are small,
# and a parallel run's xdist workers share the host's cores
torch.set_num_threads(1)

ALPHA = 0.01
O, N, M = 1024, 13, 64
ITERS = 6


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
    assert all(v == 0 for v in launches.launch_counts().values())


@pytest.fixture(scope="module")
def prob():
    """The operands of the two kernels (tests/test_torch_pose_kernels.py's
    fixture: seeded numpy, dead rows zeroed in sw and r_w)."""
    rng = np.random.default_rng(7)
    f = np.float32
    cam = rng.integers(0, N, O).astype(np.int32)
    mask = (rng.uniform(size=O) > 0.05).astype(f)
    return dict(
        cam=cam,
        ct=rng.standard_normal((12, N)).astype(f),
        x=rng.standard_normal((3, O)).astype(f),
        uv=rng.standard_normal((2, O)).astype(f),
        sw=(rng.uniform(0.5, 1.0, (1, O)) * mask).astype(f),
        r_w=(rng.standard_normal((4, O)) * mask).astype(f),
        jls=rng.uniform(0.1, 1.0, (3, O)).astype(f),
        z=rng.standard_normal((12, N)).astype(f),
        inc_lm=rng.standard_normal((3, O)).astype(f),
    )


def test_poba_t3(prob):
    args = [prob[k] for k in ("cam", "ct", "x", "uv", "sw", "r_w", "jls",
                              "z")]
    want = pp.poba_t3(*map(jnp.asarray, args), alpha=ALPHA)
    got = pk.poba_t3(*map(torch.as_tensor, args), alpha=ALPHA)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, O)
    _close(got.numpy(), want, 1e-5)
    # dead rows give exactly zero
    dead = prob["sw"][0] == 0
    assert dead.any() and not got.numpy()[:, dead].any()


def test_apply_ldiff_stored(prob):
    args = [prob[k] for k in ("cam", "x", "uv", "sw", "r_w", "jls", "inc_lm",
                              "ct", "z")]
    want = float(np.asarray(
        pp.apply_ldiff_stored(*map(jnp.asarray, args), alpha=ALPHA),
        np.float64,
    ).sum())
    got = pk.apply_ldiff_stored(*map(torch.as_tensor, args), alpha=ALPHA)
    assert got.dtype == torch.float64 and got.shape == ()
    _close(float(got), want, 1e-4)


def _options(cls, **kw):
    opts = cls()
    opts.solver_type_step_1 = type(opts.solver_type_step_1)[
        "POWER_SCHUR_COMPLEMENT"]
    opts.max_num_iterations_step_1 = ITERS
    opts.device_lm_loop = "off"
    for k, v in kw.items():
        setattr(opts, k, v)
    return opts


@pytest.fixture(scope="module")
def geometry():
    """tests/test_torch_stage2.py's geometry (numpy, `ring_case`): the
    stage solvers' arguments and the initial cameras [N, 3, 4] and
    landmarks [M, 3]."""
    return ring_case()


@pytest.fixture(scope="module")
def solvers(geometry):
    """(JAX Stage1Solver, port Stage1Solver on the CPU), both PSC."""
    args = geometry[0]
    js = JaxStage1(*args, _options(JaxOptions, pallas_kernels="on"))
    assert js.use_pallas and js.scale_jl
    ts = Stage1Solver(*args, _options(SolverOptions), device="cpu")
    assert ts.poba and ts.scale_jl
    return js, ts


def _gap(got, want):
    """Largest absolute difference over the largest |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("lam", [1e-4, 1e2])
def test_solve_and_apply_poba(geometry, solvers, lam):
    """From JAX's linearization at the VarProj-initialized state: the
    port's landmark-damped power series (`solve`) and poBA apply
    (`apply_poba`) against the JAX trial, which runs the same two. The
    same number of power terms; the camera step (the increment unscaled),
    the landmarks, the model cost decrease l_diff and the cost decrease
    f_diff within 1e-4 (measured 3.4e-5, 7.0e-7, 1.3e-7 and 1.4e-7 at
    lambda 1e-4; 2.2e-7 and below at 1e2: f32 rounding in another order,
    amplified by the reduced camera system's conditioning, as in
    tests/test_torch_stage1.py); l_diff positive. The port's own trial
    gives exactly what its solve and apply give."""
    js, ts = solvers
    _args, cam0, _lm0 = geometry
    cams = jnp.asarray(cam0)
    lms = js.lm_pack(js.initialize_varproj(cams))
    jlin = js.linearize(cams, lms)
    tlin = Lin1S(*[torch.as_tensor(np.array(v)) for v in jlin])
    jnc, jnl, jok, jn, jld, jerr = js.trial(cams, lms, jlin,
                                            jnp.asarray(lam, jnp.float64))

    tcams = torch.as_tensor(cam0)
    tlms = LmState(torch.as_tensor(np.array(lms.rows)))
    inc, n = ts.solve(tlin, lam)
    assert n == int(jn) and bool(jok) and bool(torch.isfinite(inc).all())
    tnc, tnl, tld = ts.apply_poba(tcams, tlms, tlin, inc, lam)
    assert isinstance(tnl, LmState) and tnl.rows.dtype == torch.float64
    terr = ts.compute_error(tnc, tnl)
    c0 = float(ts.compute_error(tcams, tlms)["error_all"])
    gaps = dict(
        cams=_gap(tnc.numpy() - cam0, np.asarray(jnc) - cam0),
        lms=_gap(tnl.rows.numpy(), jnl.rows),
        l_diff=_gap(float(tld), float(jld)),
        f_diff=_gap(c0 - float(terr["error_all"]),
                    c0 - float(jerr["error_all"])),
    )
    print(f"lambda {lam:g}: terms {n}, gaps {gaps}")
    assert all(g <= 1e-4 for g in gaps.values()), gaps
    assert float(tld) > 0

    c2, l2, ok2, n2, ld2, err2 = ts.trial(tcams, tlms, tlin, lam)
    assert bool(ok2) and n2 == n
    assert torch.equal(c2, tnc) and torch.equal(l2.rows, tnl.rows)
    assert float(ld2) == float(tld)
    assert float(err2["error_all"]) == float(terr["error_all"])


def _trajectory(summary):
    return [
        (it.step_is_successful, it.step_is_valid,
         it.linear_solver_iterations,
         it.cost.all.error if it.cost is not None else None)
        for it in summary.iterations
    ]


def _same_trajectory(ta, tb, tol):
    """Identical decisions and inner counts, every cost within `tol`
    relative; returns the largest relative cost gap."""
    assert len(ta) == len(tb)
    worst = 0.0
    for a, b in zip(ta, tb):
        assert a[:3] == b[:3], (ta, tb)
        if a[3] is None or b[3] is None:
            assert a[3] is b[3] is None, (ta, tb)
            continue
        worst = max(worst, abs(a[3] - b[3]) / abs(b[3]))
    assert worst <= tol, (worst, ta, tb)
    return worst


def test_psc_step1_trajectory_matches_jax(geometry, solvers):
    """optimize_step1 with PSC for six iterations in both packages from
    the same numpy state: identical accept/reject decisions and power-term
    counts (AAAAAA, [0, 1, 1, 10, 10, 10, 10]); every cost within 1e-4
    relative (measured 8.1e-5 after the first step, whose cost is 815x
    below the start, so that f32 rounding of the step shows at 1e-7 of
    the start; 2.7e-7 after it) and the lambda schedule within 1e-4
    (measured 0: every accepted step's relative decrease takes the
    damping factor to its floor of 1/3)."""
    js, ts = solvers
    _args, cam0, lm0 = geometry
    jsum = JaxSummary()
    jax_optimize_step1(js, jnp.asarray(cam0), jnp.asarray(lm0), js.opts,
                       jsum, JaxTimer(), log=lambda s: None)
    tsum = SolverSummary()
    out_cams, out_lms = optimize_step1(
        ts, torch.as_tensor(cam0), torch.as_tensor(lm0), ts.opts, tsum,
        Timer(), log=lambda s: None,
    )
    assert tuple(out_lms.shape) == lm0.shape
    ta, tb = _trajectory(tsum), _trajectory(jsum)
    assert len(ta) == ITERS + 1
    worst = _same_trajectory(ta, tb, 1e-4)
    radius = max(abs(t.trust_region_radius - j.trust_region_radius)
                 / j.trust_region_radius
                 for t, j in zip(tsum.iterations, jsum.iterations))
    print(f"PSC step 1 {[t[:3] for t in ta]}: cost gap {worst:.2e}, "
          f"radius gap {radius:.2e}")
    assert radius <= 1e-4
    assert tsum.solver_type == jsum.solver_type == "bal_power_sc"
    assert tsum.termination_type == jsum.termination_type


def test_psc_ripoba_bundle_adjust_matches_jax(geometry, solvers):
    """`bundle_adjust` with PSC for 4 step-1 and RIPOBA for 4 step-2
    iterations against the JAX package's pipeline on the same problem
    (its bundle_adjust body without a mesh: optimize_step1,
    create_homogeneous, optimize_step2, here with the module's step-1
    solver): identical decisions and power-term counts in both steps;
    every cost within 1e-4 relative (measured 8.1e-5 in step 1, as in the
    trajectory test, and 2.5e-6 in step 2, which ends near the noise
    floor from either package's step-1 result)."""
    js, _ts = solvers
    args, cam0, lm0 = geometry
    opts = dict(max_num_iterations_step_1=4, max_num_iterations_step_2=4)
    jo = _options(JaxOptions, pallas_kernels="on", **opts)
    jsum1, jsum2 = JaxSummary(), JaxSummary()
    timer = JaxTimer()
    jc, jl = jax_optimize_step1(js, jnp.asarray(cam0), jnp.asarray(lm0), jo,
                                jsum1, timer, log=lambda s: None)
    jc, jl = jax_create_homogeneous(jc, jl)
    js2 = JaxStage2(*args, jo)
    assert js2.use_pallas
    jax_optimize_step2(js2, jc, jl, jo, jsum2, timer, log=lambda s: None)

    tp, _c, _l = from_numpy(*args[:3], cam0, lm0, device="cpu")
    out, t1, t2 = bundle_adjust(tp, _options(SolverOptions, **opts),
                                log=lambda s: None, device="cpu")
    g1 = _same_trajectory(_trajectory(t1), _trajectory(jsum1), 1e-4)
    g2 = _same_trajectory(_trajectory(t2), _trajectory(jsum2), 1e-4)
    print(f"PSC + RIPOBA: step-1 gap {g1:.2e}, step-2 gap {g2:.2e}")
    assert t1.solver_type == jsum1.solver_type == "bal_power_sc"
    assert t2.solver_type == jsum2.solver_type == "riemannian_ripoba"
    assert out is tp and out.lm_p_h.shape == (args[4], 4)
    assert np.isfinite(out.cam_space).all() and np.isfinite(out.lm_p).all()


def test_cli_runs_psc(tmp_path, monkeypatch):
    """`python -m povar_tpu_torch.cli --solver-solver-type-step-1
    POWER_SCHUR_COMPLEMENT` on the committed BAL fixture (after
    --create-dataset, on the CPU): it exits 0 and logs a PSC step 1
    (`bal_power_sc`) whose accepted costs fall, followed by step 2."""
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
                     "--device", "cpu",
                     "--solver-solver-type-step-1", "POWER_SCHUR_COMPLEMENT",
                     "--solver-max-num-iterations-step-1", "8",
                     "--solver-max-num-iterations-step-2", "4"]) == 0
    log = json.loads((tmp_path / "ba_log.json").read_text())
    assert log["solver1"]["solver_type"] == "bal_power_sc"
    accepted = [it["cost"] for it in log["iterations1"]
                if it["step_is_successful"]]
    assert len(accepted) > 1
    assert all(b < a for a, b in zip(accepted, accepted[1:]))
    assert len(log["iterations"]) == 5

"""The f32 LM state of povar_tpu_torch against povar_tpu: the camera
gather kernel (`cam_gather`), the residual and robust-cost math of the
f32 cost (ops/pose_math.py), `compute_error` of both stages, and short
step-1 and step-2 trajectories with `dtype=float32`.

JAX side: the stage solvers with dtype=float32, pallas_kernels="on" (the
Pallas kernels in interpret mode, among them pallas_cam.cam_gather in the
cost) and device_lm_loop="off", built once per module; port side: the
same on the CPU, where every kernel call runs its plain version. With an
f32 state both packages solve in f32 and evaluate the cost in f32 off
the double-float route (stage1.py:1240-1259, stage2.py:477-494 of the
JAX package). The JAX package's own f32 test (tests/test_f32.py) runs
pallas_kernels="auto", which off the TPU is its unstructured path, so
these are the first tests of its f32 structured path too.

Problem: tests/test_torch_stage2.py's consistent geometry (12 ring
cameras, 80 landmarks, 4 observations each, 1e-3 measurement noise,
cameras and landmarks perturbed by 1e-2). Costs are f32 sums over 320
rows in another order, so equal states give costs about 1e-6 apart
(measured below); decisions and power-term counts must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from povar_tpu.ops import pallas_cam
from povar_tpu.ops import pose_math as jax_pose_math
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
    Stage2Solver,
    Timer,
    create_homogeneous,
    optimize_step1,
    optimize_step2,
)
from povar_tpu_torch.ops import cam_kernels, launches, pose_math
from povar_tpu_torch.tools.step2_spread import ring_case

# one torch thread a test process: the CPU tests' tensors are small,
# and a parallel run's xdist workers share the host's cores
torch.set_num_threads(1)

ITERS = 6
F32 = torch.float32
ERR_KEYS = ("error_all", "residual_sum_all", "error_valid",
            "residual_sum_valid")
COUNT_KEYS = ("num_obs_all", "num_obs_valid", "is_numerically_valid")


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors go to the plain versions: no kernel launch counted."""
    launches.reset_launch_counts()
    yield
    assert all(v == 0 for v in launches.launch_counts().values())


@pytest.mark.parametrize("n_cams", [7, 89])
def test_cam_gather_is_exact(n_cams):
    """table[:, cam[o]] bit for bit, like the JAX kernel (whose one-hot
    matmul is exact through its bf16 3-way split) and numpy, on entries
    of both signs from 1e-8 to 1e8."""
    rng = np.random.default_rng(n_cams)
    table = (rng.choice([-1.0, 1.0], (12, n_cams))
             * 10.0 ** rng.uniform(-8, 8, (12, n_cams))).astype(np.float32)
    cam = rng.integers(0, n_cams, 1024).astype(np.int32)
    want = np.asarray(pallas_cam.cam_gather(jnp.asarray(table),
                                            jnp.asarray(cam)))
    np.testing.assert_array_equal(want, table[:, cam])
    got = cam_kernels.cam_gather(torch.as_tensor(table), torch.as_tensor(cam))
    assert got.dtype == F32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_residuals_and_validity_threshold(dtype):
    """pose_math against the JAX package's: the pOSE residual, the
    homogeneous residual and its validity mask, whose |z| threshold is
    sqrt(1e-5) for f32 but 1e-5 for f64 (Sophus epsilonSqrt): depths
    between the two are valid only in f64. Residuals within 1e-6 (f32)
    and 1e-13 (f64) of the largest, masks identical."""
    rng = np.random.default_rng(5)
    o = 512
    P = rng.standard_normal((3, 4, o)).astype(dtype)
    x = rng.standard_normal((3, o)).astype(dtype)
    uv = rng.standard_normal((2, o)).astype(dtype)
    xh = np.concatenate([x, np.ones((1, o), dtype)])
    # depths p2 = P[2] . xh from 1e-6 to 1e-1 in magnitude
    z = rng.choice([-1.0, 1.0], o) * 10.0 ** rng.uniform(-6, -1, o)
    P[2, 3] = (z - (P[2, :3] * x).sum(axis=0)).astype(dtype)
    tol = 1e-6 if dtype == np.float32 else 1e-13

    def close(got, want):
        want = np.asarray(want, np.float64)
        err = np.abs(got.numpy().astype(np.float64) - want).max()
        assert err <= tol * np.abs(want).max(), err

    t = [torch.as_tensor(a) for a in (P, x, uv, xh)]
    close(pose_math.pose_residual_t(t[0], t[1], t[2], 0.01),
          jax_pose_math.pose_residual_t(jnp.asarray(P), jnp.asarray(x),
                                        jnp.asarray(uv), 0.01))
    r, valid = pose_math.homogeneous_residual_t(t[0], t[3], t[2])
    jr, jvalid = jax_pose_math.homogeneous_residual_t(
        jnp.asarray(P), jnp.asarray(xh), jnp.asarray(uv))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    between = (np.abs(z) >= 1e-5) & (np.abs(z) < np.sqrt(1e-5))
    assert between.any()
    assert valid.numpy()[between].all() == (dtype == np.float64)
    live = np.array(jvalid)
    close(r[:, torch.as_tensor(live)], np.asarray(jr)[:, live])


@pytest.mark.parametrize("robust", [0, 1, 2], ids=["none", "huber", "cauchy"])
def test_robust_error_and_weight(robust):
    """The robust cost and weight of both packages, f32, on squared
    residuals from 1e-6 to 1e4 around the Huber threshold 1: within 1e-6
    relative."""
    res_sq = (10.0 ** np.random.default_rng(robust).uniform(-6, 4, 256)
              ).astype(np.float32)
    got = pose_math.robust_error_and_weight(torch.as_tensor(res_sq), robust,
                                            1.0)
    want = jax_pose_math.robust_error_and_weight(jnp.asarray(res_sq), robust,
                                                 1.0)
    for g, w in zip(got, want):
        assert g.dtype == F32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


@pytest.fixture(scope="module")
def geometry():
    """tests/test_torch_stage2.py's geometry (numpy, `ring_case`): the
    stage solvers' arguments and the initial cameras [N, 3, 4] and
    landmarks [M, 3]."""
    return ring_case()


def _options(cls, **kw):
    opts = cls()
    opts.max_num_iterations_step_1 = ITERS
    opts.max_num_iterations_step_2 = ITERS
    opts.device_lm_loop = "off"
    for k, v in kw.items():
        setattr(opts, k, v)
    return opts


@pytest.fixture(scope="module")
def solvers(geometry):
    """{step: (JAX solver, port solver on the CPU)}, both f32 states
    with SolverOptions() defaults."""
    args = geometry[0]
    jo = _options(JaxOptions, pallas_kernels="on")
    out = {}
    for step, jcls, tcls in ((1, JaxStage1, Stage1Solver),
                             (2, JaxStage2, Stage2Solver)):
        js = jcls(*args, jo, dtype=jnp.float32)
        assert js.use_pallas and js.solve_dtype == jnp.float32
        ts = tcls(*args, _options(SolverOptions), dtype=F32, device="cpu")
        out[step] = js, ts
    return out


def _states(geometry, step, dtype):
    """The initial state of `step` in dtype: step 1 the perturbed cameras
    and landmarks, step 2 their homogenized (create_homogeneous) form."""
    _args, cam0, lm0 = geometry
    if dtype is jnp.float32:
        c, l = jnp.asarray(cam0, dtype), jnp.asarray(lm0, dtype)
        return (c, l) if step == 1 else jax_create_homogeneous(c, l)
    c, l = torch.as_tensor(cam0, dtype=dtype), torch.as_tensor(lm0, dtype=dtype)
    return (c, l) if step == 1 else create_homogeneous(c, l)


@pytest.mark.parametrize("step", [1, 2])
def test_compute_error_f32(geometry, solvers, step):
    """compute_error of the same f32 state (the JAX package's f32 state,
    handed to both): every count and the validity flag exactly, the f32
    cost and residual sums within 1e-5 relative (measured 7.4e-7 for the
    step-2 cost, 1.5e-7 for its residual sum, 0 and 1.0e-7 in step 1:
    320 f32 terms summed in another order)."""
    js, ts = solvers[step]
    jc, jl = _states(geometry, step, jnp.float32)
    want = js.compute_error(jc, jl)
    got = ts.compute_error(torch.as_tensor(np.array(jc)),
                           torch.as_tensor(np.array(jl)))
    for k in ERR_KEYS:
        assert got[k].dtype == F32, k
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    for k in COUNT_KEYS:
        assert int(got[k]) == int(want[k]), k
    assert int(got["num_obs_valid"]) == 320


def _trajectory(summary):
    return [
        (it.step_is_successful, it.step_is_valid,
         it.linear_solver_iterations,
         it.cost.all.error if it.cost is not None else None,
         it.trust_region_radius)
        for it in summary.iterations
    ]


@pytest.mark.parametrize("step", [1, 2])
def test_f32_trajectory_matches_jax(geometry, solvers, step):
    """optimize_step1 (POWER_VARPROJ) or optimize_step2 (RIPOBA) for six
    iterations from the same f32 state: identical decisions and power-term
    counts, every cost within 1e-4 relative (measured 8.4e-5 after step
    1's first step, whose cost is 875x below the start, and at most
    3.4e-7 after it; 3.1e-6 in step 2) and the lambda schedule within 1e-4
    (measured 3.1e-5). The f32 state stays f32."""
    js, ts = solvers[step]
    jax_opt = jax_optimize_step1 if step == 1 else jax_optimize_step2
    opt = optimize_step1 if step == 1 else optimize_step2
    jsum, tsum = JaxSummary(), SolverSummary()
    jax_opt(js, *_states(geometry, step, jnp.float32), js.opts, jsum,
            JaxTimer(), log=lambda s: None)
    out = opt(ts, *_states(geometry, step, F32), ts.opts, tsum, Timer(),
              log=lambda s: None)
    assert all(t.dtype == F32 for t in out)
    ta, tb = _trajectory(tsum), _trajectory(jsum)
    assert len(ta) == len(tb) == ITERS + 1
    worst = 0.0
    for a, b in zip(ta, tb):
        assert a[:3] == b[:3], (ta, tb)
        assert a[3] is not None and b[3] is not None, (ta, tb)
        worst = max(worst, abs(a[3] - b[3]) / b[3])
        np.testing.assert_allclose(a[4], b[4], rtol=1e-4)
    print(f"f32 step {step} {[t[:3] for t in ta]}: cost gap {worst:.2e}")
    assert worst <= 1e-4, (ta, tb)
    assert tsum.termination_type == jsum.termination_type
    assert tsum.solver_type == jsum.solver_type

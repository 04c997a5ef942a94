"""Pure f64 (`mixed_precision_solves=False` with an f64 LM state, one
device) of povar_tpu_torch against povar_tpu's pure f64, step by step.

The JAX package runs pure f64 on its unstructured XLA layout whatever
`pallas_kernels` says, except "on", which raises ValueError
(povar_tpu/solver/stage1.py:675-710, stage2.py:150-180): f64 Jacobians,
f64 one-hot camera sums and gathers, f64 inner solves and the f64 Jacobi
epsilon (1e-5). The port runs the same configuration on its unstructured
layout (`Lin1` / `Lin2`) with f64 solves; on the CPU its camera-table
kernels run their plain versions (ops/cam_ref.py) in f64.

Step 1 runs synthetic_bal_problem(n_cams=8, n_lms=60, obs_per_lm=5,
seed=7) with each of POWER_VARPROJ, POWER_SCHUR_COMPLEMENT, PCG
(SCHUR_JACOBI) and CHOLESKY for 8 iterations; step 2 runs `ring_case`
(tools/step2_spread.py) from one homogenized state with RIPOBA and
RIPCG. Every input comes from one seed through numpy. The checks are
the Eigen harness test's (tests/test_reference_parity.py:150-178):
identical decisions, validity, power-term and CG counts; costs within
1e-10 relative, trust radii within 1e-9 and the final states within
1e-8 absolute. Measured here: costs <= 1.5e-11 (CHOLESKY; the others
<= 9.4e-13), trust radii <= 1.5e-10, states <= 3.5e-10 (the summation
orders of the two packages' f64 sums differ).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from povar_tpu.options import SolverOptions as JaxOptions
from povar_tpu.problem.synthetic import synthetic_bal_problem
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
from povar_tpu_torch.ops import launches
from povar_tpu_torch.solver.stage1 import Lin1
from povar_tpu_torch.solver.stage2 import Lin2
from povar_tpu_torch.tools.step2_spread import ring_case

# one torch thread a test process: the CPU tests' tensors are small,
# and a parallel run's xdist workers share the host's cores
torch.set_num_threads(1)

ITERS = 8
COST_RTOL, RADIUS_RTOL, STATE_ATOL = 1e-10, 1e-9, 1e-8


def _options(cls, **kw):
    """Pure f64 with the host LM loop, `kw` on top (solver types by
    name)."""
    opts = cls()
    opts.mixed_precision_solves = False
    opts.device_lm_loop = "off"
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


def _check_trajectory(tsum, jsum):
    """The Eigen test's checks of one step's records."""
    assert len(tsum.iterations) == len(jsum.iterations) > 2
    for k, (t, j) in enumerate(zip(tsum.iterations, jsum.iterations)):
        assert t.step_is_successful == j.step_is_successful, k
        assert t.step_is_valid == j.step_is_valid, k
        assert t.linear_solver_iterations == j.linear_solver_iterations, k
        np.testing.assert_allclose(t.cost.all.error, j.cost.all.error,
                                   rtol=COST_RTOL, err_msg=str(k))
        np.testing.assert_allclose(t.trust_region_radius,
                                   j.trust_region_radius, rtol=RADIUS_RTOL,
                                   err_msg=str(k))
    assert tsum.termination_type == jsum.termination_type
    assert tsum.solver_type == jsum.solver_type


@pytest.mark.parametrize("solver", ["POWER_VARPROJ", "POWER_SCHUR_COMPLEMENT",
                                    "PCG", "CHOLESKY"])
def test_step1_matches_jax(problem, solver):
    """optimize_step1 for 8 iterations in both packages' pure f64 from
    the same numpy state: the unstructured layout with f64 storage and
    solves and the f64 Jacobi epsilon, and the trajectory and final
    state within the Eigen test's tolerances."""
    jo = _options(JaxOptions, solver_type_step_1=solver,
                  max_num_iterations_step_1=ITERS)
    js = JaxStage1(*_args(problem), jo)
    assert not js.use_pallas and js.solve_dtype == jnp.float64
    jsum = JaxSummary()
    jc, jl = jax_optimize_step1(js, jnp.asarray(problem.cam_space),
                                jnp.asarray(problem.lm_p), jo, jsum,
                                JaxTimer(), log=lambda s: None)
    to = _options(SolverOptions, solver_type_step_1=solver,
                  max_num_iterations_step_1=ITERS)
    ts = Stage1Solver(*_args(problem), to, device="cpu")
    assert ts.unstructured and ts.solve_dtype == torch.float64
    assert ts.jacobi_eps == js.jacobi_eps == 1e-5
    cams = torch.as_tensor(problem.cam_space)
    lin = ts.linearize(cams, ts.initialize_varproj(cams))
    assert isinstance(lin, Lin1)
    assert all(t.dtype == torch.float64 for t in lin)
    tsum = SolverSummary()
    tc, tl = optimize_step1(ts, cams, torch.as_tensor(problem.lm_p), to,
                            tsum, Timer(), log=lambda s: None)
    _check_trajectory(tsum, jsum)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=STATE_ATOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=STATE_ATOL)


@pytest.mark.parametrize("step2", ["RIPOBA", "RIPCG"])
def test_step2_matches_jax(step2):
    """optimize_step2 for up to 8 iterations in both packages' pure f64
    from one homogenized `ring_case` state: f64 tangent storage, and the
    trajectory and final state within the Eigen test's tolerances
    (measured: costs <= 6.4e-15, radii equal, states <= 1.8e-15)."""
    args, cam0, lm0 = ring_case()
    jo = _options(JaxOptions, solver_type_step_2=step2,
                  max_num_iterations_step_2=ITERS)
    js = JaxStage2(*args, jo)
    assert not js.use_pallas and js.solve_dtype == jnp.float64
    jsum = JaxSummary()
    jc, jl = jax_optimize_step2(js, *jax_create_homogeneous(
        jnp.asarray(cam0), jnp.asarray(lm0)), jo, jsum, JaxTimer(),
        log=lambda s: None)
    to = _options(SolverOptions, solver_type_step_2=step2,
                  max_num_iterations_step_2=ITERS)
    ts = Stage2Solver(*args, to, device="cpu")
    assert ts.unstructured and ts.solve_dtype == torch.float64
    assert ts.jacobi_eps == js.jacobi_eps == 1e-5
    tc, tl = create_homogeneous(torch.as_tensor(cam0), torch.as_tensor(lm0))
    lin = ts.linearize(tc, tl)
    assert isinstance(lin, Lin2)
    assert all(t.dtype == torch.float64 for t in lin)
    tsum = SolverSummary()
    tc, tl = optimize_step2(ts, tc, tl, to, tsum, Timer(),
                            log=lambda s: None)
    _check_trajectory(tsum, jsum)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=STATE_ATOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=STATE_ATOL)


@pytest.mark.parametrize("step", [1, 2])
def test_pallas_on_raises_as_in_jax(problem, step):
    """pallas_kernels="on" in pure f64 raises ValueError in both packages,
    with the same message: the kernels need f32 inner solves."""
    jcls, tcls = ((JaxStage1, Stage1Solver) if step == 1
                  else (JaxStage2, Stage2Solver))
    with pytest.raises(ValueError) as jerr:
        jcls(*_args(problem), _options(JaxOptions, pallas_kernels="on"))
    with pytest.raises(ValueError) as terr:
        tcls(*_args(problem), _options(SolverOptions, pallas_kernels="on"),
             device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert "f32 inner solves required" in str(terr.value)


@pytest.mark.parametrize("mode", ["auto", "off"])
def test_pure_f64_takes_the_unstructured_layout(problem, mode):
    """Pure f64 runs the unstructured layout under "auto" and "off", with
    no fused-term plan; an f32 state solves in f32 whichever the option,
    and mixed precision keeps the structured layout under "auto"."""
    for cls in (Stage1Solver, Stage2Solver):
        s = cls(*_args(problem), _options(SolverOptions, pallas_kernels=mode),
                device="cpu")
        assert s.unstructured and s.e0_plan is None
        assert s.solve_dtype == torch.float64
        assert s._uv_s.dtype == torch.float64
        assert s._mask1.dtype == torch.float32  # the kernels' row gate
        f32 = cls(*_args(problem), _options(SolverOptions,
                                            pallas_kernels=mode),
                  dtype=torch.float32, device="cpu")
        assert f32.solve_dtype == torch.float32
        assert f32.unstructured == (mode == "off")
        mixed = cls(*_args(problem), SolverOptions(pallas_kernels=mode),
                    device="cpu")
        assert mixed.solve_dtype == torch.float32
        assert mixed.unstructured == (mode == "off")

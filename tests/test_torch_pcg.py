"""PCG and RIPCG of povar_tpu_torch against povar_tpu.

The CG loop itself (`solver/pcg.py:conjugate_gradients`, a host loop
with one synchronisation per iteration) against the JAX package's
`lax.while_loop` on small dense systems: every exit of the reference
(q-tolerance after `min_iterations`, r-tolerance, the residual refresh,
the FAILURE that keeps the previous iterate, |b| = 0, the initial
r-tolerance exit), with identical iteration counts and termination codes
and iterates within 1e-5 of the largest entry (f32 dots in another
order; measured <= 3.6e-7).

Then `solve_pcg` of both stage solvers under the three preconditioners
from one linearization fed to both packages (the JAX side with the
Pallas kernels in interpret mode): the same CG iteration counts and the

# one torch thread a test process: the CPU tests' tensors are small,
# and a parallel run's xdist workers share the host's cores
torch.set_num_threads(1)
increment within 1e-4 of its largest entry (measured in each test's
docstring). These run the composed power term, whose interpret-mode
kernels cost a quarter of the fused one's; PCG and RIPCG with the fused
term (SolverOptions() defaults) run whole trajectories in
tests/test_torch_stage1.py and tests/test_torch_stage2.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from povar_tpu.options import PreconditionerType as JaxPT
from povar_tpu.options import SolverOptions as JaxOptions
from povar_tpu.options import SolverType as JaxST
from povar_tpu.options import SolverTypeRiemannian as JaxSTR
from povar_tpu.problem.synthetic import _ring_cameras, synthetic_bal_problem
from povar_tpu.solver import pcg as jax_pcg
from povar_tpu.solver.stage1 import Stage1Solver as JaxStage1
from povar_tpu.solver.stage2 import Stage2Solver as JaxStage2
from povar_tpu.solver.stage2 import create_homogeneous as jax_homogeneous
from povar_tpu_torch import SolverOptions, Stage1Solver, Stage2Solver
from povar_tpu_torch.options import (
    PreconditionerType,
    SolverType,
    SolverTypeRiemannian,
)
from povar_tpu_torch.solver import pcg
from povar_tpu_torch.solver.stage1 import Lin1S
from povar_tpu_torch.solver.stage2 import Lin2S


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _system(n, seed, indefinite=False):
    """A [n, n] f32 system with a spectrum spread over [0.3, 3], its
    right-hand side and the inverse of its diagonal (a Jacobi
    preconditioner). The condition number stays at 10: at 1e4, f32
    rounding in another summation order changes the iteration counts of
    the two packages (measured 32 against 45 without a preconditioner),
    which says nothing about the loop's logic."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    ev = np.geomspace(0.3, 3.0, n)
    if indefinite:
        ev[:: 3] *= -1.0
    a = ((q * ev) @ q.T).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    return a, b, (1.0 / np.diag(a)).astype(np.float32)


CG_CASES = {
    # name: (system kwargs, conjugate_gradients kwargs, precondition)
    "q_tolerance": (dict(seed=0), dict(max_iterations=200), True),
    "identity": (dict(seed=1), dict(max_iterations=200), False),
    "refresh": (dict(seed=2), dict(max_iterations=40, q_tolerance=1e-6,
                                    residual_reset_period=3), True),
    "r_tolerance": (dict(seed=3), dict(max_iterations=200, q_tolerance=0.0,
                                        r_tolerance=1e-3), True),
    "min_iterations": (dict(seed=4), dict(max_iterations=200,
                                           min_iterations=25), True),
    "max_iterations": (dict(seed=5), dict(max_iterations=4,
                                           q_tolerance=1e-9), True),
    "indefinite": (dict(seed=6, indefinite=True),
                   dict(max_iterations=200, q_tolerance=1e-9), False),
    "zero_b": (dict(seed=7), dict(max_iterations=200), True),
    "initial_r_tolerance": (dict(seed=8), dict(max_iterations=200,
                                                r_tolerance=1e9), True),
}


@pytest.mark.parametrize("case", list(CG_CASES))
def test_conjugate_gradients_matches_jax(case):
    sys_kw, kw, precondition = CG_CASES[case]
    a, b, invd = _system(24, **sys_kw)
    if case == "zero_b":
        b = np.zeros_like(b)
    ja, jb, jd = (jnp.asarray(v) for v in (a, b, invd))
    res = jax_pcg.conjugate_gradients(
        lambda v: ja @ v, jb, jnp.zeros_like(jb),
        (lambda v: jd * v) if precondition else (lambda v: v), **kw,
    )
    ta, tb, td = (torch.as_tensor(v) for v in (a, b, invd))
    x, n_iter, term = pcg.conjugate_gradients(
        lambda v: ta @ v, tb, torch.zeros_like(tb),
        (lambda v: td * v) if precondition else (lambda v: v), **kw,
    )
    assert (n_iter, term) == (int(res.num_iterations), int(res.termination))
    if case == "zero_b":
        assert n_iter == 0 and not bool(x.any())
    elif case == "indefinite":
        assert term == pcg.FAILURE
    elif case == "initial_r_tolerance":
        assert n_iter == 0
    else:
        assert n_iter > (1 if case != "max_iterations" else 3)
        _close(x.numpy(), res.x, 1e-5)


PRECONDITIONERS = ("SCHUR_JACOBI", "JACOBI", "IDENTITY")


def _options(cls, st, pt_cls, pt, **kw):
    opts = cls(device_lm_loop="off", fused_power_term=False, **kw)
    opts.preconditioner_type = pt_cls[pt]
    if cls is JaxOptions:
        opts.pallas_kernels = "on"
        if st == 1:
            opts.solver_type_step_1 = JaxST.PCG
        else:
            opts.solver_type_step_2 = JaxSTR.RIPCG
    elif st == 1:
        opts.solver_type_step_1 = SolverType.PCG
    else:
        opts.solver_type_step_2 = SolverTypeRiemannian.RIPCG
    return opts


@pytest.fixture(scope="module")
def step1_problem():
    """tests/test_torch_stage1.py's parity problem."""
    return synthetic_bal_problem(n_cams=8, n_lms=60, obs_per_lm=5, seed=7)[0]


@pytest.mark.parametrize("pt", PRECONDITIONERS)
def test_step1_solve_pcg_matches_jax(step1_problem, pt):
    """One PCG solve from JAX's linearization at the VarProj-initialized
    state (Jl unscaled, as the reference's PCG linearizes): the same CG
    iteration count and the increment within 1e-4 (measured <= 2.1e-6)."""
    p = step1_problem
    args = (p.obs_cam, p.obs_lm, p.obs_uv, p.num_cameras, p.num_landmarks)
    js = JaxStage1(*args, _options(JaxOptions, 1, JaxPT, pt))
    ts = Stage1Solver(*args, _options(SolverOptions, 1, PreconditionerType,
                                      pt), device="cpu")
    assert js._e0_meta is None and ts.e0_plan is None
    assert not js.scale_jl and not ts.scale_jl
    cams = jnp.asarray(p.cam_space)
    lin = js.linearize(cams, js.lm_pack(js.initialize_varproj(cams)))
    tlin = Lin1S(*[torch.as_tensor(np.array(v)) for v in lin])
    assert bool((tlin.jl_scale == 1).all())
    for lam in (1e-4, 1e2):
        jinc, jn = js.solve_pcg(lin, jnp.asarray(lam))
        tinc, tn = ts.solve(tlin, lam)
        assert tn == int(jn) > 0, (lam, tn, int(jn))
        assert tinc.dtype == torch.float64
        _close(tinc.numpy(), jinc, 1e-4)


@pytest.fixture(scope="module")
def step2_state():
    """tests/test_torch_stage2.py's consistent geometry near its optimum
    (12 ring cameras, 80 landmarks, 4 observations each), homogenized."""
    rng = np.random.default_rng(2)
    n_cams, n_lms = 12, 80
    gt_cams = _ring_cameras(n_cams, radius=10.0, rng=rng)
    pts = rng.standard_normal((n_lms, 3)) * 2.0
    obs_cam = np.concatenate(
        [rng.choice(n_cams, 4, replace=False) for _ in range(n_lms)]
    ).astype(np.int32)
    obs_lm = np.repeat(np.arange(n_lms, dtype=np.int32), 4)
    xh = np.concatenate([pts, np.ones((n_lms, 1))], axis=1)
    p = np.einsum("oij,oj->oi", gt_cams[obs_cam], xh[obs_lm])
    obs_uv = p[:, :2] / p[:, 2:3] + 1e-3 * rng.standard_normal(
        (len(obs_cam), 2)
    )
    cam0 = gt_cams + 1e-2 * rng.standard_normal(gt_cams.shape)
    lm0 = pts + 1e-2 * rng.standard_normal(pts.shape)
    return (obs_cam, obs_lm, obs_uv, n_cams, n_lms), cam0, lm0


@pytest.mark.parametrize("pt", PRECONDITIONERS)
def test_step2_solve_pcg_matches_jax(step2_state, pt):
    """One RIPCG solve from JAX's linearization of the same state: the
    same CG iteration count and the increment within 1e-4 (measured
    <= 9.4e-6)."""
    args, cam0, lm0 = step2_state
    js = JaxStage2(*args, _options(JaxOptions, 2, JaxPT, pt))
    ts = Stage2Solver(*args, _options(SolverOptions, 2, PreconditionerType,
                                      pt), device="cpu")
    assert js._e0_meta is None and ts.e0_plan is None
    jcams, jlms = jax_homogeneous(jnp.asarray(cam0), jnp.asarray(lm0))
    lin = js.linearize(jcams, js.lm_pack(jlms))
    tlin = Lin2S(*[torch.as_tensor(np.array(v)) for v in lin])
    for lam in (1e-4, 1e2):
        jinc, jn = js.solve_pcg(lin, jnp.asarray(lam))
        tinc, tn = ts.solve(tlin, lam)
        assert tn == int(jn) > 0, (lam, tn, int(jn))
        assert tinc.dtype == torch.float64 and tuple(tinc.shape) == (11, 12)
        _close(tinc.numpy(), jinc, 1e-4)

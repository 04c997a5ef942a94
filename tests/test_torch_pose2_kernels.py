"""The eight step-2 kernels of povar_tpu_torch against the JAX package's
Pallas kernels (interpret mode on the CPU), on the state of
tests/test_pallas_pose2.py's `_stage2_solver` fixture: 8 cameras, 60
landmarks, 4 observations each (O = 8192 slot rows after padding, most
of them dead), the VarProj-initialized landmarks of random cameras lifted
to the step-2 state by `create_homogeneous`. The operands that a solve
would compute (zt, sb, mat6, hib, ilm4) are seeded numpy. The fused term
and the Schur-Jacobi corrections run again on seeded operands with a
moderate 1/p2 (in [0.1, 0.5], as tests/test_torch_cuda.py keeps p2 for
hppb2) over tests/test_torch_pose_kernels.py's slot parts.

On CPU tensors the port's wrappers run the plain PyTorch versions
(ops/pose2_ref.py), so these tests hold the plain versions to the TPU
kernels; the CUDA kernels are held to the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.

Tolerances, each relative to the largest magnitude of the output, with
the gap measured on this state:
  - elementwise outputs (r_w, sw, mm, jlw, jlsq, mat_dot2): 1e-5
    (measured <= 2.8e-7);
  - per-camera sums (jpsq, hpp12, b12, scatter2, the fused term,
    schur_diag2) and ldiff2: 1e-4 (measured <= 1.6e-7);
  - the f64 cost: 1e-12 against the JAX package's f64 expression
    (`Stage2Solver._compute_error` with the Pallas kernels off; measured
    3e-16); against the double-float `error2_df32` 1e-12 for NONE
    (measured 1.5e-16) and 1e-7 for HUBER (measured 1.8e-8: the
    double-float kernel takes the Huber weight in f32 from the leading
    component of |r|^2, the f64 expression and the port in f64);
  - the residual-norm sums: 1e-7 (the double-float kernel takes one f32
    sqrt per row; measured 4.6e-10); valid and non-finite counts exactly.

Serial time on the CPU: 32 s for this file alone, 23 s inside a run of
every tests/test_torch_*.py file (most of it the Pallas interpret runs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from povar_tpu.ops import pallas_pose2 as pp2
from povar_tpu.options import RobustNorm, SolverOptions
from povar_tpu.problem.synthetic import synthetic_bal_problem
from povar_tpu.solver.stage1 import Stage1Solver
from povar_tpu.solver.stage2 import Stage2Solver, create_homogeneous
from povar_tpu_torch.ops import launches
from povar_tpu_torch.ops import pose2_kernels as pk2
from povar_tpu_torch.ops import pose2_ref
from test_torch_pose_kernels import PARTS, PREFIX, jax_parts

# one torch thread a test process: the CPU tests' tensors are small,
# and a parallel run's xdist workers share the host's cores
torch.set_num_threads(1)

HUBER = 0.1


def _solver(mode, robust=RobustNorm.NONE):
    """tests/test_pallas_pose2.py's `_stage2_solver` in the port's
    configuration (composed power term, host LM loop)."""
    problem, _ = synthetic_bal_problem(
        n_cams=8, n_lms=60, obs_per_lm=4, seed=0
    )
    s1 = Stage1Solver(
        problem.obs_cam, problem.obs_lm, problem.obs_uv,
        problem.num_cameras, problem.num_landmarks, SolverOptions(),
    )
    cams = jnp.asarray(problem.cam_space)
    cams_h, lms_h = create_homogeneous(cams, s1.initialize_varproj(cams))
    o = SolverOptions()
    o.pallas_kernels = mode
    o.fused_power_term = False
    o.device_lm_loop = "off"
    o.residual.robust_norm = robust
    o.residual.huber_parameter = HUBER
    s = Stage2Solver(
        problem.obs_cam, problem.obs_lm, problem.obs_uv,
        problem.num_cameras, problem.num_landmarks, o,
    )
    return s, cams_h, lms_h


@pytest.fixture(scope="module")
def state():
    """Every kernel operand as numpy, from the JAX solver's own
    linearization (f32) and state (f64)."""
    s, cams_h, lms_h = _solver("on")
    assert s.use_pallas and s._e0_meta is None
    lin = s.linearize(cams_h, lms_h)
    _hll_inv, hib_obs, b6 = s._prep_hll_s(
        s.obs, lin, jnp.asarray(1e-3, jnp.float64)
    )
    o, n = int(s.obs.cam.shape[0]), s.n_cams
    rng = np.random.default_rng(11)
    f = np.float32
    ct64 = np.asarray(cams_h).reshape(n, 12).T.copy()
    x4_64 = np.asarray(s._expand_L(s.obs, s._lm_rows(s.obs, lms_h)))
    d = dict(
        cam=np.asarray(s.obs.cam),
        ct=ct64.astype(f), x4=np.asarray(lin.x4),
        uv=np.asarray(s.obs.uv).astype(f), mask=np.asarray(s._mask1(s.obs)),
        mm=np.asarray(lin.mm), sw=np.asarray(lin.sw),
        r_w=np.asarray(lin.r_w), jlns=np.asarray(lin.jlns),
        jls8=np.asarray(lin.jls8), hib=np.asarray(hib_obs),
        b6=np.asarray(b6),
        zt=rng.standard_normal((12, n)).astype(f),
        sb=rng.standard_normal((3, o)).astype(f),
        ilm4=rng.standard_normal((4, o)).astype(f),
        ct64=ct64, x4_64=x4_64, uv64=np.asarray(s.obs.uv),
    )
    d["n"] = n
    d["shapes"] = s.lm_shapes
    live = d["mask"][0] > 0
    assert 0 < live.sum() < o  # live rows and dead pad rows both present
    return d


def J(d, *keys):
    return [jnp.asarray(d[k]) for k in keys]


def T(d, *keys):
    return [torch.as_tensor(np.array(d[k])) for k in keys]


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors go to the plain versions: no kernel of either step
    counts a launch."""
    launches.reset_launch_counts()
    yield
    counts = launches.launch_counts()
    assert set(counts) == set(launches.KERNELS) and len(counts) == 52
    assert all(v == 0 for v in counts.values()), counts


@pytest.mark.parametrize("use_valid", [True, False], ids=["valid", "all"])
@pytest.mark.parametrize("robust", [0, 1], ids=["none", "huber"])
def test_prepare2(state, use_valid, robust):
    args = ("cam", "ct", "x4", "uv", "mask")
    kw = dict(use_valid=use_valid, robust=robust, huber=HUBER)
    want = pp2.prepare2(*J(state, *args), **kw)
    got = pk2.prepare2(*T(state, *args), **kw)
    if robust:
        sw = np.asarray(want[1])
        assert (sw[sw > 0] < 0.99).any()  # some rows are Huber-weighted
    names = ("r_w", "sw", "mm", "jlw", "jlsq", "jpsq")
    for name, g, w, tol in zip(names, got, want, [1e-5] * 5 + [1e-4]):
        assert g.dtype == torch.float32, name
        _close(g.numpy(), w, tol)


def test_hppb2(state):
    args = ("cam", "x4", "mm", "sw", "r_w", "jlns", "hib")
    want = pp2.hppb2(*J(state, *args), state["n"])
    got = pk2.hppb2(*T(state, *args), state["n"])
    for g, w in zip(got, want):
        _close(g.numpy(), w, 1e-4)


@pytest.mark.parametrize("add_r", [True, False], ids=["add_r", "no_r"])
def test_mat_dot2(state, add_r):
    mat = "jlns" if add_r else "b6"
    want = pp2.mat_dot2(
        *J(state, "cam", "x4", "mm", "sw", mat), jnp.asarray(state["r_w"]),
        jnp.asarray(state["zt"]), add_r=add_r,
    )
    got = pk2.mat_dot2(
        *T(state, "cam", "x4", "mm", "sw", mat),
        *(T(state, "r_w") if add_r else [None]), *T(state, "zt"),
        add_r=add_r,
    )
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("case", ["state", "state_by_camera",
                                  "moderate_by_camera"])
def test_scatter2(state, moderate, case):
    """The composed step-2 scatter against the Pallas kernel on the
    solver's state (most slot rows dead: sw = 0, the kernel's guard) as
    laid out and in the camera-sorted lane order (whole warps on one
    camera on the card, as the mesh's window order puts them), and on
    the seeded operands with ~5% dead rows, sorted by camera."""
    d = dict(state if case.startswith("state") else moderate)
    m6 = "b6" if case.startswith("state") else "mat6"
    args = ("cam", "x4", "mm", "sw", m6, "sb")
    if case.endswith("by_camera"):
        idx = np.argsort(np.asarray(d["cam"]), kind="stable")
        for k in args:
            d[k] = np.ascontiguousarray(np.asarray(d[k])[..., idx])
    want = pp2.scatter2(*J(d, *args), d["n"])
    got = pk2.scatter2(*T(d, *args), d["n"])
    _close(got.numpy(), want, 1e-4)


def test_ldiff2(state):
    args = ("cam", "x4", "mm", "sw", "r_w", "jls8", "ilm4", "zt")
    want = np.asarray(pp2.ldiff2(*J(state, *args))).astype(np.float64).sum()
    got = pk2.ldiff2(*T(state, *args))
    assert got.dtype == torch.float64 and got.dim() == 0
    _close(float(got), want, 1e-4)


@pytest.mark.parametrize(
    "robust, df_tol", [(RobustNorm.NONE, 1e-12), (RobustNorm.HUBER, 1e-7)],
    ids=["none", "huber"],
)
def test_pose_error2(state, robust, df_tol):
    code = {RobustNorm.NONE: 0, RobustNorm.HUBER: 1}[robust]
    got = pk2.pose_error2(
        *T(state, "cam", "ct64", "x4_64", "uv64", "mask"),
        robust=code, huber=HUBER,
    )
    assert set(got) == {
        "num_obs_all", "error_all", "residual_sum_all", "num_obs_valid",
        "error_valid", "residual_sum_valid", "is_numerically_valid",
    }
    assert got["error_all"].dtype == torch.float64
    for mode, tol in (("off", 1e-12), ("on", df_tol)):
        # "off": the JAX f64 expression; "on": the double-float kernel
        s, cams_h, lms_h = _solver(mode, robust)
        want = {k: np.asarray(v) for k, v in
                s.compute_error(cams_h, lms_h).items()}
        for k in ("error_all", "error_valid"):
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=tol, err_msg=f"{mode} {k}")
        for k in ("residual_sum_all", "residual_sum_valid"):
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-7, err_msg=f"{mode} {k}")
        for k in ("num_obs_all", "num_obs_valid", "is_numerically_valid"):
            assert int(got[k]) == int(want[k]), (mode, k)
    assert 0 < int(got["num_obs_valid"]) <= int(got["num_obs_all"])


@pytest.fixture(scope="module")
def moderate():
    """Seeded operands of the fused term, schur_diag2 and scatter2 over
    O = 1024 rows, N = 13 cameras, ~5% dead rows (sw = 0 and mm = 0
    there, as prepare2 leaves them), 1/p2 in [0.1, 0.5]."""
    rng = np.random.default_rng(5)
    o, n = 1024, 13
    f = np.float32
    live = (rng.uniform(size=(1, o)) > 0.05).astype(f)
    mm = np.concatenate([rng.standard_normal((2, o)),
                         rng.uniform(0.1, 0.5, (1, o))]).astype(f) * live
    return dict(
        cam=rng.integers(0, n, o).astype(np.int32), n=n,
        x4=rng.standard_normal((4, o)).astype(f), mm=mm,
        sw=(rng.uniform(0.5, 1.0, (1, o)) * live).astype(f),
        mat6=rng.standard_normal((6, o)).astype(f),
        zt=rng.standard_normal((12, n)).astype(f),
        sb=rng.standard_normal((3, o)).astype(f),
    )


@pytest.mark.parametrize("parts", [PARTS, PREFIX], ids=["all", "prefix"])
def test_e0_term2_parts(moderate, parts):
    d = moderate
    want = pp2.e0_term2_parts(
        jax_parts(parts, d["n"], pp2.E0_TERM2_ROWS, d["cam"], d["x4"],
                  d["mm"], d["sw"], d["mat6"]),
        jnp.asarray(d["zt"]), d["n"],
    )
    got = pk2.e0_term2_parts(*T(d, "cam", "x4", "mm", "sw", "mat6", "zt"),
                             parts, d["n"])
    _close(got.numpy(), want, 1e-4)


def test_e0_term2_parts_on_the_solver_state(state):
    """The fused term over the slot plan of the state's own layout (its
    narrow parts; the dead pad tail is skipped) equals mat_dot2 ->
    per-landmark sum -> re-expansion -> scatter2; measured 1.2e-7."""
    from povar_tpu_torch.solver.segments import (
        slot_part_sums, slot_row_expand,
    )
    from povar_tpu_torch.solver.slots import plan_e0_fused

    args = ("cam", "x4", "mm", "sw", "b6")
    t = T(state, *args)
    shapes = state["shapes"]
    plan = plan_e0_fused(shapes, state["mask"][0])
    assert plan.suffix is None and len(plan.parts) == len(shapes) - 1
    zt = torch.as_tensor(state["zt"])
    u3 = pk2.mat_dot2(*t, None, zt, add_r=False)
    sb = slot_row_expand(slot_part_sums(u3, shapes), shapes)
    want = pk2.scatter2(*t, sb, state["n"])
    got = pk2.e0_term2_parts(*t, zt, plan.parts, state["n"])
    _close(got.numpy(), want.numpy(), 1e-5)


def test_schur_diag2(moderate):
    args = ("cam", "x4", "mm", "sw", "mat6")
    want = pp2.schur_diag2(*J(moderate, *args), moderate["n"])
    got = pk2.schur_diag2(*T(moderate, *args), moderate["n"])
    _close(got.numpy(), want, 1e-4)


def test_cpu_step2_wrappers_are_the_plain_versions(moderate):
    """On CPU tensors the two new step-2 wrappers return exactly what
    their plain versions return (and count no launch)."""
    t = dict(zip(moderate, T(moderate, *moderate)))
    n = moderate["n"]
    obs = [t[k] for k in ("cam", "x4", "mm", "sw", "mat6")]
    for name, args in (("e0_term2_parts", (*obs, t["zt"], PARTS, n)),
                       ("schur_diag2", (*obs, n))):
        assert torch.equal(getattr(pk2, name)(*args),
                           getattr(pose2_ref, name)(*args)), name

"""The mesh's pure f64 (`mixed_precision_solves=False` with an f64 state
on the SPMD window layout, parallel/spmd.py) against the JAX package's
(povar_tpu/parallel/spmd.py:1029-1038: the same structured layout, its
per-observation kernels sent to their XLA mirrors in f64 and its slot
sums to XLA per class), on the CPU at small sizes.

- Kernels: the plain version of every kernel with an f64 instantiation
  (ops/pose_ref.py, pose2_ref.py) and of the two f64 costs, in f64,
  against the JAX package's f64 function (povar_tpu/ops/xla_pose.py; the
  costs against JAX's f64 cost expressions) on the same seeded operands
  at a small window-layout shape (O = 1024, N = 13): 1e-12 relative per
  entry, per camera and per sum (tools/parity.py's scales). The slot
  sums bit for bit against JAX's in f64.
- Stages, D = 2, on tests/test_spmd.py's `_local_problem` geometry
  (landmarks owning several slot rows): step 1's initialize_varproj,
  compute_error, linearize, solve_power with and without landmark
  damping and apply; step 2's, on a consistent ring state of the same
  structure, against JAX's mesh pure f64 at tests/test_spmd.py:545-672's
  tolerances: increments 1e-10 (step 2 1e-9), l_diff 1e-9, states 1e-8.
- Trajectories: `bundle_adjust` on a mesh at D = 1 (in process) and
  D = 2 (two gloo ranks, spawned once for the module) with the default
  solvers, POWER_SCHUR_COMPLEMENT + RIPCG and PCG + RIPOBA, 4 + 4
  iterations each of tools/step2_spread.py's `ring_case`: JAX's mesh
  decisions and power-term / CG counts, costs within 1e-9 in step 1 and
  1e-8 in step 2; and against the port's own
  one-device pure f64 (the unstructured layout) as tests/test_spmd.py:
  674-720 holds JAX's: decisions identical, step 1 within 1e-9, step 2
  within 1e-5.
- The layouts: a mesh's pure f64 runs the structured layout with f64
  storage and solves, the one device the unstructured one.

JAX runs once per configuration in module fixtures, the port's D = 2
ranks once for everything (tests/torch_spmd_f64_ranks.py, which imports
no JAX, so that the ranks start without it).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from povar_tpu.ops import pose_math as jpose_math
from povar_tpu.ops import xla_pose
from povar_tpu.options import SolverOptions as JaxOptions
from povar_tpu.options import SolverType as JaxSolverType
from povar_tpu.options import SolverTypeRiemannian as JaxSolverType2
from povar_tpu.parallel import spmd as jspmd
from povar_tpu.problem.problem import BalProblem as JaxProblem
from povar_tpu.problem.synthetic import _ring_cameras
from povar_tpu.solver.pipeline import bundle_adjust as jax_bundle_adjust
from povar_tpu.solver.stage2 import create_homogeneous as jax_homogeneous
from povar_tpu_torch import SolverOptions, make_mesh, synthetic_bal_problem
from povar_tpu_torch.ops import pose2_ref, pose_ref, spmd_ref
from povar_tpu_torch.parallel import spmd as tspmd
from povar_tpu_torch.parallel.mesh import spawn
from povar_tpu_torch.solver.stage1 import Stage1Solver
from povar_tpu_torch.solver.stage2 import Stage2Solver
from povar_tpu_torch.tools.parity import scaled_error
from povar_tpu_torch.tools.step2_spread import ring_case
from test_spmd import _local_problem
from torch_spmd_f64_ranks import (
    CONFIGS,
    LAM,
    f64_options,
    port_rank,
    port_trajectories,
    records,
    trajectory_options,
)

# one torch thread a test process: the CPU tests' tensors are small,
# and a parallel run's xdist workers share the host's cores
torch.set_num_threads(1)

ALPHA = 0.01
O, N = 1024, 13
TOL = 1e-12


# ------------------------------------------------------------ kernels


def _operands():
    """Seeded f64 operands of every kernel (tests/test_torch_cuda.py's,
    in f64): step 2's camera table and landmarks keep p2 in [2.5, 9]."""
    rng = np.random.default_rng(7)
    mask = (rng.uniform(size=(1, O)) > 0.05).astype(np.float32)
    m64 = mask.astype(np.float64)
    ct = rng.standard_normal((12, N))
    ct2 = ct.copy()
    ct2[8:11] *= 0.1
    ct2[11] = rng.uniform(3.0, 4.0, N)
    x4 = rng.standard_normal((4, O))
    x4[3] = rng.uniform(1.0, 2.0, O)
    sw = rng.uniform(0.5, 1.0, (1, O)) * m64
    return dict(
        cam=rng.integers(0, N, O).astype(np.int32), ct=ct,
        x=rng.standard_normal((3, O)), uv=rng.standard_normal((2, O)),
        mask=mask, sw=sw, w=sw * sw, r_w=rng.standard_normal((4, O)) * m64,
        jls=rng.uniform(0.1, 1.0, (3, O)), hib=rng.standard_normal((3, O)),
        lh=rng.standard_normal((9, O)), h=rng.standard_normal((9, O)) * m64,
        z=rng.standard_normal((12, N)), sb=rng.standard_normal((3, O)),
        inc=rng.standard_normal((12, N)),
        inc_lm=rng.standard_normal((3, O)), ct2=ct2, x4=x4,
        mm=rng.standard_normal((3, O)) * m64,
        r_w2=rng.standard_normal((2, O)) * m64,
        jlns=rng.standard_normal((6, O)), jls8=rng.standard_normal((8, O)),
        mat6=rng.standard_normal((6, O)), ilm4=rng.standard_normal((4, O)),
    )


# name -> (port module, JAX function, operand keys, keyword arguments,
# the scale of each output: tools/parity.py's kinds)
KERNELS = {
    "prepare": (pose_ref, xla_pose.prepare,
                ("cam", "ct", "x", "uv", "mask"),
                dict(alpha=ALPHA, robust=1, huber=1.0),
                ("elem",) * 4 + ("cam",)),
    "e0_factor": (pose_ref, xla_pose.e0_factor,
                  ("cam", "ct", "uv", "w", "jls", "lh"), dict(alpha=ALPHA),
                  ("elem",)),
    "hpp_b_structured": (pose_ref, xla_pose.hpp_b_structured,
                         ("cam", "ct", "x", "uv", "sw", "r_w", "jls", "hib",
                          N), dict(alpha=ALPHA), ("cam", "cam")),
    "e0_u_structured": (pose_ref, xla_pose.e0_u_structured,
                        ("cam", "x", "h", "z"), {}, ("elem",)),
    "e0_scatter_structured": (pose_ref, xla_pose.e0_scatter_structured,
                              ("cam", "x", "h", "sb", N), {}, ("cam",)),
    "apply_ldiff": (pose_ref, xla_pose.apply_ldiff,
                    ("cam", "x", "uv", "sw", "r_w", "jls", "inc_lm", "ct",
                     "inc"), dict(alpha=ALPHA), ("scalar",)),
    "poba_t3": (pose_ref, xla_pose.poba_t3,
                ("cam", "ct", "x", "uv", "sw", "r_w", "jls", "z"),
                dict(alpha=ALPHA), ("elem",)),
    "apply_ldiff_stored": (pose_ref, xla_pose.apply_ldiff_stored,
                           ("cam", "x", "uv", "sw", "r_w", "jls", "inc_lm",
                            "ct", "z"), dict(alpha=ALPHA), ("scalar",)),
    "schur_diag_structured": (pose_ref, xla_pose.schur_diag_structured,
                              ("cam", "x", "h", N), {}, ("cam",)),
    "prepare2": (pose2_ref, xla_pose.prepare2,
                 ("cam", "ct2", "x4", "uv", "mask"),
                 dict(use_valid=True, robust=1, huber=1.0),
                 ("elem",) * 5 + ("cam",)),
    "hppb2": (pose2_ref, xla_pose.hppb2,
              ("cam", "x4", "mm", "sw", "r_w2", "jlns", "hib", N), {},
              ("cam", "cam")),
    "mat_dot2": (pose2_ref, xla_pose.mat_dot2,
                 ("cam", "x4", "mm", "sw", "jlns", "r_w2", "z"),
                 dict(add_r=True), ("elem",)),
    "scatter2": (pose2_ref, xla_pose.scatter2,
                 ("cam", "x4", "mm", "sw", "mat6", "sb", N), {}, ("cam",)),
    "ldiff2": (pose2_ref, xla_pose.ldiff2,
               ("cam", "x4", "mm", "sw", "r_w2", "jls8", "ilm4", "z"), {},
               ("scalar",)),
    "schur_diag2": (pose2_ref, xla_pose.schur_diag2,
                    ("cam", "x4", "mm", "sw", "mat6", N), {}, ("cam",)),
}


@pytest.fixture(scope="module")
def operands():
    return _operands()


def _args(d, keys, make):
    return [k if isinstance(k, int) else make(d[k]) for k in keys]


@pytest.mark.parametrize("name", list(KERNELS))
def test_kernel_plain_versions_match_jax_in_f64(operands, name):
    """The plain version in f64 (what the f64 kernel is held to on the
    card) against the JAX package's f64 function: 1e-12 per entry, per
    camera and per sum; f64 outputs. apply_ldiff / apply_ldiff_stored /
    ldiff2 return the sum of JAX's [128] lane partials."""
    mod, jfn, keys, kw, kinds = KERNELS[name]
    got = getattr(mod, name)(*_args(operands, keys, torch.as_tensor), **kw)
    want = jfn(*_args(operands, keys, jnp.asarray), **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if kinds == ("scalar",):
        want = (jnp.sum(want[0]),)
    assert len(got) == len(want) == len(kinds)
    for g, w, kind in zip(got, want, kinds):
        assert g.dtype == torch.float64, name
        err = scaled_error(g, torch.as_tensor(np.array(w)), kind)
        assert err <= TOL, (name, kind, err)


@pytest.mark.parametrize("robust", [0, 1, 2])
def test_costs_take_f64_operands(operands, robust):
    """The two costs (native f64 on the card since their first port) on
    the mesh's f64 operands: against JAX's f64 cost expressions
    (pose_math's residuals and robust error), 1e-12."""
    d = operands
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    live = d["mask"][0] > 0
    err, rn, bad = pose_ref.pose_error(
        t["cam"], t["ct"], t["x"], t["uv"], t["mask"], alpha=ALPHA,
        robust=robust, huber=1.0)
    P = jnp.asarray(d["ct"][:, d["cam"]].reshape(3, 4, O))
    r = jpose_math.pose_residual_t(P, jnp.asarray(d["x"]),
                                   jnp.asarray(d["uv"]), ALPHA)
    res_sq = (r * r).sum(axis=0)
    e, _w = jpose_math.robust_error_and_weight(res_sq, robust, 1.0)
    np.testing.assert_allclose(float(err), float(jnp.sum(e[live])),
                               rtol=TOL)
    np.testing.assert_allclose(float(rn),
                               float(jnp.sum(jnp.sqrt(res_sq)[live])),
                               rtol=TOL)
    assert int(bad) == 0
    info = pose2_ref.pose_error2(t["cam"], t["ct2"], t["x4"], t["uv"],
                                 t["mask"], robust=robust, huber=1.0)
    P2 = jnp.asarray(d["ct2"][:, d["cam"]].reshape(3, 4, O))
    r2, valid = jpose_math.homogeneous_residual_t(
        P2, jnp.asarray(d["x4"]), jnp.asarray(d["uv"]))
    res2 = (r2 * r2).sum(axis=0)
    e2, _w = jpose_math.robust_error_and_weight(res2, robust, 1.0)
    assert info["error_all"].dtype == torch.float64
    np.testing.assert_allclose(float(info["error_all"]),
                               float(jnp.sum(e2[live])), rtol=TOL)
    np.testing.assert_allclose(
        float(info["error_valid"]),
        float(jnp.sum(jnp.where(valid, e2, 0.0)[live])), rtol=TOL)


def test_slot_sums_match_jax_in_f64():
    """The three slot reduce / expand plain versions in f64, over a
    layout of two classes (several parts, a w = 1 part, tail lanes),
    bit for bit against the JAX package's (its per-class XLA fallback in
    f64); the pure-f64 expansion keeps all 53 bits (no hi / lo halves)."""
    layout = (tspmd.ClassLayout(3, ((128, 3), (256, 2)), 1024),
              tspmd.ClassLayout(2, ((128, 1),), 256))
    jlayout = tuple(jspmd.ClassLayout(*cl) for cl in layout)
    o_dev, n_rows = spmd_ref.layout_sizes(layout)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, o_dev))
    rows = rng.standard_normal((2, n_rows))
    np.testing.assert_array_equal(
        tspmd.spmd_part_sums(torch.as_tensor(x), layout).numpy(),
        np.asarray(jspmd.spmd_part_sums(jnp.asarray(x), jlayout)))
    got = tspmd.spmd_expand_rows(torch.as_tensor(rows), layout, hi_lo=False)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jspmd.spmd_expand_rows(jnp.asarray(rows), jlayout)))
    np.testing.assert_array_equal(
        tspmd.spmd_reduce_reexpand(torch.as_tensor(x), layout).numpy(),
        np.asarray(jspmd.spmd_reduce_reexpand(jnp.asarray(x), jlayout)))


# ------------------------------------------------------------ the stages


def _stage_case():
    """tests/test_torch_spmd.py's overflow problem: 200 cameras of
    _local_problem with loop closures (random cameras for step 1) and a
    consistent near-optimum ring state of its structure for step 2."""
    rng = np.random.default_rng(3)
    n_cams = 200
    obs_cam, obs_lm, obs_uv, n_lms = _local_problem(rng, n_cams, 120)
    cams1 = rng.standard_normal((n_cams, 3, 4))
    cams1[:, 2, :] = [0, 0, 0, 1.0]
    gt = _ring_cameras(n_cams, radius=10.0, rng=rng)
    lm_p = rng.standard_normal((n_lms, 3)) * 2.0
    xh = np.concatenate([lm_p, np.ones((n_lms, 1))], axis=1)
    p = np.einsum("oij,oj->oi", gt[obs_cam], xh[obs_lm])
    uv2 = p[:, :2] / p[:, 2:3] + 1e-3 * rng.standard_normal((len(p), 2))
    return dict(
        obs_cam=obs_cam, obs_lm=obs_lm, obs_uv=obs_uv, n_cams=n_cams,
        n_lms=n_lms, cams1=cams1, uv2=uv2,
        cams2=gt + 1e-3 * rng.standard_normal(gt.shape),
        lms2=lm_p + 1e-3 * rng.standard_normal(lm_p.shape),
    )


@pytest.fixture(scope="module")
def case():
    return _stage_case()


def _jax_stages(c):
    """JAX's mesh pure-f64 stage outputs at D = 2 (landmark outputs in
    canonical order)."""
    S1, S2 = jspmd.get_spmd_solver_classes()
    mesh = JaxMesh(np.asarray(jax.devices()[:2]), ("obs",))
    plan = jspmd.build_spmd_plan(c["obs_cam"], c["obs_lm"], c["n_cams"],
                                 c["n_lms"], 2, 4096)
    assert plan.has_duplicates
    s = S1(plan, c["obs_uv"], c["n_cams"], c["n_lms"],
           f64_options(JaxOptions), mesh)
    assert s.solve_dtype == jnp.float64
    cams = jnp.asarray(c["cams1"])
    lam = jnp.asarray(LAM, jnp.float64)
    lp = s.initialize_varproj(cams)
    lin = s.linearize(cams, lp)
    inc, n = s.solve_power(lin, lam)
    nc, nl, ld = s.apply(cams, lp, lin, inc)
    inc2, n2 = s.solve_power(lin, lam, landmark_damping=True)
    out1 = dict(
        lm0=s.unpad_landmarks(lp),
        e0=float(s.compute_error(cams, lp)["error_all"]),
        inc=np.asarray(inc), n=int(n), ld=float(ld),
        lm1=s.unpad_landmarks(nl), cams1=np.asarray(nc),
        inc2=np.asarray(inc2), n2=int(n2),
    )
    s2 = S2(plan, c["uv2"], c["n_cams"], c["n_lms"],
            f64_options(JaxOptions), mesh)
    cams, lmh = jax_homogeneous(jnp.asarray(c["cams2"]),
                                s2.pad_landmarks(c["lms2"]))
    e = s2.compute_error(cams, lmh)
    lin = s2.linearize(cams, lmh)
    inc, n = s2.solve_power(lin, lam)
    nc, nl, ld = s2.apply(cams, lmh, lin, inc, lam)
    out2 = dict(
        e0=float(e["error_all"]), valid=int(e["num_obs_valid"]),
        inc=np.asarray(inc), n=int(n), ld=float(ld), cams=np.asarray(nc),
        lm=s2.unpad_landmarks(nl),
    )
    return out1, out2


@pytest.fixture(scope="module")
def jax_stages(case):
    return _jax_stages(case)


@pytest.fixture(scope="module")
def port_d2(case):
    """The port's D = 2 results as two gloo ranks, spawned once (rank
    0's; both ranks must take the same decisions)."""
    ranks = spawn(port_rank, 2, "cpu", args=(case,))
    assert ranks[0][1] == ranks[1][1]
    return ranks[0]


@pytest.fixture(scope="module")
def jax_trajectories():
    """JAX's mesh pure-f64 `bundle_adjust` at D = 2, every
    configuration."""
    mesh = JaxMesh(np.asarray(jax.devices()[:2]), ("obs",))
    args, cam0, lm0 = ring_case()
    out = {}
    for config in CONFIGS:
        problem = JaxProblem(
            cam_space=cam0.copy(), intrinsics=np.tile([1.0, 0.0, 0.0],
                                                      (args[3], 1)),
            lm_p=lm0.copy(), obs_cam=args[0], obs_lm=args[1],
            obs_uv=args[2])
        opts = trajectory_options(JaxOptions, JaxSolverType, JaxSolverType2,
                                   config)
        _, s1, s2 = jax_bundle_adjust(problem, opts, log=lambda s: None,
                                      mesh=mesh)
        out[config] = (records(s1), records(s2))
    return out


# ------------------------------------------------------------ the tests


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / (
        np.abs(np.asarray(b)).max() + 1e-300)


def test_step1_stages_match_jax(jax_stages, port_d2):
    """Step 1 at D = 2 against JAX's mesh pure f64, at
    tests/test_spmd.py:565-620's tolerances (increments 1e-10, l_diff
    1e-9, states 1e-8), f64 storage throughout."""
    got, want = port_d2[0][0], jax_stages[0]
    assert got["dtypes"] == {torch.float64}
    assert np.abs(got["lm0"] - want["lm0"]).max() < 1e-9
    assert abs(got["e0"] - want["e0"]) <= 1e-12 * abs(want["e0"])
    assert got["n"] == want["n"] and got["n2"] == want["n2"]
    assert _rel(got["inc"], want["inc"]) < 1e-10
    assert _rel(got["inc2"], want["inc2"]) < 1e-10
    assert abs(got["ld"] - want["ld"]) <= 1e-9 * abs(want["ld"])
    assert np.abs(got["lm1"] - want["lm1"]).max() < 1e-8
    assert np.abs(got["cams1"] - want["cams1"]).max() < 1e-8


def test_step2_stages_match_jax(jax_stages, port_d2):
    """Step 2 on the consistent ring state at D = 2 against JAX's mesh
    pure f64, at tests/test_spmd.py:623-671's tolerances (increments
    1e-9, l_diff 1e-9, states 1e-10)."""
    got, want = port_d2[0][1], jax_stages[1]
    assert got["dtypes"] == {torch.float64}
    assert abs(got["e0"] - want["e0"]) <= 1e-12 * abs(want["e0"])
    assert got["valid"] == want["valid"] and got["n"] == want["n"]
    assert _rel(got["inc"], want["inc"]) < 1e-9
    assert abs(got["ld"] - want["ld"]) <= 1e-9 * abs(want["ld"])
    assert np.abs(got["lm"] - want["lm"]).max() < 1e-10
    assert np.abs(got["cams"] - want["cams"]).max() < 1e-10


def _same_trajectory(got, want, tols):
    """Decisions and inner counts identical, costs within tols[step]
    relative (of max(|cost|, 1))."""
    for step, (g, w) in enumerate(zip(got, want)):
        assert [r[:2] for r in g] == [r[:2] for r in w], step
        for (_a, _b, cg), (_c, _d, cw) in zip(g, w):
            assert abs(cg - cw) <= tols[step] * max(abs(cw), 1.0), step


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("n_dev", [1, 2])
def test_trajectories_match_jax_mesh(jax_trajectories, port_d2, config,
                                     n_dev):
    """`bundle_adjust` in pure f64 on a mesh of n_dev devices against
    JAX's mesh at D = 2: its decisions and counts, costs within 1e-9 in
    step 1 and 1e-8 in step 2."""
    got = (port_d2[1] if n_dev == 2
           else port_trajectories(make_mesh(1, "cpu")))[config]
    _same_trajectory(got, jax_trajectories[config], (1e-9, 1e-8))


@pytest.mark.parametrize("config", list(CONFIGS))
def test_trajectories_match_one_device(port_d2, config):
    """The mesh's pure f64 (structured layout, D = 2) against the port's
    one-device pure f64 (the unstructured layout, itself held to JAX and
    Eigen by tests/test_torch_f64_*.py), as tests/test_spmd.py:674-720
    holds JAX's: decisions identical, step 1 within 1e-9, step 2 within
    1e-5."""
    _same_trajectory(port_d2[1][config], port_trajectories(None)[config],
                     (1e-9, 1e-5))


def test_mesh_pure_f64_takes_the_structured_layout():
    """On a mesh pure f64 runs the structured window layout with f64
    storage and solves in both steps (with "on" too, as the JAX
    package's mesh); one device keeps the unstructured layout, and "on"
    there still raises the JAX package's ValueError."""
    problem, _ = synthetic_bal_problem(n_cams=6, n_lms=30, obs_per_lm=4,
                                       seed=2)
    plan = tspmd.build_spmd_plan(problem.obs_cam, problem.obs_lm,
                                 problem.num_cameras, problem.num_landmarks,
                                 1, tspmd.PART_ALIGN)
    mesh = make_mesh(1, "cpu")
    for mode in ("auto", "on"):
        opts = SolverOptions(mixed_precision_solves=False,
                             pallas_kernels=mode)
        for cls in (tspmd.SpmdStage1Solver, tspmd.SpmdStage2Solver):
            s = cls(plan, problem.obs_uv, problem.num_cameras,
                    problem.num_landmarks, opts, mesh)
            assert not s.unstructured and s.solve_dtype == torch.float64
            assert s.e0_plan is None
    args = (problem.obs_cam, problem.obs_lm, problem.obs_uv,
            problem.num_cameras, problem.num_landmarks)
    for cls in (Stage1Solver, Stage2Solver):
        s = cls(*args, SolverOptions(mixed_precision_solves=False),
                device="cpu")
        assert s.unstructured and s.solve_dtype == torch.float64
        with pytest.raises(ValueError, match="f32 inner solves"):
            cls(*args, SolverOptions(mixed_precision_solves=False,
                                     pallas_kernels="on"), device="cpu")

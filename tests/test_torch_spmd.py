"""The port's SPMD window layout (povar_tpu_torch/parallel/spmd.py: one
process per shard, gloo ranks on the CPU) against the JAX package's SPMD
solvers (povar_tpu/parallel/spmd.py: shard_map over conftest's virtual
CPU devices), on the CPU at small sizes.

- Same-state stages, D = 2, on a 200-camera problem of
  tests/test_spmd.py's geometry with loop closures, so that landmarks
  own several slot rows (`has_duplicates`): step 1's
  initialize_varproj, compute_error, linearize, solve_power with and
  without landmark damping, apply and apply_poba; step 2 (on a
  consistent ring state, as tests/test_spmd.py:333-392) compute_error,
  linearize, solve_power and apply. Tolerances are those that
  tests/test_spmd.py holds JAX's SPMD solver to its single-chip one
  with: both are the same math in another f32 summation order.
- Step 2's LM loop, D = 2, on that ring state (observations with 1e-3
  noise): three iterations from the same start, the same decisions and
  power-term counts, lambdas within 1e-4 and costs within 1e-3 (the
  port's tolerances, tests/test_torch_stage1.py) or 1e-6 of the initial
  cost. The dryrun problem's trajectories are in
  tests/test_torch_spmd_dryrun.py.
- The all-reduces carry camera-sized tensors and scalars only; the
  configurations the JAX package sends to its GSPMD fallback, and the
  port's other refusals, raise NotImplementedError on a mesh.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from povar_tpu.options import SolverOptions as JaxOptions
from povar_tpu.parallel import spmd as jspmd
from povar_tpu.problem.synthetic import _ring_cameras
from povar_tpu.solver.lm import optimize_step2 as jax_optimize_step2
from povar_tpu.solver.stage2 import create_homogeneous as jax_homogeneous
from povar_tpu.utils.summary import SolverSummary as JaxSummary
from povar_tpu.utils.timer import Timer as JaxTimer
from povar_tpu_torch import (
    SolverOptions,
    SolverSummary,
    Timer,
    bundle_adjust,
    create_homogeneous,
    make_mesh,
    optimize_step2,
    synthetic_bal_problem,
)
from povar_tpu_torch.options import SolverType
from povar_tpu_torch.parallel import spmd as tspmd
from povar_tpu_torch.parallel.mesh import spawn
from povar_tpu_torch.solver.slots import SlotSolver
from test_spmd import _local_problem

# one torch thread a test process: the CPU tests' tensors are small,
# and a parallel run's xdist workers share the host's cores
torch.set_num_threads(1)

LAM = 1e-3


def _jax_mesh(n_dev):
    return JaxMesh(np.asarray(jax.devices()[:n_dev]), ("obs",))


def _stage_options(cls):
    o = cls()
    o.power_sc_iterations = 3
    o.eta = 0.0
    o.r_tolerance = -1.0
    o.pallas_kernels = "on"
    o.max_num_iterations_step_2 = 3
    return o


# ------------------------------------------------------------ inputs


def _stage_case():
    """The 200-camera overflow problem (random cameras for step 1) and a
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


def _records(summary):
    return [(it.step_is_successful, it.linear_solver_iterations,
             None if it.cost is None else it.cost.all.error,
             it.trust_region_radius) for it in summary.iterations]


# ------------------------------------------------------------ the JAX side


@pytest.fixture(scope="module")
def case():
    return _stage_case()


@pytest.fixture(scope="module")
def jax_stages(case):
    """JAX's SPMD solvers on the overflow problem at D = 2: same-state
    stage outputs (landmark outputs in canonical order) and step 2's LM
    loop records."""
    c = case
    S1, S2 = jspmd.get_spmd_solver_classes()
    mesh = _jax_mesh(2)
    plan = jspmd.build_spmd_plan(c["obs_cam"], c["obs_lm"], c["n_cams"],
                                 c["n_lms"], 2, 4096)
    assert plan.has_duplicates
    s = S1(plan, c["obs_uv"], c["n_cams"], c["n_lms"],
           _stage_options(JaxOptions), mesh)
    cams = jnp.asarray(c["cams1"])
    lam = jnp.asarray(LAM, jnp.float64)
    lp = s.initialize_varproj(cams)
    lin = s.linearize(cams, lp)
    inc, n = s.solve_power(lin, lam)
    nc, nl, ld = s.apply(cams, lp, lin, inc)
    inc2, n2 = s.solve_power(lin, lam, landmark_damping=True)
    _nc2, nl2, ld2 = s.apply_poba(cams, lp, lin, inc2, lam)
    out1 = dict(
        lm0=s.unpad_landmarks(lp),
        e0=float(s.compute_error(cams, lp)["error_all"]),
        pose_scale=np.asarray(lin.pose_scale),
        hll_raw=np.asarray(lin.hll_raw), inc=np.asarray(inc), n=int(n),
        ld=float(ld), lm1=s.unpad_landmarks(nl),
        e1=float(s.compute_error(nc, nl)["error_all"]),
        inc2=np.asarray(inc2), n2=int(n2), ld2=float(ld2),
        lm2=s.unpad_landmarks(nl2),
    )
    s2 = S2(plan, c["uv2"], c["n_cams"], c["n_lms"],
            _stage_options(JaxOptions), mesh)
    cams, lmh = jax_homogeneous(jnp.asarray(c["cams2"]),
                                s2.pad_landmarks(c["lms2"]))
    e = s2.compute_error(cams, lmh)
    lin = s2.linearize(cams, lmh)
    inc, n = s2.solve_power(lin, lam)
    nc, nl, ld = s2.apply(cams, lmh, lin, inc, lam)
    out2 = dict(
        e0=float(e["error_all"]), valid=int(e["num_obs_valid"]),
        pose_scale=np.asarray(lin.pose_scale), inc=np.asarray(inc),
        n=int(n), ld=float(ld), cams=np.asarray(nc),
        lm=s2.unpad_landmarks(nl),
    )
    loop = JaxSummary()
    jax_optimize_step2(s2, cams, lmh, s2.opts, loop,
                       JaxTimer(), log=lambda s: None)
    return out1, out2, _records(loop)


# ------------------------------------------------------------ the port side


def _port_stages(mesh, c):
    """The port's SPMD stage outputs and step-2 loop records on this
    rank's mesh (as jax_stages), landmark outputs gathered to canonical
    order."""
    plan = tspmd.build_spmd_plan(c["obs_cam"], c["obs_lm"], c["n_cams"],
                                 c["n_lms"], mesh.size, tspmd.PART_ALIGN)
    s = tspmd.SpmdStage1Solver(plan, c["obs_uv"], c["n_cams"], c["n_lms"],
                               _stage_options(SolverOptions), mesh)
    cams = torch.as_tensor(c["cams1"])

    def lms(x):
        return s.unpad_landmarks(s.lm_unpack(x))

    lp = s.lm_pack(s.initialize_varproj(cams))
    lin = s.linearize(cams, lp)
    inc, n = s.solve_power(lin, LAM)
    nc, nl, ld = s.apply(cams, lp, lin, inc)
    inc2, n2 = s.solve_power(lin, LAM, landmark_damping=True)
    _nc2, nl2, ld2 = s.apply_poba(cams, lp, lin, inc2, LAM)
    hll = mesh.all_gather(lin.hll_raw.permute(2, 0, 1).contiguous())
    out1 = dict(
        lm0=lms(lp), e0=float(s.compute_error(cams, lp)["error_all"]),
        pose_scale=lin.pose_scale.numpy(),
        hll_raw=hll.permute(1, 2, 0).numpy(), inc=inc.numpy(), n=int(n),
        ld=float(ld), lm1=lms(nl),
        e1=float(s.compute_error(nc, nl)["error_all"]),
        inc2=inc2.numpy(), n2=int(n2), ld2=float(ld2), lm2=lms(nl2),
    )
    s2 = tspmd.SpmdStage2Solver(plan, c["uv2"], c["n_cams"], c["n_lms"],
                                _stage_options(SolverOptions), mesh)
    cams, lmh = create_homogeneous(torch.as_tensor(c["cams2"]),
                                   s2.pad_landmarks(c["lms2"]))
    lmh = s2.lm_pack(lmh)
    e = s2.compute_error(cams, lmh)
    lin = s2.linearize(cams, lmh)
    inc, n = s2.solve_power(lin, LAM)
    nc, nl, ld = s2.apply(cams, lmh, lin, inc, LAM)
    out2 = dict(
        e0=float(e["error_all"]), valid=int(e["num_obs_valid"]),
        pose_scale=lin.pose_scale.numpy(), inc=inc.numpy(), n=int(n),
        ld=float(ld), cams=nc.numpy(),
        lm=s2.unpad_landmarks(s2.lm_unpack(nl)),
    )
    cams, lmh = create_homogeneous(torch.as_tensor(c["cams2"]),
                                   s2.pad_landmarks(c["lms2"]))
    loop = SolverSummary()
    optimize_step2(s2, cams, lmh, s2.opts, loop, Timer(),
                   log=lambda s: None)
    return out1, out2, _records(loop)


@pytest.fixture(scope="module")
def port(case):
    """The port's results as two gloo ranks (rank 0's; both ranks must
    take the same LM decisions)."""
    ranks = spawn(_port_stages, 2, "cpu", args=(case,))
    assert ranks[0][2] == ranks[1][2]
    return ranks[0]


# ------------------------------------------------------------ the tests


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / (
        np.abs(np.asarray(b)).max() + 1e-12)


def test_step1_stages_match_jax(jax_stages, port):
    """tests/test_spmd.py:281-330's tolerances, D = 2, has_duplicates."""
    got, want = port[0], jax_stages[0]
    assert abs(got["e0"] - want["e0"]) <= 1e-11 * abs(want["e0"])
    assert _rel(got["lm0"], want["lm0"]) < 3e-3
    assert _rel(got["pose_scale"], want["pose_scale"]) < 1e-5
    assert _rel(got["hll_raw"], want["hll_raw"]) < 1e-5
    assert got["n"] == want["n"] and got["n2"] == want["n2"]
    # post-step costs are cancelled: compared on the initial cost's scale
    assert abs(got["e1"] - want["e1"]) <= 1e-6 * want["e0"]
    assert abs(got["ld"] - want["ld"]) <= 1e-3 * abs(want["ld"])
    assert abs(got["ld2"] - want["ld2"]) <= 1e-3 * abs(want["ld2"])
    for k in ("inc", "lm1", "inc2", "lm2"):
        assert _rel(got[k], want[k]) < 3e-3, k


def test_step2_stages_match_jax(jax_stages, port):
    """tests/test_spmd.py:333-392's tolerances on the consistent ring
    state, D = 2, has_duplicates."""
    got, want = port[1], jax_stages[1]
    assert abs(got["e0"] - want["e0"]) <= 1e-11 * abs(want["e0"])
    assert got["valid"] == want["valid"]
    assert _rel(got["pose_scale"], want["pose_scale"]) < 1e-5
    assert got["n"] == want["n"]
    assert _rel(got["inc"], want["inc"]) < 3e-3
    assert abs(got["ld"] - want["ld"]) <= 1e-4 * abs(want["ld"])
    assert np.abs(got["lm"] - want["lm"]).max() < 1e-4
    assert np.abs(got["cams"] - want["cams"]).max() < 1e-4


def test_step2_loop_matches_jax(jax_stages, port):
    """Three step-2 LM iterations, D = 2: JAX's decisions, counts and
    lambdas; costs within 1e-3, or, once they have fallen to noise
    level (~1e-5 of the start: the cameras see few landmarks each, so
    the fit nearly interpolates), within 1e-6 of the initial cost, the
    two scales tests/test_spmd.py:426-434 holds JAX's own paths to."""
    got, want = port[2], jax_stages[2]
    assert [r[:2] for r in got] == [r[:2] for r in want]
    c_init = want[0][2]
    for g, w in zip(got, want):
        assert abs(g[2] - w[2]) <= max(1e-3 * abs(w[2]), 1e-6 * c_init)
        np.testing.assert_allclose(g[3], w[3], rtol=1e-4)


def _collective_shapes(c):
    """The shapes of every tensor the port all-reduces in one trial of
    step 1 with POWER_VARPROJ, PCG and POWER_SCHUR_COMPLEMENT and one of
    step 2, on a 1-device mesh over case `c` (_stage_case's keys)."""
    shapes = []
    orig = SlotSolver._psum

    def record(self, x):
        shapes.append(tuple(x.shape))
        return orig(self, x)

    mesh = make_mesh(1, "cpu")
    plan = tspmd.build_spmd_plan(c["obs_cam"], c["obs_lm"], c["n_cams"],
                                 c["n_lms"], 1, tspmd.PART_ALIGN)
    cams = torch.as_tensor(c["cams1"])
    try:
        SlotSolver._psum = record
        for st in (SolverType.POWER_VARPROJ, SolverType.PCG,
                   SolverType.POWER_SCHUR_COMPLEMENT):
            o = _stage_options(SolverOptions)
            o.solver_type_step_1 = st
            s = tspmd.SpmdStage1Solver(plan, c["obs_uv"], c["n_cams"],
                                       c["n_lms"], o, mesh)
            lp = s.lm_pack(s.initialize_varproj(cams))
            s.trial(cams, lp, s.linearize(cams, lp), LAM)
        s2 = tspmd.SpmdStage2Solver(plan, c["uv2"], c["n_cams"], c["n_lms"],
                                    _stage_options(SolverOptions), mesh)
        c2, lh = create_homogeneous(torch.as_tensor(c["cams2"]),
                                    s2.pad_landmarks(c["lms2"]))
        s2.trial(c2, lh, s2.linearize(c2, lh), LAM)
    finally:
        SlotSolver._psum = orig
    assert len(shapes) > 20
    for shp in shapes:
        assert len(shp) <= 1 or shp[-1] == c["n_cams"], shp
        assert len(shp) != 1 or shp[0] <= 8, shp
    return shapes


def test_collectives_are_camera_sized(case):
    """Every tensor the port all-reduces is a scalar (a cost, l_diff, a
    stack of cost buckets) or has the camera count as its last dimension
    (jpsq, Hpp, b, an E0 term, the Schur corrections), in both steps and
    with PCG and POWER_SCHUR_COMPLEMENT: no observation- or landmark-
    sized array moves between ranks."""
    _collective_shapes(case)


def test_collectives_are_camera_sized_past_1024_cameras():
    """The same at N = 1300 (tests/test_torch_large_n.py's local-span
    problem): the largest all-reduce is the Schur corrections' [144, N]
    (PCG's preconditioner), the per-camera sums [12, N]; at final-13682's
    N = 13,682 those are 7.9 MB and 0.66 MB of f32, whatever the
    observation count."""
    from test_torch_large_n import N_CAMS, N_LMS, _ring_problem

    (obs_cam, obs_lm, obs_uv, n_cams, n_lms), cams, lms = _ring_problem(
        N_CAMS, N_LMS)
    cams1 = np.random.default_rng(4).standard_normal((n_cams, 3, 4))
    cams1[:, 2, :] = [0, 0, 0, 1.0]
    shapes = _collective_shapes(dict(
        obs_cam=obs_cam, obs_lm=obs_lm, obs_uv=obs_uv, n_cams=n_cams,
        n_lms=n_lms, cams1=cams1, uv2=obs_uv, cams2=cams, lms2=lms))
    assert max(int(np.prod(shp)) for shp in shapes) == 144 * n_cams
    assert (12, n_cams) in shapes


@pytest.mark.parametrize("change, item", [
    (dict(pallas_kernels="off"), "item 13"),
    (dict(solver_type_step_1=SolverType.CHOLESKY), "item 13"),
    (dict(detailed_timing=True), "item 13"),
    (dict(mixed_precision_solves=False), "item 11"),
    (dict(dtype=torch.float32), "item 13"),
])
def test_mesh_refuses_unported_configurations(change, item):
    """What the JAX package runs on its GSPMD fallback (the unstructured
    layout, CHOLESKY, an f32 state, detailed_timing) and the mesh's pure
    f64 raise NotImplementedError on a mesh, naming their ROADMAP.md
    item, before any solve."""
    change = dict(change)
    dtype = change.pop("dtype", torch.float64)
    problem, _ = synthetic_bal_problem(n_cams=6, n_lms=30, obs_per_lm=4,
                                       seed=2)
    with pytest.raises(NotImplementedError, match=item):
        bundle_adjust(problem, SolverOptions(**change), dtype=dtype,
                      log=lambda s: None, mesh=make_mesh(1, "cpu"))


def test_mesh_on_the_card_needs_a_card():
    """make_mesh's default device is the card: without one it raises
    rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(1)
    with pytest.raises(ValueError, match="spawn"):
        make_mesh(2, "cpu")

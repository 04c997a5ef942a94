"""The SPMD window layout past 1,024 cameras, on the CPU: the port's mesh
(povar_tpu_torch/parallel/spmd.py) against the port's one-device stage
solvers, which tests/test_torch_large_n.py holds to the JAX package's
XLA layout at these sizes.

- One LM trial of each stage at N = 1300 (test_torch_large_n.py's
  local-span problem on ring cameras) on a D = 2 gloo mesh and on one
  device from the same state: step 1 with POWER_VARPROJ,
  POWER_SCHUR_COMPLEMENT and PCG from the one-device VarProj start,
  step 2 with RIPOBA and RIPCG from its homogenized form. The mesh
  runs the composed power terms (a mesh has no fused-term plan, as in
  the JAX package), the one device its defaults. Checked: the
  VarProj-initialized landmarks within 1e-5 of their largest entry, the
  cost of the state within 1e-12, the trial's decision and power-term
  or CG count identical, its camera step (unscaled), landmarks, l_diff,
  cost decrease and cost within 1e-4: test_torch_large_n.py's
  tolerances, the same f32 math in another summation order.
- The link to the JAX package's own SPMD solver: step 1's
  POWER_VARPROJ trial of the D = 2 gloo mesh against the JAX package's
  SpmdStage1Solver at D = 2 (conftest's virtual CPU devices) from the
  same state, with the same checks. Its windowed kernels run in
  interpret mode, ~35 s for the one trial and its VarProj start, so
  the other four configurations are held to one device only.
- One `bundle_adjust(mesh=make_mesh(1, "cpu"))` at N = 1100 on
  test_torch_large_n.py's well-posed problem (4 + 3 iterations): the
  one-device run's decisions and power-term counts, every cost within
  1e-4.

The gloo ranks import this module, which imports JAX only inside the
fixture that runs the JAX package.
"""

import copy

import numpy as np
import pytest
import torch

from povar_tpu_torch import (
    SolverOptions,
    Stage1Solver,
    Stage2Solver,
    bundle_adjust,
    create_homogeneous,
    make_mesh,
    synthetic_bal_problem,
)
from povar_tpu_torch.parallel import spmd
from povar_tpu_torch.parallel.mesh import spawn

# one torch thread a test process: the CPU tests' tensors are small,
# and a parallel run's xdist workers share the host's cores
torch.set_num_threads(1)

# test_torch_large_n.py's damping of the mixed-precision trial (1e-4
# leaves the f32 step of a 1300-camera problem ill-determined)
LAM = 1e2
TOL = 1e-4
STEP1 = {
    "POWER_VARPROJ": {},
    "POWER_SCHUR_COMPLEMENT": dict(
        solver_type_step_1="POWER_SCHUR_COMPLEMENT"),
    "PCG": dict(solver_type_step_1="PCG"),
}
STEP2 = {
    "RIPOBA": {},
    "RIPCG": dict(solver_type_step_2="RIPCG"),
}


def _options(base):
    """SolverOptions() with the host LM loop and `base` on top (enum
    members by name)."""
    opts = SolverOptions(device_lm_loop="off")
    for k, v in base.items():
        setattr(opts, k, type(getattr(opts, k))[v])
    return opts


def _trial(s, cams, lms, pack, unpack):
    """One LM trial of stage solver `s` at LAM from (cams, lms: numpy,
    canonical landmarks): (the state's cost, {ok, n, cams, lms, l_diff,
    cost}), landmarks canonical again."""
    c = torch.as_tensor(cams)
    lm = pack(lms)
    c0 = float(s.compute_error(c, lm)["error_all"])
    nc, nl, ok, n, ld, err = s.trial(c, lm, s.linearize(c, lm), LAM)
    return c0, dict(ok=bool(ok), n=int(n), cams=nc.numpy(),
                    lms=unpack(nl), l_diff=float(ld),
                    cost=float(err["error_all"]))


def _stages(cls, args, cams, lms, configs, mesh=None):
    """Each configuration's trial (_trial) from one state, on one
    device or on this rank of `mesh`; with step 1 also the
    VarProj-initialized landmarks of the cameras (canonical numpy)."""
    obs_cam, obs_lm, obs_uv, n_cams, n_lms = args
    plan = None if mesh is None else spmd.build_spmd_plan(
        obs_cam, obs_lm, n_cams, n_lms, mesh.size, spmd.PART_ALIGN)
    out = {}
    for name, base in configs.items():
        if mesh is None:
            s = cls(*args, _options(base), device="cpu")

            def pack(x, s=s):
                return s.lm_pack(torch.as_tensor(x))

            def unpack(x, s=s):
                return s.lm_unpack(x).numpy()
        else:
            s = {Stage1Solver: spmd.SpmdStage1Solver,
                 Stage2Solver: spmd.SpmdStage2Solver}[cls](
                plan, obs_uv, n_cams, n_lms, _options(base), mesh)

            def pack(x, s=s):
                return s.lm_pack(s.pad_landmarks(x))

            def unpack(x, s=s):
                return s.unpad_landmarks(s.lm_unpack(x))
        out[name] = _trial(s, cams, lms, pack, unpack)
        if cls is Stage1Solver and "init" not in out:
            out["init"] = unpack(s.lm_pack(s.initialize_varproj(
                torch.as_tensor(cams))))
    return out


def _mesh_stages(mesh, args, state1, state2):
    """Both steps' trials on this rank of `mesh` (the ranks' results must
    agree)."""
    return (_stages(Stage1Solver, args, *state1, STEP1, mesh),
            _stages(Stage2Solver, args, *state2, STEP2, mesh))


@pytest.fixture(scope="module")
def trials():
    """{step: (the starting cameras and landmarks, one device's trials,
    the D = 2 mesh's)} at N = 1300, step 1 from the one-device VarProj start, step
    2 from its homogenized form."""
    from test_torch_large_n import N_CAMS, N_LMS, _ring_problem

    args, cams, _lms = _ring_problem(N_CAMS, N_LMS)
    s = Stage1Solver(*args, _options({}), device="cpu")
    c = torch.as_tensor(cams)
    start = s.lm_unpack(s.initialize_varproj(c)).numpy()
    c2, l2 = create_homogeneous(c, torch.as_tensor(start))
    state1, state2 = (cams, start), (c2.numpy(), l2.numpy())
    one = (_stages(Stage1Solver, args, *state1, STEP1),
           _stages(Stage2Solver, args, *state2, STEP2))
    ranks = spawn(_mesh_stages, 2, "cpu", args=(args, state1, state2))
    for k in range(2):
        for name in ranks[0][k]:
            a, b = ranks[0][k][name], ranks[1][k][name]
            if name == "init":
                np.testing.assert_array_equal(a, b)
            else:
                assert a[0] == b[0] and a[1]["ok"] == b[1]["ok"]
                assert a[1]["n"] == b[1]["n"] and a[1]["cost"] == b[1]["cost"]
    return {step: (state, one[k], ranks[0][k])
            for k, (step, state) in enumerate(((1, state1), (2, state2)))}


@pytest.fixture(scope="module")
def jax_trial(trials):
    """The JAX package's SpmdStage1Solver at D = 2 (POWER_VARPROJ, its
    defaults with the host loop) from trials' step-1 state: the
    VarProj-initialized landmarks and the trial (_trial's form)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JaxMesh

    from povar_tpu.options import SolverOptions as JaxOptions
    from povar_tpu.parallel import spmd as jspmd
    from test_torch_large_n import N_CAMS, N_LMS, _ring_problem

    (obs_cam, obs_lm, obs_uv, n_cams, n_lms), _c, _l = _ring_problem(
        N_CAMS, N_LMS)
    (cams, lms), _one, _mesh = trials[1]
    S1, _S2 = jspmd.get_spmd_solver_classes()
    plan = jspmd.build_spmd_plan(obs_cam, obs_lm, n_cams, n_lms, 2,
                                 spmd.PART_ALIGN)
    opts = JaxOptions()
    opts.device_lm_loop = "off"
    s = S1(plan, obs_uv, n_cams, n_lms, opts,
           JaxMesh(np.asarray(jax.devices()[:2]), ("obs",)))
    c = jnp.asarray(cams)
    init = s.unpad_landmarks(s.lm_unpack(s.initialize_varproj(c)))
    lm = s.lm_pack(s.pad_landmarks(lms))
    c0 = float(s.compute_error(c, lm)["error_all"])
    nc, nl, ok, n, ld, err = s.trial(c, lm, s.linearize(c, lm),
                                     jnp.asarray(LAM, jnp.float64))
    return init, (c0, dict(ok=bool(ok), n=int(n), cams=np.asarray(nc),
                           lms=s.unpad_landmarks(s.lm_unpack(nl)),
                           l_diff=float(ld), cost=float(err["error_all"])))


def _gap(got, want):
    """Largest absolute difference over the largest |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _check_trial(got, want, cams):
    c0_g, g = got
    c0_w, w = want
    assert abs(c0_g - c0_w) <= 1e-12 * abs(c0_w), (c0_g, c0_w)
    assert g["ok"] and w["ok"] and g["n"] == w["n"], (g["n"], w["n"])
    gaps = dict(step=_gap(g["cams"] - cams, w["cams"] - cams),
                lms=_gap(g["lms"], w["lms"]),
                l_diff=_gap(g["l_diff"], w["l_diff"]),
                f_diff=_gap(c0_g - g["cost"], c0_w - w["cost"]),
                cost=_gap(g["cost"], w["cost"]))
    print(f"terms {g['n']}, gaps {gaps}")
    assert all(v <= TOL for v in gaps.values()), gaps


@pytest.mark.parametrize("config", list(STEP1))
def test_mesh_step1_trial_at_1300_cameras(trials, config):
    """Step 1 at N = 1300, D = 2 against one device: the initialized
    landmarks within 1e-5, one trial within 1e-4 (the module
    docstring)."""
    (cams, _lms), one, mesh = trials[1]
    init = _gap(mesh["init"], one["init"])
    print(f"init {init:.2e}")
    assert init <= 1e-5
    _check_trial(mesh[config], one[config], cams)


def test_mesh_step1_trial_matches_jax_spmd(trials, jax_trial):
    """Step 1 at N = 1300, POWER_VARPROJ: the port's D = 2 gloo mesh
    against the JAX package's SPMD solver at D = 2 from the state the
    mesh started from: the initialized landmarks within 1e-5, one trial
    within 1e-4."""
    (cams, _lms), _one, mesh = trials[1]
    init_jax, trial_jax = jax_trial
    init = _gap(mesh["init"], init_jax)
    print(f"init {init:.2e}")
    assert init <= 1e-5
    _check_trial(mesh["POWER_VARPROJ"], trial_jax, cams)


@pytest.mark.parametrize("config", list(STEP2))
def test_mesh_step2_trial_at_1300_cameras(trials, config):
    """Step 2 at N = 1300, D = 2 against one device from the
    homogenized VarProj start: one trial within 1e-4."""
    (cams, _lms), one, mesh = trials[2]
    _check_trial(mesh[config], one[config], cams)


def test_mesh_bundle_adjust_at_1100_cameras():
    """bundle_adjust on a 1-device mesh past 1024 cameras
    (synthetic_bal_problem(1100, 3000, 6, seed=5, noise=1e-3,
    random_cameras=False), 4 + 3 iterations, the host loop) against the
    same run on one device: identical decisions and power-term counts,
    every cost within 1e-4 relative."""
    opts = dict(max_num_iterations_step_1=4, max_num_iterations_step_2=3,
                device_lm_loop="off")
    problem, _ = synthetic_bal_problem(n_cams=1100, n_lms=3000, obs_per_lm=6,
                                       seed=5, noise=1e-3,
                                       random_cameras=False)
    runs = [bundle_adjust(copy.deepcopy(problem), SolverOptions(**opts),
                          log=lambda s: None, device="cpu", mesh=mesh)[1:]
            for mesh in (None, make_mesh(1, "cpu"))]
    worst = 0.0
    for t, j in zip(runs[1], runs[0]):
        assert len(t.iterations) == len(j.iterations)
        for a, b in zip(t.iterations, j.iterations):
            assert a.step_is_successful == b.step_is_successful
            assert a.linear_solver_iterations == b.linear_solver_iterations
            if a.cost is not None:
                worst = max(worst, abs(a.cost.all.error - b.cost.all.error)
                            / abs(b.cost.all.error))
        assert t.termination_type == j.termination_type
    print(f"largest cost gap {worst:.2e}")
    assert worst <= 1e-4

"""N > 1024 on one device: povar_tpu_torch against povar_tpu on the CPU.

The port gathers and sums by camera index, so one device takes any
camera count. The JAX package reaches past its 1024-camera one-hot
limit on the TPU through camera windows (povar_tpu/solver/segments.py
build_window_plan), which its own tests (tests/test_windowed.py) hold
to its XLA layout; here the port is held to that XLA layout, the same
solves without the windows' Pallas kernels (in interpret mode on the
CPU, ~30 s a trial at N = 1300). Both solve the same problem at the
same state:

- stage by stage at N = 1300 on a local-span problem: each of 3000
  landmarks seen by up to 6 cameras within 30 of a random centre
  (tests/test_windowed.py's `_local_problem`, copied here), its image
  points projected through 1300 ring cameras with 1e-3 of noise, and
  the cameras and landmarks perturbed by 1e-2 (tools/step2_spread.py's
  `ring_case` geometry at N = 1300). With `_local_problem`'s random
  image points, or its 4 cameras a landmark, the problem is so
  ill-conditioned that f32 rounding alone moves a trial's step by up to
  2e-2 of its largest entry in either package, and the JAX package's own
  windowed and XLA layouts give initial landmarks 1.4e-4 apart (pure f64
  agrees to 1e-11 there). The stages run the structured defaults (the
  fused power term),
  POWER_SCHUR_COMPLEMENT and PCG in step 1 and RIPOBA and RIPCG in step
  2, and
  for pallas_kernels="off" and pure f64 (mixed_precision_solves=False;
  the port's unstructured layout): the VarProj-initialized
  landmarks, then from one state (each package linearizing it) one LM
  trial, its power-term or CG count, its camera step (the increment
  unscaled), its landmarks, l_diff and its cost decrease, and the cost
  of one state;
- CHOLESKY's dense route at N = 1100 in pure f64 against the JAX
  package's converged pure-f64 PCG, the choice of its dense or banded
  route by bytes, and the banded route at N = 1600;
- one `bundle_adjust` trajectory at N = 1100 on a well-posed
  synthetic_bal_problem (each package's defaults on the CPU: the JAX
  package's XLA layout, the port's structured one);
- a mesh past 1024 cameras: its plan built and a step taken (the mesh
  at these sizes against one device: tests/test_torch_mesh_large_n.py);
- `add_loop_closures_and_scramble`, array for array.

The tolerances are those of the N <= 1024 tests: the initialized
landmarks 1e-5 of their largest entry (tests/test_torch_stage1.py), the
trial's outputs 1e-4 (tests/test_torch_poba.py: camera step, landmarks,
l_diff and cost decrease from each package's own increment), the cost of
one state 1e-12 (the f64 cost kernels), pure f64 1e-8
(tests/test_torch_f64_steps.py); decisions and counts identical, the
trajectory's costs 1e-4 (tests/test_torch_stage2.py's
test_bundle_adjust_matches_jax). The gaps measured here are in each
test's docstring. Each JAX executable runs once in the module: the
configurations whose JAX options agree share one JAX solver and its
results (`jax_runs`).
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from povar_tpu.options import SolverOptions as JaxOptions
from povar_tpu.problem.synthetic import (
    add_loop_closures_and_scramble as jax_scramble,
)
from povar_tpu.problem.synthetic import synthetic_bal_problem
from povar_tpu.problem.synthetic import (
    synthetic_bal_problem_fast as jax_fast,
)
from povar_tpu.solver.pipeline import bundle_adjust as jax_bundle_adjust
from povar_tpu.solver.stage1 import Stage1Solver as JaxStage1
from povar_tpu.solver.stage2 import Stage2Solver as JaxStage2
from povar_tpu.solver.stage2 import create_homogeneous as jax_homogeneous
from povar_tpu_torch import (
    SolverOptions,
    Stage1Solver,
    Stage2Solver,
    bundle_adjust,
    create_homogeneous,
    from_numpy,
    make_mesh,
)
from povar_tpu_torch.ops import pose_kernels
from povar_tpu_torch.problem.synthetic import (
    _ring_cameras,
    add_loop_closures_and_scramble,
    synthetic_bal_problem_fast,
)
from povar_tpu_torch.solver import band_chol

# one torch thread a test process: the CPU tests' tensors are small,
# and a parallel run's xdist workers share the host's cores
torch.set_num_threads(1)

N_CAMS, N_LMS, TRACK, SPREAD = 1300, 3000, 6, 30
# camera i sits at ring position STRIDE i mod N, so that the cameras of
# one landmark (indices within SPREAD) see it from ~60 degrees apart
STRIDE = 7
# the trial's damping: at 1e-4 the f32 step of a 1300-camera problem is
# ill-determined along its flat modes (the port and the JAX package, and
# the JAX package's own windowed and XLA layouts, agree on its cost
# decrease to 1e-7 but on its largest camera entries only to 2e-2, where
# pure f64 agrees to 1e-11); the N <= 1024 tests' other damping, 1e2,
# determines it; pure f64 runs at 1e-4
LAM, LAM_F64 = 1e2, 1e-4

# step-1 and step-2 configurations (options by name, as the JAX package
# and the port take them). The JAX package runs each on its XLA layout
# (pallas_kernels="off"), so "off" and the defaults share its solver
STEP1 = {
    "defaults": {},
    "psc": dict(solver_type_step_1="POWER_SCHUR_COMPLEMENT"),
    "pcg": dict(solver_type_step_1="PCG"),
    "off": dict(pallas_kernels="off"),
    "f64": dict(mixed_precision_solves=False),
}
STEP2 = {
    "ripoba": {},
    "ripcg": dict(solver_type_step_2="RIPCG"),
    "off": dict(pallas_kernels="off"),
    "f64": dict(mixed_precision_solves=False),
}
# the trial's tolerance: 1e-4 in mixed precision, 1e-8 in pure f64
TRIAL_TOL = {"f64": 1e-8}
# the configurations whose landmark initialization and cost of one state
# are held to the JAX package's too (the others share them: the same
# layout and cost kernels; each JAX check compiles its own executable)
FULL = {"defaults", "ripoba", "off", "f64"}


def _local_problem(rng, n_cams, n_lms, spread=30, k=4):
    """tests/test_windowed.py:27-42: each landmark's cameras within
    `spread` of a random centre, random image points."""
    centers = rng.integers(0, n_cams - spread, n_lms)
    obs_lm, obs_cam, obs_uv = [], [], []
    for m in range(n_lms):
        cams = np.unique(centers[m] + rng.integers(0, spread, k))
        while len(cams) < 2:
            cams = np.unique(centers[m] + rng.integers(0, spread, k))
        for c in cams:
            obs_lm.append(m)
            obs_cam.append(c)
            obs_uv.append(rng.standard_normal(2) * 0.3)
    return (
        np.array(obs_lm),
        np.array(obs_cam),
        np.array(obs_uv),
    )


def _options(cls, base, **kw):
    """`cls()` with the host LM loop and `base` / `kw` on top (enum
    members by name); the JAX package on its XLA layout."""
    opts = cls()
    opts.device_lm_loop = "off"
    for k, v in {**base, **kw}.items():
        if isinstance(v, str) and k.startswith("solver_type"):
            v = type(getattr(opts, k))[v]
        setattr(opts, k, v)
    if cls is JaxOptions:
        opts.pallas_kernels = "off"
    return opts


def _ring_problem(n_cams, n_lms, seed=3):
    """(solver arguments, cameras [N, 3, 4], landmarks [M, 3]) of a
    local-span problem on ring cameras (the module docstring)."""
    rng = np.random.default_rng(seed)
    gt_cams = _ring_cameras(n_cams, radius=10.0, rng=rng)[
        np.arange(n_cams) * STRIDE % n_cams]
    pts = rng.standard_normal((n_lms, 3)) * 2.0
    obs_lm, obs_cam, _uv = _local_problem(rng, n_cams, n_lms, spread=SPREAD,
                                          k=TRACK)
    xh = np.concatenate([pts, np.ones((n_lms, 1))], axis=1)
    p = np.einsum("oij,oj->oi", gt_cams[obs_cam], xh[obs_lm])
    obs_uv = p[:, :2] / p[:, 2:3] + 1e-3 * rng.standard_normal(
        (len(obs_cam), 2))
    cams = gt_cams + 1e-2 * rng.standard_normal(gt_cams.shape)
    lms = pts + 1e-2 * rng.standard_normal(pts.shape)
    return (obs_cam, obs_lm, obs_uv, n_cams, n_lms), cams, lms


@pytest.fixture(scope="module")
def local():
    """The N = 1300 problem (_ring_problem)."""
    return _ring_problem(N_CAMS, N_LMS)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's solvers of the module, with their results: {(
    solver class, options): (solver, {result key: result})}."""
    return {}


def _jax(memo, cls, args, base):
    """The JAX package's `cls` solver of configuration `base` on the
    problem `args` and its results (built once per distinct JAX options:
    pallas_kernels is "off" on its XLA layout whatever `base` says)."""
    key = (cls.__name__, args[3], tuple(sorted(
        (k, v) for k, v in base.items() if k != "pallas_kernels")))
    if key not in memo:
        js = cls(*args, _options(JaxOptions, base))
        assert js.n_win == 0
        memo[key] = js, {}
    return memo[key]


def _once(results, key, fn):
    """results[key], computed by fn() the first time."""
    if key not in results:
        results[key] = fn()
    return results[key]


def _jax_init(js, results, cams):
    """The JAX package's VarProj-initialized landmarks (numpy [M, 3])."""
    return _once(results, "init", lambda: np.asarray(
        js.lm_unpack(js.initialize_varproj(jnp.asarray(cams)))))


def _jax_cost(js, results, cams, lms):
    """The JAX package's cost of the module's state (cams, lms)."""
    return _once(results, "cost", lambda: float(js.compute_error(
        jnp.asarray(cams), js.lm_pack(jnp.asarray(lms)))["error_all"]))


@pytest.fixture(scope="module")
def start(local, jax_runs):
    """Step 1's state: the VarProj-initialized landmarks (the JAX
    package's, on its XLA layout, with SolverOptions() defaults) at the
    N = 1300 cameras (numpy [M, 3])."""
    args, cams, _lms = local
    return _jax_init(*_jax(jax_runs, JaxStage1, args, {}), cams)


def _gap(got, want):
    """Largest absolute difference over the largest |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _trial_gaps(jax, ts, cams, lms, c0_j, c0_t, lam):
    """One LM trial at damping `lam` of each package from the same state
    (cams, lms: numpy), each linearizing it (the JAX package's once per
    solver, state and damping: `jax` is _jax's pair): (power-term or CG
    counts, the gaps of the camera step, the landmarks, l_diff and the
    cost decrease)."""
    js, results = jax

    def jax_trial():
        jl = js.lm_pack(jnp.asarray(lms))
        jc = jnp.asarray(cams)
        jnc, jnl, jok, jn, jld, jerr = js.trial(
            jc, jl, js.linearize(jc, jl), jnp.asarray(lam, jnp.float64))
        return (np.asarray(jnc), np.asarray(js.lm_unpack(jnl)), bool(jok),
                int(jn), float(jld), float(jerr["error_all"]))

    jnc, jnl, jok, jn, jld, jerr = _once(
        results, ("trial", cams.tobytes(), lms.tobytes(), lam), jax_trial)
    tl = ts.lm_pack(torch.as_tensor(lms))
    tc = torch.as_tensor(cams)
    tnc, tnl, tok, tn, tld, terr = ts.trial(tc, tl, ts.linearize(tc, tl), lam)
    assert jok and bool(tok)
    gaps = dict(
        step=_gap(tnc.numpy() - cams, jnc - cams),
        lms=_gap(ts.lm_unpack(tnl).numpy(), jnl),
        l_diff=_gap(float(tld), jld),
        f_diff=_gap(c0_t - float(terr["error_all"]), c0_j - jerr),
    )
    return (int(tn), jn), gaps


@pytest.mark.parametrize("config", list(STEP1))
def test_step1_at_1300_cameras_matches_jax(local, start, jax_runs,
                                           config):
    """Step 1 at N = 1300 ("off" and pure f64 on the port's unstructured
    layout): the initialized landmarks within 1e-5 (measured 3.8e-6:
    both packages' f32 initializations lie 1e-5 from the f64 one here;
    1.1e-14 in f64), the cost of the same state within 1e-12, one
    trial's counts identical and its outputs within 1e-4 (measured <=
    4.7e-6; pure f64 at 1e-4 damping: 1e-8, measured <= 3.6e-12)."""
    args, cams, _lms = local
    base = STEP1[config]
    jax = _jax(jax_runs, JaxStage1, args, base)
    ts = Stage1Solver(*args, _options(SolverOptions, base), device="cpu")
    assert ts.unstructured == (config in ("off", "f64"))
    tc = torch.as_tensor(cams)
    c0_t = float(ts.compute_error(tc, ts.lm_pack(torch.as_tensor(start)))[
        "error_all"])
    c0_j, init = c0_t, None
    if config in FULL:
        init = _gap(ts.lm_unpack(ts.initialize_varproj(tc)).numpy(),
                    _jax_init(*jax, cams))
        assert init <= 1e-5, init
        c0_j = _jax_cost(*jax, cams, start)
        np.testing.assert_allclose(c0_t, c0_j, rtol=1e-12)
    lam = LAM_F64 if config == "f64" else LAM
    (tn, jn), gaps = _trial_gaps(jax, ts, cams, start, c0_j, c0_t, lam)
    print(f"{config}: init {init}, terms {tn}, gaps {gaps}")
    assert tn == jn
    tol = TRIAL_TOL.get(config, 1e-4)
    assert all(g <= tol for g in gaps.values()), gaps


def test_cholesky_at_1100_cameras_matches_jax():
    """CHOLESKY's dense route past 1024 cameras: N = 1100 cameras and
    1200 landmarks (_ring_problem; A [13200, 3600] and S [13200, 13200],
    1.7 GB in f64). One pure-f64 trial at damping 1e2 against the JAX
    package's pure-f64 PCG converged to eta = 1e-14 on its XLA layout,
    which solves the same damped reduced camera system (the JAX
    package's own CHOLESKY agrees with it to 1.4e-10 at N = 60; its
    dense route, a Cholesky unrolled over 13,200 columns, does not
    compile here): camera step, landmarks, l_diff and cost decrease
    within 1e-8 (measured <= 3.2e-12). The mixed-precision trial runs
    the same code in f32, where S is formed as a difference (its camera
    step 1.2e-2 from f64 in either package at N = 60, the port's within
    2.5e-6 of the JAX package's there; 0.61 here): its increment finite
    and its cost decrease within 1e-3 of the f64 one (measured
    1.7e-4)."""
    args, cams, lms = _ring_problem(1100, 1200)
    jax = _jax({}, JaxStage1, args, dict(
        STEP1["f64"], solver_type_step_1="PCG", eta=1e-14,
        max_linear_solver_iterations=2000))
    c0 = _jax_cost(*jax, cams, lms)
    for config in ("f64", "defaults"):
        ts = Stage1Solver(*args, _options(SolverOptions, STEP1[config],
                                          solver_type_step_1="CHOLESKY"),
                          device="cpu")
        (tn, _jn), gaps = _trial_gaps(jax, ts, cams, lms, c0, c0, 1e2)
        print(f"CHOLESKY {config}: gaps {gaps}")
        assert tn == 0
        if config == "f64":
            assert all(g <= 1e-8 for g in gaps.values()), gaps
        else:
            assert gaps["f_diff"] <= 1e-3, gaps


def test_cholesky_refuses_what_the_device_cannot_hold():
    """CHOLESKY's route by bytes (chol_route): the dense one up to 1536
    cameras while its A and S fit the device, the banded one otherwise:
    venice-1778's 993,923 landmarks at 1536 cameras take 221 GB in f32
    against an 80 GB card (band), N = 1100, M = 1200 in f64 (1.7 GB)
    fits (dense), the host has no limit (dense), and past 1536 cameras
    the route is the band whatever the bytes. What the banded route
    itself cannot hold (band_chol_unsupported: the plan's index arrays
    and one solve's peak beside what the device already holds) raises
    naming the bytes and the ROADMAP item."""
    from povar_tpu_torch.solver.stage1 import (
        band_chol_unsupported, chol_route, dense_chol_bytes,
    )

    card = 80 * 2**30
    assert dense_chol_bytes(1100, 1200, torch.float64) == 8 * 13200 * (
        3600 + 13200)
    assert chol_route(1100, 1200, torch.float64, card) == "dense"
    assert chol_route(1536, 993_923, torch.float32, None) == "dense"
    assert chol_route(1536, 993_923, torch.float32, card) == "band"
    assert chol_route(1537, 10, torch.float32, None) == "band"
    assert chol_route(1537, 10, torch.float32, card) == "band"

    p = synthetic_bal_problem_fast(300, 500, 5, seed=2, locality=16)
    plan = band_chol.build_band_plan(p.obs_cam, p.obs_lm, 300, 500)
    need = (band_chol.plan_bytes(plan.arrays)
            + band_chol.solve_bytes(plan.meta, plan.arrays, torch.float64))
    assert band_chol.solve_bytes(plan.meta, plan.arrays, torch.float64) == (
        2 * band_chol.solve_bytes(plan.meta, plan.arrays, torch.float32))
    assert band_chol_unsupported(plan, torch.float64, None) is None
    assert band_chol_unsupported(plan, torch.float64, need) is None
    why = band_chol_unsupported(plan, torch.float64, need, held=1)
    assert "banded solve at 300 cameras" in why, why
    assert "GB" in why and "ROADMAP" in why, why


@pytest.fixture(scope="module")
def state2(local):
    """Step 2's state: the N = 1300 cameras and landmarks homogenized by
    the JAX package (numpy cameras [N, 3, 4], landmarks [M, 4])."""
    _args, cams, lms = local
    c, l4 = jax_homogeneous(jnp.asarray(cams), jnp.asarray(lms))
    return np.asarray(c), np.asarray(l4)


@pytest.mark.parametrize("config", list(STEP2))
def test_step2_at_1300_cameras_matches_jax(local, state2, jax_runs,
                                           config):
    """Step 2 at N = 1300 from the homogenized state: the cost of the
    state within 1e-12 and one trial's counts identical, its outputs
    within 1e-4 (measured <= 7.1e-6; pure f64 at 1e-4 damping: 1e-8,
    measured <= 4.1e-11). The port homogenizes as the JAX package does
    (to 1e-15)."""
    args, cams0, lms0 = local
    cams, lms = state2
    base = STEP2[config]
    jax = _jax(jax_runs, JaxStage2, args, base)
    ts = Stage2Solver(*args, _options(SolverOptions, base), device="cpu")
    tc, tl = create_homogeneous(torch.as_tensor(cams0),
                                torch.as_tensor(lms0))
    assert _gap(tc.numpy(), cams) <= 1e-15
    assert _gap(tl.numpy(), lms) <= 1e-15
    c0_t = float(ts.compute_error(torch.as_tensor(cams),
                                  ts.lm_pack(torch.as_tensor(lms)))[
        "error_all"])
    c0_j = c0_t
    if config in FULL:
        c0_j = _jax_cost(*jax, cams, lms)
        np.testing.assert_allclose(c0_t, c0_j, rtol=1e-12)
    lam = LAM_F64 if config == "f64" else LAM
    (tn, jn), gaps = _trial_gaps(jax, ts, cams, lms, c0_j, c0_t, lam)
    print(f"{config}: terms {tn}, gaps {gaps}")
    assert tn == jn
    tol = TRIAL_TOL.get(config, 1e-4)
    assert all(g <= tol for g in gaps.values()), gaps


def test_bundle_adjust_at_1100_cameras_matches_jax():
    """bundle_adjust on synthetic_bal_problem(1100, 3000, 6, seed=5,
    noise=1e-3, random_cameras=False), step 1 capped at 4 iterations and
    step 2 at 3, each package's defaults on the CPU (the port's
    structured layout, the JAX package's XLA one): identical decisions
    and power-term counts, every cost within 1e-4 relative (measured
    3.4e-5). From random cameras (the initialization-free start) step 1
    ends each package's run in its own point of a flat valley (6.2182
    against 6.2250 after 40 iterations, the same gap between the two
    packages' unstructured layouts), from which step 2 starts 3x apart;
    pure f64 moves step 2's start by 3e-7 and its fourth cost by 4e-4:
    that start is no well-posed comparison at this size."""
    opts = dict(max_num_iterations_step_1=4, max_num_iterations_step_2=3)
    jp, _ = synthetic_bal_problem(n_cams=1100, n_lms=3000, obs_per_lm=6,
                                  seed=5, noise=1e-3, random_cameras=False)
    jo = JaxOptions(**opts)
    jo.device_lm_loop = "off"
    tp, _c, _l = from_numpy(jp.obs_cam, jp.obs_lm, jp.obs_uv, jp.cam_space,
                            jp.lm_p, device="cpu")
    _, j1, j2 = jax_bundle_adjust(copy.deepcopy(jp), jo, log=lambda s: None)
    _, t1, t2 = bundle_adjust(tp, SolverOptions(device_lm_loop="off",
                                                **opts),
                              log=lambda s: None, device="cpu")
    worst = 0.0
    for t, j in ((t1, j1), (t2, j2)):
        assert len(t.iterations) == len(j.iterations)
        for a, b in zip(t.iterations, j.iterations):
            assert a.step_is_successful == b.step_is_successful
            assert a.linear_solver_iterations == b.linear_solver_iterations
            assert (a.cost is None) == (b.cost is None)
            if a.cost is not None:
                worst = max(worst, abs(a.cost.all.error - b.cost.all.error)
                            / abs(b.cost.all.error))
        assert t.termination_type == j.termination_type
    print(f"largest cost gap {worst:.2e}")
    assert worst <= 1e-4


def test_refusals_past_the_single_device_limits():
    """Past 1024 cameras a mesh builds its plan and takes a step: at 1600
    cameras `bundle_adjust` on a 1-device mesh (one iteration a step)
    accepts step 1's first trial, its cost decrease within 1e-4 of one
    device's;
    one device runs 1600 cameras with every step-1 solver, CHOLESKY on
    the banded plan (its dense route ends at 1536 cameras)."""
    p = synthetic_bal_problem_fast(1600, 900, 4, seed=0, locality=32)
    one_iteration = dict(max_num_iterations_step_1=1,
                         max_num_iterations_step_2=1, device_lm_loop="off")
    on_mesh = copy.deepcopy(p)
    runs = [bundle_adjust(q, SolverOptions(**one_iteration), device="cpu",
                          log=lambda s: None, mesh=mesh)[1]
            for q, mesh in ((on_mesh, make_mesh(1, "cpu")),
                            (copy.deepcopy(p), None))]
    assert on_mesh._spmd_plan_cache[1].n_dev == 1
    its, one = runs[0].iterations, runs[1].iterations
    assert len(its) == 2 and its[1].step_is_successful
    assert its[1].cost.all.error < its[0].cost.all.error
    # the cost falls 4,500x: compared as its decrease (the trials' f_diff)
    np.testing.assert_allclose(its[0].cost.all.error - its[1].cost.all.error,
                               one[0].cost.all.error - one[1].cost.all.error,
                               rtol=1e-4)
    args = (p.obs_cam, p.obs_lm, p.obs_uv, p.num_cameras, p.num_landmarks)
    s = Stage1Solver(*args, _options(SolverOptions, {},
                                     solver_type_step_1="CHOLESKY"),
                     device="cpu")
    assert s._band_plan is not None and not s._chol_pcg_fallback
    assert s._band_plan.meta.n_cams == 1600
    assert s._band_plan.meta.bw <= band_chol.MAX_SUPERNODE
    for st in ("POWER_VARPROJ", "POWER_SCHUR_COMPLEMENT", "PCG"):
        Stage1Solver(*args, _options(SolverOptions, {},
                                     solver_type_step_1=st), device="cpu")


def test_add_loop_closures_and_scramble_matches_jax():
    """The port's copy gives the JAX package's arrays, bit for bit, from
    the same base problem and seed."""
    base_t = synthetic_bal_problem_fast(300, 500, 5, seed=2, locality=16)
    base_j = jax_fast(300, 500, 5, seed=2, locality=16)
    got = add_loop_closures_and_scramble(base_t, 0.02, seed=4)
    want = jax_scramble(base_j, 0.02, seed=4)
    for f in ("cam_space", "intrinsics", "lm_p", "obs_cam", "obs_lm",
              "obs_uv"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.input_path == want.input_path
    assert got.num_landmarks == 510 and got.num_cameras == 300


def test_kernel_index_limits():
    """Every kernel wrapper refuses, before any launch, an O or N past
    what the kernels' int32 C interface indexes, and takes final-13682's
    (22,929,408 slot rows, 13,682 cameras)."""
    pose_kernels._index_limits("prepare", 22_929_408, 13_682)
    with pytest.raises(ValueError, match="prepare: .* int32"):
        pose_kernels._index_limits("prepare", 2**31, 13_682)
    with pytest.raises(ValueError, match=r"hppb2: .*\[144, N\]"):
        pose_kernels._index_limits("hppb2", 1024,
                                   pose_kernels.MAX_KERNEL_CAMERAS + 1)

"""The port's SPMD window layout on the JAX package's multi-device dryrun
problem (__graft_entry__.py's dryrun_multichip:
synthetic_bal_problem(40, 300, 5, seed=1), m = 3 power terms, 4 + 3
iterations) against the JAX package's SPMD solvers at the same device
count: D = 2 (the port as two gloo ranks, JAX on two of conftest's
virtual CPU devices) and D = 1 (both in process), on the CPU.

- Step 1 from the start: the same accept/reject decisions and
  power-term counts, costs within 1e-3 and lambdas within 1e-4 (the
  port's tolerances, tests/test_torch_stage1.py).
- Step 2 from JAX's own homogenized step-1 end state, passed as numpy
  (from a non-converged, noise-free step 1 the two packages' step-2
  starts are percent apart): the first trial, at lambda 1e-4, is
  rejected by both, JAX's with a NaN increment (MULTICHIP_r05's NaN,
  which JAX's single-device solve shows from the same state too), and
  both raise lambda alike. Past that trial the two part, and no
  solver in mixed precision could be held to another there: one
  landmark's tangent normal block is singular to f32 at this state, so
  JAX's own mixed-precision step 2 takes other decisions when the state
  moves by 1e-12 relative, where its f64 step 2 does not move (the
  witness test below; ROADMAP.md queue 3). So this state is held to its
  first decision; step 2's LM loop on the mesh is held to JAX's
  decisions and costs on a well-conditioned state in
  tests/test_torch_spmd.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from povar_tpu.options import SolverOptions as JaxOptions
from povar_tpu.problem.synthetic import (
    synthetic_bal_problem as jax_synthetic_bal_problem,
)
from povar_tpu.solver.lm import optimize_step1 as jax_optimize_step1
from povar_tpu.solver.lm import optimize_step2 as jax_optimize_step2
from povar_tpu.solver.pipeline import _make_solver
from povar_tpu.solver.stage1 import Stage1Solver as JaxStage1Solver
from povar_tpu.solver.stage2 import Stage2Solver as JaxStage2Solver
from povar_tpu.solver.stage2 import create_homogeneous as jax_homogeneous
from povar_tpu.utils.summary import SolverSummary as JaxSummary
from povar_tpu.utils.timer import Timer as JaxTimer
from povar_tpu_torch import (
    SolverOptions,
    SolverSummary,
    Stage2Solver,
    Timer,
    create_homogeneous,
    make_mesh,
    optimize_step1,
    optimize_step2,
    synthetic_bal_problem,
)
from povar_tpu_torch.parallel import spmd as tspmd
from povar_tpu_torch.parallel.mesh import spawn

# one torch thread a test process: the CPU tests' tensors are small,
# and a parallel run's xdist workers share the host's cores
torch.set_num_threads(1)

PROBLEM = dict(n_cams=40, n_lms=300, obs_per_lm=5, seed=1)


def _options(cls):
    o = cls()
    o.power_sc_iterations = 3
    o.max_num_iterations_step_1 = 4
    o.max_num_iterations_step_2 = 3
    return o


def _records(summary):
    return [(it.step_is_successful, it.linear_solver_iterations,
             None if it.cost is None else it.cost.all.error,
             it.trust_region_radius) for it in summary.iterations]


def _jax_dryrun(n_dev):
    """JAX's SPMD step 1 on n_dev devices, as its bundle_adjust runs it,
    then its SPMD step 2 from the homogenized end state (at D = 1 also
    its single-device step 2 from that state). Returns (step-1 records,
    end state (cameras, canonical landmarks), step-2 records, the
    single-device step-2 records or None)."""
    problem, _ = jax_synthetic_bal_problem(**PROBLEM)
    opts = _options(JaxOptions)
    mesh = JaxMesh(np.asarray(jax.devices()[:n_dev]), ("obs",))
    s1 = _make_solver(JaxStage1Solver, problem, opts, jnp.float64, mesh)
    assert hasattr(s1, "pad_landmarks")  # the SPMD path, not GSPMD
    sum1 = JaxSummary()
    cams, lms = jax_optimize_step1(
        s1, jnp.asarray(problem.cam_space), s1.pad_landmarks(problem.lm_p),
        opts, sum1, JaxTimer(), log=lambda s: None)
    state = (np.asarray(cams), s1.unpad_landmarks(lms))
    s2 = _make_solver(JaxStage2Solver, problem, opts, jnp.float64, mesh)
    c, lh = jax_homogeneous(jnp.asarray(state[0]), s2.pad_landmarks(state[1]))
    sum2 = JaxSummary()
    jax_optimize_step2(s2, c, lh, opts, sum2, JaxTimer(), log=lambda s: None)
    single = None
    if n_dev == 1:  # the single-device solve from the same state
        s2 = _make_solver(JaxStage2Solver, problem, opts, jnp.float64, None)
        single = JaxSummary()
        jax_optimize_step2(s2, *jax_homogeneous(jnp.asarray(state[0]),
                                                jnp.asarray(state[1])),
                           opts, single, JaxTimer(), log=lambda s: None)
        single = _records(single)
    return _records(sum1), state, _records(sum2), single


def _port_dryrun(mesh, jax_state):
    """The port's SPMD step 1 on this rank's mesh, then its step 2 from
    JAX's end state `jax_state`; the records of both."""
    problem, _ = synthetic_bal_problem(**PROBLEM)
    opts = _options(SolverOptions)
    plan = tspmd.build_spmd_plan(problem.obs_cam, problem.obs_lm,
                                 problem.num_cameras, problem.num_landmarks,
                                 mesh.size, tspmd.PART_ALIGN)
    args = (plan, problem.obs_uv, problem.num_cameras, problem.num_landmarks,
            opts, mesh)
    s1 = tspmd.SpmdStage1Solver(*args)
    sum1 = SolverSummary()
    optimize_step1(s1, torch.as_tensor(problem.cam_space),
                   s1.pad_landmarks(problem.lm_p), opts, sum1, Timer(),
                   log=lambda s: None)
    s2 = tspmd.SpmdStage2Solver(*args)
    c, lh = create_homogeneous(torch.tensor(jax_state[0]),
                               s2.pad_landmarks(jax_state[1]))
    sum2 = SolverSummary()
    optimize_step2(s2, c, lh, opts, sum2, Timer(), log=lambda s: None)
    return _records(sum1), _records(sum2)


@pytest.fixture(scope="module")
def runs():
    """{D: (JAX's records and state, the port's records)}; the port at
    D = 2 as two gloo ranks, whose records must agree."""
    out = {}
    for n_dev in (2, 1):
        jax_run = _jax_dryrun(n_dev)
        if n_dev == 1:
            port = _port_dryrun(make_mesh(1, "cpu"), jax_run[1])
        else:
            ranks = spawn(_port_dryrun, 2, "cpu", args=(jax_run[1],))
            assert ranks[0] == ranks[1]  # every rank takes the decisions
            port = ranks[0]
        out[n_dev] = (jax_run, port)
    return out


@pytest.mark.parametrize("n_dev", [2, 1])
def test_dryrun_step1_matches_jax(runs, n_dev):
    (want, _state, _s2, _single), (got, _) = runs[n_dev]
    assert len(got) == len(want) == 5
    assert [r[:2] for r in got] == [r[:2] for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[2], w[2], rtol=1e-3)
        np.testing.assert_allclose(g[3], w[3], rtol=1e-4)


@pytest.mark.parametrize("n_dev", [2, 1])
def test_dryrun_step2_first_trial_from_jax_state(runs, n_dev):
    """From JAX's end state both start at the same cost, reject the
    first step-2 trial, JAX's increment NaN, and retry at the same lambda
    (the trust region radius the rejection leaves)."""
    (_s1, _state, want, _single), (_, got) = runs[n_dev]
    np.testing.assert_allclose(got[0][2], want[0][2], rtol=1e-12)
    assert not want[1][0] and want[1][2] is None  # the NaN increment
    assert not got[1][0]
    np.testing.assert_allclose(got[1][3], want[1][3], rtol=1e-4)


def test_dryrun_nan_comes_from_the_state(runs):
    """The NaN is not the SPMD layout's: JAX's single-device step 2
    (its unstructured layout off the TPU) from the same step-1 end state
    rejects its first trial with a NaN increment too."""
    (_s1, _state, _s2, single), _port = runs[1]
    assert not single[1][0] and single[1][2] is None


def _jax_single_step2(state, mixed):
    """JAX's single-device step 2 from `state` (cameras, canonical
    landmarks), in mixed precision or in f64; its records."""
    problem, _ = jax_synthetic_bal_problem(**PROBLEM)
    opts = _options(JaxOptions)
    opts.mixed_precision_solves = mixed
    s2 = _make_solver(JaxStage2Solver, problem, opts, jnp.float64, None)
    out = []
    for cams, lms in state:
        summary = JaxSummary()
        jax_optimize_step2(s2, *jax_homogeneous(jnp.asarray(cams),
                                                jnp.asarray(lms)),
                           opts, summary, JaxTimer(), log=lambda s: None)
        out.append(_records(summary))
    return out


def _port_single_step2(state):
    """The port's single-device step 2 from `state`; its records."""
    problem, _ = synthetic_bal_problem(**PROBLEM)
    opts = _options(SolverOptions)
    s2 = Stage2Solver(problem.obs_cam, problem.obs_lm, problem.obs_uv,
                      problem.num_cameras, problem.num_landmarks, opts,
                      device="cpu")
    summary = SolverSummary()
    optimize_step2(s2, *create_homogeneous(torch.tensor(state[0]),
                                           torch.tensor(state[1])),
                   opts, summary, Timer(), log=lambda s: None)
    return _records(summary)


def _moved(a, b):
    """Whether two step-2 runs part: another decision, or a trial cost
    more than 1e-3 apart."""
    return [r[0] for r in a] != [r[0] for r in b] or any(
        x[2] is not None and y[2] is not None
        and abs(x[2] - y[2]) > 1e-3 * abs(y[2]) for x, y in zip(a, b))


def test_dryrun_step2_from_jax_state_turns_on_f32_rounding(runs):
    """The witness for holding step 2 from JAX's state to its first
    decision. JAX's state and the same state nudged by 1e-12 relative
    (seeded normal factors): JAX's f64 step 2 takes the same decisions
    from both, costs within 1e-7 (measured 7.5e-10), and accepts the first trial that
    mixed precision rejects; JAX's mixed-precision step 2 parts from
    itself under the nudge, as the port's single-device step 2 does. So
    the trials after the first turn on f32 rounding in both packages,
    and both packages' layouts (mesh and single device) give other
    trials. Prints every trajectory."""
    (_s1, state, jax_mesh, jax_single), (_, port_mesh) = runs[1]
    rng = np.random.default_rng(0)
    nudged = tuple(a * (1.0 + 1e-12 * rng.standard_normal(a.shape))
                   for a in state)
    f64, f64_nudged = _jax_single_step2((state, nudged), mixed=False)
    (jax_nudged,) = _jax_single_step2((nudged,), mixed=True)
    port_single = _port_single_step2(state)
    port_nudged = _port_single_step2(nudged)
    for name, rec in (("JAX mesh", jax_mesh), ("JAX single", jax_single),
                      ("JAX single, nudged", jax_nudged),
                      ("JAX f64", f64), ("JAX f64, nudged", f64_nudged),
                      ("port mesh", port_mesh),
                      ("port single", port_single),
                      ("port single, nudged", port_nudged)):
        print(f"{name:20s}", [(ok, cost) for ok, _n, cost, _r in rec])
    assert not _moved(f64, f64_nudged)
    for x, y in zip(f64, f64_nudged):
        np.testing.assert_allclose(x[2], y[2], rtol=1e-7)
    assert f64[1][0] and not jax_single[1][0] and not port_single[1][0]
    assert _moved(jax_nudged, jax_single)
    assert _moved(port_nudged, port_single)

"""Pure f64 (`mixed_precision_solves=False` with an f64 LM state, one
device) of povar_tpu_torch end to end: `bundle_adjust` against povar_tpu's
pure f64, the golden f64 problem of tests/test_golden.py, the Eigen
reference harness's step-1 trajectory (csrc/ref_step1_solver, as
tests/test_reference_parity.py runs it for the JAX package), and the
command-line app with `--no-solver-mixed-precision-solves`, all on the
CPU (the camera-table kernels' plain versions in f64).

Tolerances are the Eigen test's (tests/test_reference_parity.py:150-178):
costs 1e-10 relative, trust radii 1e-9, final states 1e-8 absolute, and
the golden test's own (initial cost 1e-10, final costs 1e-6); decisions
and inner counts exactly. Each test states the gap measured here.
"""

import json
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from povar_tpu.options import SolverOptions as JaxOptions
from povar_tpu.problem.bal_io import write_state_dump
from povar_tpu.problem.problem import BalProblem as JaxProblem
from povar_tpu.problem.synthetic import synthetic_bal_problem as jax_synthetic
from povar_tpu.solver.pipeline import bundle_adjust as jax_bundle_adjust
from povar_tpu_torch import (
    SolverOptions,
    SolverSummary,
    Stage1Solver,
    Timer,
    bundle_adjust,
    from_numpy,
    optimize_step1,
    synthetic_bal_problem,
)
from povar_tpu_torch.ops import launches
from povar_tpu_torch.tools.step2_spread import ring_case

# one torch thread a test process: the CPU tests' tensors are small,
# and a parallel run's xdist workers share the host's cores
torch.set_num_threads(1)

# tests/test_golden.py's f64 constants and decisions (the JAX package's
# pure-f64 run of synthetic_bal_problem(10, 80, 5, seed=777,
# noise=0.001), 15 + 15 iterations)
GOLDEN_INITIAL_1 = 163.9616294704582
GOLDEN_FINAL_1 = 0.018337189528717893
GOLDEN_FINAL_2 = 0.0002307646886928256
GOLDEN_DECISIONS_1 = [True] * 16
GOLDEN_DECISIONS_2 = [True] * 4

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
HARNESS = os.path.join(CSRC, "ref_step1_solver")
REF_ITERS = 15


def _pure_f64(cls, **kw):
    opts = cls(mixed_precision_solves=False)
    opts.device_lm_loop = "off"
    for k, v in kw.items():
        if isinstance(v, str) and k.startswith("solver_type"):
            v = type(getattr(opts, k))[v]  # an enum member, by name
        setattr(opts, k, v)
    return opts


def _records(summary):
    return [(it.step_is_successful, it.step_is_valid,
             it.linear_solver_iterations) for it in summary.iterations]


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors go to the plain versions: no kernel launch counted."""
    launches.reset_launch_counts()
    yield
    assert not any(launches.launch_counts().values())


@pytest.mark.parametrize("solvers", [("POWER_VARPROJ", "RIPOBA"),
                                     ("CHOLESKY", "RIPCG")],
                         ids=["varproj-ripoba", "cholesky-ripcg"])
def test_bundle_adjust_matches_jax(solvers):
    """`bundle_adjust` on `ring_case`, 6 + 6 iterations, in both
    packages' pure f64: identical records in both steps (decisions,
    validity, inner counts), every cost within 1e-10 and every trust
    radius within 1e-9 relative, the final cameras and landmarks within
    1e-8. Measured: costs <= 8.4e-13 / 1.5e-12, radii <= 2.5e-14 /
    4.4e-12, states <= 4.5e-14 / 1.4e-12 (POWER_VARPROJ + RIPOBA /
    CHOLESKY + RIPCG)."""
    args, cam0, lm0 = ring_case()
    kw = dict(solver_type_step_1=solvers[0], solver_type_step_2=solvers[1],
              max_num_iterations_step_1=6, max_num_iterations_step_2=6)
    jp = JaxProblem(cam_space=cam0.copy(),
                    intrinsics=np.tile([1.0, 0.0, 0.0], (args[3], 1)),
                    lm_p=lm0.copy(), obs_cam=args[0], obs_lm=args[1],
                    obs_uv=args[2])
    _jout, j1, j2 = jax_bundle_adjust(jp, _pure_f64(JaxOptions, **kw),
                                      log=lambda s: None)
    tp, _c, _l = from_numpy(*args[:3], cam0, lm0, device="cpu")
    out, t1, t2 = bundle_adjust(tp, _pure_f64(SolverOptions, **kw),
                                log=lambda s: None, device="cpu")
    for t, j in ((t1, j1), (t2, j2)):
        assert _records(t) == _records(j)
        assert t.solver_type == j.solver_type
        assert t.termination_type == j.termination_type
        np.testing.assert_allclose(
            [it.cost.all.error for it in t.iterations],
            [it.cost.all.error for it in j.iterations], rtol=1e-10)
        np.testing.assert_allclose(
            [it.trust_region_radius for it in t.iterations],
            [it.trust_region_radius for it in j.iterations], rtol=1e-9)
    np.testing.assert_allclose(out.cam_space, np.asarray(jp.cam_space),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(out.lm_p_h, np.asarray(jp.lm_p_h), rtol=0,
                               atol=1e-8)


def test_golden_f64_costs():
    """tests/test_golden.py's pure-f64 run through the port's
    `bundle_adjust` (SolverOptions() defaults but pure f64, 15 + 15
    iterations) on the same seeded problem, made by the port's own
    generator: the initial cost within 1e-10 and the final costs within
    1e-6 of the golden constants, and both steps' decisions. Measured:
    initial 2.2e-16, finals 1.1e-12 and 1.1e-15 relative."""
    problem, _ = synthetic_bal_problem(n_cams=10, n_lms=80, obs_per_lm=5,
                                       seed=777, noise=0.001)
    opts = SolverOptions(mixed_precision_solves=False,
                         max_num_iterations_step_1=15,
                         max_num_iterations_step_2=15)
    _out, s1, s2 = bundle_adjust(problem, opts, log=lambda s: None,
                                 device="cpu")
    assert s1.initial_cost.all.error == pytest.approx(GOLDEN_INITIAL_1,
                                                      rel=1e-10)
    assert s1.final_cost.all.error == pytest.approx(GOLDEN_FINAL_1, rel=1e-6)
    assert s2.final_cost.all.error == pytest.approx(GOLDEN_FINAL_2, rel=1e-6)
    assert [it.step_is_successful for it in s1.iterations] == (
        GOLDEN_DECISIONS_1)
    assert [it.step_is_successful for it in s2.iterations] == (
        GOLDEN_DECISIONS_2)


@pytest.fixture(scope="module")
def ref_problem():
    """tests/test_reference_parity.py's problem (initialization-free:
    random cameras, landmarks from the closed-form VarProj init),
    observations sorted as there."""
    prob, _ = jax_synthetic(n_cams=10, n_lms=60, obs_per_lm=5,
                            seed=20240819, noise=0.01)
    prob.sort_observations()
    return prob


@pytest.fixture(scope="module")
def ref_run(ref_problem, tmp_path_factory):
    """The Eigen harness's pure-f64 POWER_VARPROJ step 1 on the state
    dump of `ref_problem`. A harness that does not build fails the test
    (it does not skip)."""
    if not os.path.exists(HARNESS):
        r = subprocess.run(["make", "-C", CSRC, "ref_step1_solver"],
                           capture_output=True, timeout=300)
        assert r.returncode == 0 and os.path.exists(HARNESS), (
            "cannot build the Eigen reference harness: "
            + r.stderr.decode()[-500:])
    state = str(tmp_path_factory.mktemp("ref") / "state.txt")
    write_state_dump(ref_problem, state, alpha=0.01, power_sc_iterations=10,
                     max_iters=REF_ITERS, eta=1e-2, function_tolerance=1e-6)
    r = subprocess.run([HARNESS, state], capture_output=True, timeout=300)
    assert r.returncode == 0, r.stderr.decode()[-500:]
    return json.loads(r.stdout.decode())


def test_step1_matches_eigen_reference(ref_problem, ref_run):
    """The port's pure-f64 step 1 (POWER_VARPROJ, the unstructured
    layout) against the Eigen harness, decision for decision, at
    tests/test_reference_parity.py:133-178's tolerances: the initial
    cost within 1e-12, every valid cost within 1e-10, relative decrease
    within 1e-6, trust radii within 1e-9, the final state within 1e-8.
    Measured: costs <= 5.2e-13, radii <= 3.7e-13, states <= 1.8e-10."""
    p = ref_problem
    opts = _pure_f64(SolverOptions, max_num_iterations_step_1=REF_ITERS)
    s1 = Stage1Solver(p.obs_cam, p.obs_lm, p.obs_uv, p.num_cameras,
                      p.num_landmarks, opts, device="cpu")
    assert s1.unstructured and s1.solve_dtype == torch.float64
    summary = SolverSummary()
    cams, lms = optimize_step1(
        s1, torch.as_tensor(np.asarray(p.cam_space, np.float64)),
        torch.as_tensor(np.asarray(p.lm_p, np.float64)), opts, summary,
        Timer(), log=lambda s: None)
    ref_iters = ref_run["iterations"]
    assert len(summary.iterations) == len(ref_iters)
    assert sum(r["accept"] for r in ref_iters[1:]) >= 5
    for k, (fw, ref) in enumerate(zip(summary.iterations, ref_iters)):
        assert fw.step_is_successful == ref["accept"], k
        assert fw.step_is_valid == ref["valid"], k
        if k == 0:
            assert fw.cost.all.error == pytest.approx(ref["cost"], rel=1e-12)
            continue
        assert fw.linear_solver_iterations == ref["lin_iters"], k
        if ref["valid"]:
            assert fw.cost.all.error == pytest.approx(ref["cost"],
                                                      rel=1e-10), k
            assert fw.relative_decrease == pytest.approx(
                ref["relative_decrease"], rel=1e-6), k
        assert fw.trust_region_radius == pytest.approx(
            ref["trust_region_radius"], rel=1e-9), k
    np.testing.assert_allclose(
        cams.numpy(), np.array(ref_run["final_cams"]).reshape(-1, 3, 4),
        rtol=0, atol=1e-8)
    np.testing.assert_allclose(
        lms.numpy(), np.array(ref_run["final_lms"]).reshape(-1, 3), rtol=0,
        atol=1e-8)
    assert summary.final_cost.all.error == pytest.approx(
        ref_run["final_cost"], rel=1e-10)


def test_cli_pure_f64(tmp_path, monkeypatch):
    """`python -m povar_tpu_torch.cli --no-solver-mixed-precision-solves`
    on the committed BAL fixture (after --create-dataset, on the CPU):
    it exits 0, logs both steps, and their accepted costs fall."""
    from povar_tpu_torch import cli

    name = "mini-bal-12-48-pre.txt"
    shutil.copy(os.path.join(os.path.dirname(__file__), "data", name),
                tmp_path / name)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        cli.main(["--input", name, "--create-dataset"])
    assert e.value.code in (0, None)
    assert cli.main(["--input", os.path.join("data_custom", name),
                     "--device", "cpu", "--no-solver-mixed-precision-solves",
                     "--solver-max-num-iterations-step-1", "8",
                     "--solver-max-num-iterations-step-2", "4"]) == 0
    log = json.loads((tmp_path / "ba_log.json").read_text())
    assert log["solver1"]["solver_type"] == "power_variable_projection"
    for key in ("iterations1", "iterations"):
        accepted = [it["cost"] for it in log[key] if it["step_is_successful"]]
        assert len(accepted) > 1, key
        assert all(b < a for a, b in zip(accepted, accepted[1:])), key

"""`detailed_timing` in povar_tpu_torch: the staged host LM loop
(solver/lm.py with the solvers' linearize_timed / solve_timed /
apply_timed) on the CPU, against the port's fused host loop, against
the JAX package's staged run, and through the CLI.

  - Staged against fused ("off"): every step-1 solver (POWER_VARPROJ,
    POWER_SCHUR_COMPLEMENT, PCG, CHOLESKY on its dense route, on the
    banded one with DENSE_CHOL_MAX lowered as in
    tests/test_torch_band_chol.py, and on its PCG fallback) with each
    step-2 solver in mixed precision on both layouts; in pure f64, on the
    banded and fallback routes and with the f32 state each step-1
    solver with one step-2 solver, the two taking turns (CASES), in
    `bundle_adjust` of synthetic_bal_problem(6, 30, 4, seed=2): both
    loops run the same pieces in the same order, so decisions, inner
    counts, every cost, radius and relative decrease and the final
    states are equal bit for bit. The staged run fills the spans the
    JAX package's staged solvers fill (tools/stage_timing.py SOLVE),
    each > 0 in every iteration whose step is valid, and an iteration's
    spans sum to at most its iteration_time.
  - Against one JAX `bundle_adjust(detailed_timing=True)` with
    SolverOptions() defaults (off the TPU the JAX package runs its XLA
    layout, so the port runs `pallas_kernels="off"`, the same layout;
    one run shared by the module, ~20 s with a cold compilation cache,
    ~70 s with its Pallas kernels in interpret mode) on
    tools/step2_spread.py's `small_case` problem: the same decisions and
    power-term counts, the final costs within
    tests/test_torch_unstructured.py's 1e-3 (measured 2.5e-4 and
    3.8e-10), and the same set of spans > 0 in every iteration.
  - The CLI's `--solver-detailed-timing` writes every span the solvers
    fill into ba_log.json, > 0 for each valid step.
"""

import copy
import json
import shutil
import warnings

import numpy as np
import pytest
import torch

from povar_tpu_torch import SolverOptions, bundle_adjust, cli, from_numpy
from povar_tpu_torch.ops import launches
from povar_tpu_torch.problem.synthetic import synthetic_bal_problem
from povar_tpu_torch.solver import band_chol
from povar_tpu_torch.solver import stage1 as torch_stage1
from povar_tpu_torch.tools.large_scale import route_of
from povar_tpu_torch.tools.stage_timing import (
    SPANS,
    check_spans,
    expected_spans,
    spans_filled,
)

# one torch thread a test process: the CPU tests' tensors are small,
# and a parallel run's xdist workers share the host's cores
torch.set_num_threads(1)

ITERS1, ITERS2 = 4, 3


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors go to the plain versions: no kernel launch counted."""
    launches.reset_launch_counts()
    yield
    assert not any(launches.launch_counts().values())


@pytest.fixture(scope="module")
def problem6():
    return synthetic_bal_problem(n_cams=6, n_lms=30, obs_per_lm=4,
                                 seed=2)[0]


def _options(step1, step2, **kw):
    opts = SolverOptions(max_num_iterations_step_1=ITERS1,
                         max_num_iterations_step_2=ITERS2, **kw)
    opts.solver_type_step_1 = type(opts.solver_type_step_1)[step1]
    opts.solver_type_step_2 = type(opts.solver_type_step_2)[step2]
    return opts


# (step-1 solver, step-2 solver, layout and precision, CHOLESKY's route):
# "mixed" the structured layout, "off" the unstructured one (CHOLESKY's
# always), "f64" pure f64 (unstructured), "f32" the f32 state. Mixed
# precision crosses the step-1 solvers with both step-2 solvers; the
# other cases pair each step-1 solver with one, in turns (a pair costs
# two `bundle_adjust`s, ~1 s in mixed precision and ~2 s in f64 here)
STEP2 = ("RIPOBA", "RIPCG")
CASES = (
    [(s1, s2, "mixed", None) for s1 in ("POWER_VARPROJ",
                                        "POWER_SCHUR_COMPLEMENT", "PCG")
     for s2 in STEP2]
    + [(s1, s2, "off", r) for s1, r in (
        ("POWER_VARPROJ", None), ("POWER_SCHUR_COMPLEMENT", None),
        ("PCG", None), ("CHOLESKY", "dense")) for s2 in STEP2]
    + [("CHOLESKY", STEP2[i % 2], "off", r)
       for i, r in enumerate(("band", "pcg"), start=1)]
    + [(s1, STEP2[i % 2], "f64", r) for i, (s1, r) in enumerate((
        ("POWER_VARPROJ", None), ("POWER_SCHUR_COMPLEMENT", None),
        ("PCG", None), ("CHOLESKY", "dense"), ("CHOLESKY", "band"),
        ("CHOLESKY", "pcg")))]
    + [("POWER_VARPROJ", "RIPCG", "f32", None),
       ("PCG", "RIPOBA", "f32", None)]
)
PRECISION = {
    "mixed": ({}, torch.float64),
    "off": (dict(pallas_kernels="off"), torch.float64),
    "f64": (dict(mixed_precision_solves=False), torch.float64),
    "f32": ({}, torch.float32),
}


def _route_patches(monkeypatch, route):
    """CHOLESKY's banded route (the dense one closed, as past 1536
    cameras) or its PCG fallback (no band within MAX_SUPERNODE past
    DENSE_UNBANDED_MAX cameras), at six cameras."""
    if route in ("band", "pcg"):
        monkeypatch.setattr(torch_stage1, "DENSE_CHOL_MAX", 0)
    if route == "pcg":
        monkeypatch.setattr(band_chol, "MAX_SUPERNODE", 0)
        monkeypatch.setattr(band_chol, "DENSE_UNBANDED_MAX", 0)


def _run(problem, opts, dtype):
    p = copy.deepcopy(problem)
    with warnings.catch_warnings():
        # the banded routes' RuntimeWarnings (a full band, the fallback)
        warnings.simplefilter("ignore", RuntimeWarning)
        return bundle_adjust(p, opts, log=lambda s: None, dtype=dtype,
                             device="cpu")


def _records(summary):
    return [(it.step_is_successful, it.step_is_valid,
             it.linear_solver_iterations,
             None if it.cost is None else (it.cost.all.error,
                                           it.cost.valid.error),
             it.trust_region_radius, it.relative_decrease)
            for it in summary.iterations]


@pytest.mark.parametrize(
    "step1, step2, prec, route", CASES,
    ids=[f"{s1}-{s2}-{p}" + (f"-{r}" if r else "")
         for s1, s2, p, r in CASES])
def test_staged_loop_equals_fused_loop(problem6, monkeypatch, step1, step2,
                                       prec, route):
    """The staged loop (`detailed_timing=True`) against the fused host
    loop (`device_lm_loop="off"`): bit for bit in decisions, counts,
    costs, radii, relative decreases and the final state; the staged
    run's spans as JAX's staged solvers fill them."""
    _route_patches(monkeypatch, route)
    kw, dtype = PRECISION[prec]
    if route is not None:
        args = (problem6.obs_cam, problem6.obs_lm, problem6.obs_uv,
                problem6.num_cameras, problem6.num_landmarks)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            s = torch_stage1.Stage1Solver(*args, _options(step1, step2, **kw),
                                          device="cpu")
        assert route_of(s).endswith(route), route_of(s)
    out_f, f1, f2 = _run(problem6, _options(step1, step2,
                                            device_lm_loop="off", **kw),
                         dtype)
    out_s, s1, s2 = _run(problem6, _options(step1, step2,
                                            detailed_timing=True, **kw),
                         dtype)
    for step, f, s in ((1, f1, s1), (2, f2, s2)):
        assert _records(s) == _records(f), step
        assert s.termination_type == f.termination_type
        assert (s.num_linear_solves, s.num_residual_evaluations,
                s.num_jacobian_evaluations) == (
            f.num_linear_solves, f.num_residual_evaluations,
            f.num_jacobian_evaluations)
        # the fused loop times the whole trial as one span
        assert not any(getattr(it, "prepare_time_in_seconds")
                       for it in f.iterations)
    for a in ("cam_space", "lm_p_h"):
        np.testing.assert_array_equal(getattr(out_s, a), getattr(out_f, a))
    solver1 = "PCG" if route == "pcg" else step1
    check_spans(1, solver1, s1)
    check_spans(2, step2, s2)


# ---------------------------------------------------- against JAX


@pytest.fixture(scope="module")
def jax_and_port():
    """One JAX `bundle_adjust(detailed_timing=True)` with SolverOptions()
    defaults (the XLA layout off the TPU, the host loop) and the port's
    on the CPU with the same layout, on small_case's problem: 6 step-1
    and 10 step-2 iterations (tests/test_torch_stage2.py
    test_bundle_adjust_matches_jax)."""
    from povar_tpu.options import SolverOptions as JaxOptions
    from povar_tpu.problem.synthetic import (
        synthetic_bal_problem as jax_synthetic)
    from povar_tpu.solver.pipeline import bundle_adjust as jax_bundle_adjust

    jp, _ = jax_synthetic(n_cams=8, n_lms=60, obs_per_lm=5, seed=7,
                          noise=1e-3)
    iters = dict(max_num_iterations_step_1=6, max_num_iterations_step_2=10,
                 detailed_timing=True)
    _, j1, j2 = jax_bundle_adjust(copy.deepcopy(jp), JaxOptions(**iters),
                                  log=lambda s: None)
    tp, _c, _l = from_numpy(jp.obs_cam, jp.obs_lm, jp.obs_uv, jp.cam_space,
                            jp.lm_p, device="cpu")
    _, t1, t2 = bundle_adjust(tp, SolverOptions(pallas_kernels="off",
                                                **iters),
                              log=lambda s: None, device="cpu")
    return (t1, j1), (t2, j2)


def test_staged_decisions_match_jax(jax_and_port):
    """The same accept / reject decisions, validity and power-term counts
    in both steps, the final costs within 1e-3 relative."""
    for t, j in jax_and_port:
        assert [(it.step_is_successful, it.step_is_valid,
                 it.linear_solver_iterations) for it in t.iterations] == [
            (it.step_is_successful, it.step_is_valid,
             it.linear_solver_iterations) for it in j.iterations]
        assert t.termination_type == j.termination_type
        np.testing.assert_allclose(t.final_cost.all.error,
                                   j.final_cost.all.error, rtol=1e-3)


def test_staged_spans_match_jax(jax_and_port):
    """Every iteration has the same set of spans > 0 in both packages,
    and they are the spans tools/stage_timing.py `expected_spans` names
    (the check of the port's other configurations)."""
    for step, (solver, (t, j)) in enumerate(
            zip(("POWER_VARPROJ", "RIPOBA"), jax_and_port), start=1):
        assert ([spans_filled(it) for it in t.iterations]
                == [spans_filled(it) for it in j.iterations]), step
        check_spans(step, solver, t)


# ---------------------------------------------------------------- CLI


def test_cli_writes_the_spans(tmp_path, monkeypatch):
    """`--solver-detailed-timing` on the committed BAL fixture with
    SolverOptions() defaults: ba_log.json's iterations1 and iterations
    carry each span POWER_VARPROJ / RIPOBA fill as its `<span>_time`,
    > 0 in every valid record, and the spans they do not fill at 0."""
    fixture = "mini-bal-12-48-pre.txt"
    shutil.copy(f"{__file__.rsplit('/', 1)[0]}/data/{fixture}",
                tmp_path / fixture)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        cli.main(["--input", fixture, "--create-dataset"])
    assert e.value.code in (0, None)
    assert cli.main(["--input", f"data_custom/{fixture}", "--device", "cpu",
                     "--solver-detailed-timing",
                     "--solver-max-num-iterations-step-1", "8",
                     "--solver-max-num-iterations-step-2", "4"]) == 0
    log = json.loads((tmp_path / "ba_log.json").read_text())
    for key, step, solver in (("iterations1", 1, "POWER_VARPROJ"),
                              ("iterations", 2, "RIPOBA")):
        its = log[key]
        want = expected_spans(step, solver,
                              [it["step_is_valid"] for it in its],
                              [it["step_is_successful"] for it in its])
        checked = 0
        for i, (it, w) in enumerate(zip(its, want)):
            if w is None:
                continue
            assert {k for k in SPANS if it[f"{k}_time"] > 0} == w, (key, i)
            checked += 1
        assert checked > 0, key

"""Run-to-run spread of the two-step solve on the card.

    python -m povar_tpu_torch.tools.step2_spread [--runs 5] [--long 300]
        [--small 0] [--witness 0] [--step2 RIPOBA] [--pcg 0] [--psc 0]
        [--psc-device cuda] [--psc-f64 0] [--varproj 0] [--psc-mesh 0]
        [--psc-ba 0] [--ba 0]
        [--chol 0] [--chol-f64 0] [--f64 0] [--f64-mesh 0]
        [--chol-device cuda]
        [--ring 0]
        [--out build/step2_spread.json]

On synthetic_bal_problem_fast(89, 110973, 5, seed=0) with the composed
power term (SolverOptions() defaults except fused_power_term=False,
device_lm_loop="off", the configuration its tolerances were measured
in), separates the two sources of spread in the final
step-2 cost:

  fixed start   one step-1 solve, then step 2 from its homogenized
                result `--runs` times (the f32 atomics of the per-camera
                kernels sum in a run-dependent order, so repeated runs
                from one state differ only by that rounding);
  long          step 2 from the same state with the iteration cap raised
                to `--long`, twice: where the trajectory goes after the
                default cap of 50;
  pipeline      `bundle_adjust` `--runs` times (each run's step 1 ends at
                its own state);
  small         `--small` card runs of the small `bundle_adjust` of
                `small_case` against one CPU run: each step's final-cost
                gap and whether the decisions match (the evidence for
                SMALL_TOLS);
  witness       `--witness` step-1 solves, each followed by
                `step2_witness` from its homogenized result: how far the
                card's first step-2 iterations stay on the CPU's path
                (with the `--step2` solver, RIPOBA or RIPCG; RIPCG runs
                SolverOptions() defaults otherwise, the fused term);
  pcg           `--pcg` step-1 solves with PCG (SCHUR_JACOBI,
                SolverOptions() defaults otherwise): the spread of the
                final cost that chip_smoke.py's PCG bound was set from;
  ring          `--ring` card runs of each `ring_pipeline` configuration
                (POWER_SCHUR_COMPLEMENT + RIPOBA, the f32 state, the
                unstructured layout, CHOLESKY + RIPOBA) against one CPU
                run: the evidence for RING_TOLS;
  psc           `--psc` step-1 solves with POWER_SCHUR_COMPLEMENT
                (SolverOptions() defaults otherwise) on the card, or with
                `--psc-device cpu` through the plain versions on the CPU:
                the spread of the final cost that chip_smoke.py's PSC
                band was set from, how many opening decisions each
                shares with the JAX package's run (`JAX_PSC_DECISIONS`)
                and its power-term counts (`JAX_PSC_TERMS`);
  psc f64       `--psc-f64` such solves on the card in f64 through the
                plain versions (f64_structured): the trajectory the f32
                kernels' sums round away from;
  varproj       `--varproj` step-1 solves with SolverOptions() defaults
                (POWER_VARPROJ, the fused term) on the card;
  psc mesh      `--psc-mesh` such solves on a 1-device mesh (the SPMD
                window layout): the spread chip_smoke.py's mesh PSC
                check meets;
  psc ba        `--psc-ba` venice-89 `bundle_adjust` runs with
                POWER_SCHUR_COMPLEMENT + RIPOBA: where step 2 ends after
                the poBA basin's step 1 (chip_smoke.py's PSC_STEP2_MAX);
  ba            `--ba` venice-89 `bundle_adjust` runs with
                SolverOptions() defaults (the main path: the fused term,
                the device LM loop): where each step ends;
  chol          `--chol` step-1 solves with CHOLESKY (the dense reduced
                camera system on the unstructured layout, SolverOptions()
                defaults otherwise) on the card, or with `--chol-device
                cpu` through the plain versions on the CPU: the spread
                that chip_smoke.py's CHOLESKY band was set from, and the
                opening decisions each shares with the JAX package's run
                (`JAX_CHOL_DECISIONS`);
  f64           `--f64` venice-89 pure-f64 (`mixed_precision_solves=
                False`) step-1 solves with POWER_VARPROJ and with
                CHOLESKY and `--f64` RIPOBA step-2 witnesses, on the
                card's kernels and on their plain versions on the card:
                the spread chip_smoke.py's F64_TOL was set from;
  chol f64      `--chol-f64` such solves in f64 through the plain
                versions (f64_unstructured: the f32 Jacobi epsilon kept),
                on the card or with `--chol-device cpu` on the CPU: where
                the f32 kernels' orders of sums round away from;
  f64 mesh      `--f64-mesh` pure-f64 step-1 solves on a 1-device mesh
                (the structured window layout's f64 kernels) of each
                F64_MESH_CONFIGS configuration and as many of its step-2
                witnesses, on the card's kernels and on their plain
                versions on the card, and as many POWER_VARPROJ solves on
                one device (the unstructured layout): the spreads
                chip_smoke.py's F64_MESH_TOLS were set from
                (pure_f64_mesh_spread).

Prints one line per run and writes every trajectory (accept/reject
sequence, power terms, costs, termination) as JSON to `--out`. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import time

import numpy as np
import torch

from povar_tpu_torch.options import SolverType, SolverTypeRiemannian
from povar_tpu_torch.problem.synthetic import (
    _ring_cameras,
    synthetic_bal_problem_adversarial,
)
from povar_tpu_torch import (
    SolverOptions,
    SolverSummary,
    Stage1Solver,
    Stage2Solver,
    Timer,
    bundle_adjust,
    create_homogeneous,
    from_numpy,
    optimize_step1,
    optimize_step2,
    synthetic_bal_problem,
    synthetic_bal_problem_fast,
)


def _record(label, summary, seconds):
    its = summary.iterations
    rec = dict(
        label=label,
        seconds=seconds,
        iterations=len(its) - 1,
        termination=summary.termination_type,
        decisions="".join("A" if it.step_is_successful else "R"
                          for it in its[1:]),
        terms=[it.linear_solver_iterations for it in its[1:]],
        costs=[it.cost.all.error if it.cost is not None else None
               for it in its],
        initial=summary.initial_cost.all.error,
        final=summary.final_cost.all.error,
    )
    print(f"{label:<16} {rec['iterations']:4d} it {rec['termination']:<15} "
          f"initial {rec['initial']:.6e} final {rec['final']!r} "
          f"({seconds:.2f} s) {rec['decisions']}", flush=True)
    return rec


# Step 2 at full width is reproducible only without the landmarks near a
# camera's principal plane (with them, from a start of 4.5e8 on an H100,
# two card runs and the CPU parted at the first accepted step):
# `calm_subproblem` keeps the landmarks whose every observation has
# |1/p2| <= CALM times the median, and `step2_witness` runs
# WITNESS_ITERS step-2 iterations there, on the card and on the CPU.
# `--witness 10` on an H100 80GB HBM3 at 700 W (ten step-1 results, two
# card runs each, 8 iterations): decisions always equal to the CPU's;
# the k-th accepted cost within 3.8e-6, 3.1e-5 and 6.4e-4 of the CPU's
# for k = 1, 2, 3 (the f32 solve's rounding grows ~10x per accepted
# step). So the witness stops after two accepted steps, and
# WITNESS_TOLS bounds the k-th accepted cost's relative gap. Those ten
# starts set it at (1e-5, 3e-4); a later run failed it at 1.9e-5 for
# k = 1, and `--witness 12` plus `--witness 12 --step2 RIPCG` (same
# card; 48 card runs from 24 starts) put the gaps at most at 8.4e-5
# (k = 1) and 9.2e-5 (k = 2), decisions equal in all. So both are 3e-4.
CALM = 10.0
WITNESS_ITERS = 7
# The same bounds hold RIPCG's witness (SolverOptions() defaults with
# solver_type_step_2=RIPCG). Its decisions were equal everywhere, but in
# one start of four (`--witness 4 --step2 RIPCG`) the first trial
# (lambda = 1e-4, rejected at a cost ~1e3 x the start) took 7 CG
# iterations on the card and 1 on the CPU: at that lambda the f32 system
# is near singular and one device's first CG step fails (rho or p'q not
# positive) where the other's goes on. So RIPCG's witness holds CG
# counts on the accepted trials only
# (`witness_gaps(counts_when_rejected=False)`).
WITNESS_TOLS = (3e-4, 3e-4)


def trajectory(summary):
    """[(accepted, power terms, cost or None)] per iteration record."""
    return [
        (it.step_is_successful, it.linear_solver_iterations,
         it.cost.all.error if it.cost is not None else None)
        for it in summary.iterations
    ]


def calm_subproblem(problem, cams_h, lms_h, calm=CALM):
    """The observations of `problem` whose landmark is well-conditioned
    in the homogenized state (cams_h [N, 3, 4], lms_h [M, 4]): every
    observation of it has |1/p2| <= `calm` times the median over all
    observations. Returns the Stage2Solver arguments of that sub-problem
    (landmarks renumbered) and its landmark state."""
    dev = cams_h.device
    cam = torch.as_tensor(problem.obs_cam, device=dev).long()
    lm = torch.as_tensor(problem.obs_lm, device=dev).long()
    zinv = 1.0 / (cams_h[cam, 2, :] * lms_h[lm]).sum(-1).abs()
    keep_lm = torch.ones(lms_h.shape[0], dtype=torch.bool, device=dev)
    keep_lm[lm[zinv > calm * zinv.median()]] = False
    keep = keep_lm[lm]
    renum = torch.cumsum(keep_lm.long(), 0) - 1
    k = keep.cpu().numpy()
    args = (problem.obs_cam[k], renum[lm[keep]].cpu().numpy(),
            problem.obs_uv[k], problem.num_cameras, int(keep_lm.sum()))
    return args, lms_h[keep_lm]


def f64_unstructured(s):
    """Make the mixed-precision stage solver `s` (the unstructured layout)
    evaluate in f64 throughout, the cameras gathered, the Jacobians, sums
    and solves in f64, while it keeps the f32 solves' Jacobi epsilon:
    the pure-f64 configuration (`mixed_precision_solves=False`, which
    takes the f64 epsilon 1e-5) but for that epsilon, so a diagnostic of
    the trajectory the f32 sums round away from."""
    if not s.unstructured:
        raise ValueError("f64_unstructured: the unstructured layout "
                         "(pallas_kernels='off' or CHOLESKY) only")
    s.solve_dtype = torch.float64
    s._uv_s = s.obs.uv
    return s


def f64_twin(solver_cls, args, options):
    """A CPU stage solver (`solver_cls` on the arguments `args`) in the
    pure-f64 configuration of `options` (the unstructured layout) with
    the f32 solves' Jacobi epsilon, so that its operators are those of
    the f32 layouts evaluated in f64: the reference chip_smoke.py holds
    both f32 layouts to."""
    o = copy.deepcopy(options)
    o.mixed_precision_solves = False
    s = solver_cls(*args, o, device="cpu")
    s.jacobi_eps = o.effective_jacobi_scaling_epsilon(np.float32)
    return s


@contextlib.contextmanager
def plain_step1(cams=False, step2=False, slots=False):
    """The step-1 kernel wrappers of ops/pose_kernels.py, with `cams` the
    camera-table ones of ops/cam_kernels.py, with `step2` the step-2
    ones of ops/pose2_kernels.py and with `slots` the SPMD window
    layout's slot kernels of ops/spmd_kernels.py, replaced by their
    plain versions (ops/pose_ref.py, ops/cam_ref.py, ops/pose2_ref.py,
    ops/spmd_ref.py; any device and dtype) while the block runs; the
    stage solvers call them through the module."""
    from povar_tpu_torch.ops import cam_kernels, cam_ref, pose2_kernels
    from povar_tpu_torch.ops import pose2_ref, pose_kernels, pose_ref
    from povar_tpu_torch.ops import spmd_kernels, spmd_ref

    pairs = ([(pose_kernels, pose_ref)]
             + ([(cam_kernels, cam_ref)] if cams else [])
             + ([(pose2_kernels, pose2_ref)] if step2 else [])
             + ([(spmd_kernels, spmd_ref)] if slots else []))
    saved = [(m, n, getattr(m, n)) for m, _ref in pairs for n in m.KERNELS]
    try:
        for m, ref in pairs:
            for n in m.KERNELS:
                setattr(m, n, getattr(ref, n))
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def f64_structured(solver):
    """Make a structured stage-1 solver's inner solves and sums f64 (the
    state is f64 already): under plain_step1, the f64 evaluation of the
    solve the card runs with f32 kernels, summed by `index_add_` in f64.
    A diagnostic of which trajectory the f32 sums round away from, not a
    configuration (pure f64, `mixed_precision_solves=False`, runs the
    unstructured layout on one device, the f64 kernels on a mesh)."""
    if solver.unstructured:
        raise ValueError("f64_structured: the structured layout only")
    solver.solve_dtype = torch.float64
    solver._uv_s = solver.obs.uv
    solver._mask1 = solver._mask1.double()
    return solver


def emulate_tpu_onehot(solver):
    """Make `solver` (unstructured) evaluate its camera side as the JAX
    package's unstructured layout does on a TPU: every per-camera sum and
    gather there is a one-hot `dot_general` at default precision, whose
    f32 operands the MXU rounds to bf16 before an f32 accumulation
    (povar_tpu/solver/segments.py onehot_segment_sum / onehot_gather;
    stage1.py _seg_cam, _gather_cam_x, _prep_hpp_b). Here the operand of
    each sum or gather is rounded to bf16 the same way, and Hpp / b are
    sums of bf16-rounded per-observation products, as JAX's
    `_seg_cam_outer`. A diagnostic of the JAX run's arithmetic
    (chip_smoke.py's CHOLESKY phase), not a configuration."""
    def bf16(x):
        return x.to(torch.bfloat16).to(x.dtype)

    seg, gather = solver._seg_cam, solver._gather_cam_x
    solver._seg_cam = lambda x: seg(bf16(x))
    solver._gather_cam_x = lambda x: gather(bf16(x))

    def hpp_b(jp, jl, r, hll_inv_bl):
        r_tilde = r - torch.einsum("ijo,jo->io", jl,
                                   solver._gather_lm_x(hll_inv_bl))
        return (solver._seg_cam(torch.einsum("kio,kjo->ijo", jp, jp)),
                solver._seg_cam(torch.einsum("kio,ko->io", jp, r_tilde)))

    solver._hpp_b_u = hpp_b
    return solver


WITNESS_RUNS = (("card", "cuda"), ("card again", "cuda"), ("cpu", "cpu"))


def step2_witness(problem, opts, cams_h, lms_h, iters=WITNESS_ITERS,
                  calm=CALM, runs_on=WITNESS_RUNS):
    """The first `iters` step-2 iterations on `calm_subproblem` of the
    state (cams_h, lms_h), once per (label, device) of `runs_on`: by
    default twice on the card and once through the plain versions on the
    CPU. Returns (the sub-problem's Stage2Solver arguments, {label:
    (trajectory, seconds)})."""
    args, lms_w = calm_subproblem(problem, cams_h, lms_h, calm)
    o = copy.deepcopy(opts)
    o.max_num_iterations_step_2 = iters
    runs = {}
    for label, dev in runs_on:
        solver = Stage2Solver(*args, o, device=dev)
        summary = SolverSummary()
        t0 = time.perf_counter()
        optimize_step2(solver, cams_h.to(dev), lms_w.to(dev), o, summary,
                       Timer(), log=lambda s: None)
        if dev == "cuda":
            torch.cuda.synchronize()
        runs[label] = (trajectory(summary), time.perf_counter() - t0)
    return args, runs


def witness_gaps(runs, counts_when_rejected=True):
    """Per card run of `step2_witness` (every label but "cpu"): (same
    decisions and inner iteration counts as the CPU, relative
    initial-cost gap, relative gaps of the costs the CPU accepted).
    Rejected trials' costs are not compared: they differ by orders of
    magnitude between runs; nor, with `counts_when_rejected=False`
    (RIPCG), their CG counts."""
    want = runs["cpu"][0]
    out = {}

    def key(rec):
        ok, n, _c = rec
        return (ok, n if ok or counts_when_rejected else None)

    for label in (k for k in runs if k != "cpu"):
        got = runs[label][0]
        same = [key(g) for g in got] == [key(w) for w in want]
        init = abs(got[0][2] - want[0][2]) / want[0][2]
        gaps = [abs(g[2] - w[2]) / w[2]
                for g, w in zip(got[1:], want[1:]) if w[0] and w[2]]
        out[label] = (same, init, gaps)
    return out


# Final-cost tolerances (relative, step 1 and step 2) of the small
# `bundle_adjust` on the card against the CPU. Fifty card runs measured
# by `--small 50` on an H100 80GB HBM3 at 700 W put the step-1 gap at
# median 4.0e-4, max 9.2e-4 (the f32 atomics' order compounds over six
# steps into a flat valley) and the step-2 gap at <= 7.4e-10 (step 2
# converges to one optimum); decisions were equal in all fifty.
SMALL_TOLS = (2e-3, 1e-3)


# The configurations of the small case: the composed power term (the
# one SMALL_TOLS was measured on), SolverOptions() defaults (the fused
# term) and PCG + RIPCG. The CG pair runs step 1 for 11 iterations: from
# 6, a PCG step 1 leaves step 2 a chaotic start (tests/test_torch_stage2
# .py's pipeline test).
SMALL_CONFIGS = {
    "composed": dict(fused_power_term=False),
    "defaults": {},
    "cg": dict(solver_type_step_1=SolverType.PCG,
               solver_type_step_2=SolverTypeRiemannian.RIPCG,
               max_num_iterations_step_1=11),
    # both steps on the unstructured layout
    "off": dict(pallas_kernels="off"),
    # CHOLESKY (step 1 unstructured, step 2 structured); its step 1 ends
    # where step 2's start is chaotic (tests/test_torch_unstructured_
    # stage2.py), so step 2 is held only to falling below its start
    "cholesky": dict(solver_type_step_1=SolverType.CHOLESKY,
                     max_num_iterations_step_2=4),
}


def small_case(config="composed", loop="off"):
    """The small `bundle_adjust` case that SMALL_TOLS was measured on:
    (problem, options) with synthetic_bal_problem(8, 60, 5, seed=7) at
    1e-3 pixel noise, at most 6 step-1 and 10 step-2 iterations, the
    options of SMALL_CONFIGS[config] and device_lm_loop=`loop` (the host
    loop SMALL_TOLS was measured with, by default). chip_smoke.py and
    tests/test_torch_cuda.py run it too."""
    problem = synthetic_bal_problem(n_cams=8, n_lms=60, obs_per_lm=5,
                                    seed=7, noise=1e-3)[0]
    opts = SolverOptions(device_lm_loop=loop, max_num_iterations_step_1=6,
                         max_num_iterations_step_2=10)
    for k, v in SMALL_CONFIGS[config].items():
        setattr(opts, k, v)
    return problem, opts


# The step-1 cost gap of `overflow_case`'s card and CPU runs on a
# 1-device mesh (decisions and counts identical): the f32 sums' order
# compounds over the six accepted steps, to 1.0e-3, 1.2e-3, 1.5e-3 and
# 1.6e-3 at the sixth in four runs on an H100 80GB HBM3 at 700 W
# (chip_smoke.py, tests/test_torch_cuda.py); about twice the largest.
OVERFLOW_TOL = 3e-3


def overflow_case():
    """A small problem whose SPMD window plan has overflow landmarks
    (rows duplicated within a device, `SpmdPlan.has_duplicates`):
    synthetic_bal_problem_adversarial(200, 800, 8, 1% loop closures,
    seed 3), 6,043 observations, with at most 6 step-1 and 4 step-2
    iterations. Its step 1 accepts every step; its step 2 starts where
    f32 trials fail (NaN increments), so chip_smoke.py and
    tests/test_torch_cuda.py hold the card's 1-device mesh to the CPU's
    step-1 decisions and counts, its costs to OVERFLOW_TOL, and step 2
    only to a finite fall. Returns (problem, options)."""
    problem = synthetic_bal_problem_adversarial(200, 800, 8.0,
                                                loop_closure_frac=0.01,
                                                seed=3)
    opts = SolverOptions(device_lm_loop="off", max_num_iterations_step_1=6,
                         max_num_iterations_step_2=4)
    return problem, opts


def ring_case():
    """A consistent geometry near its optimum (numpy; that of
    tests/test_pallas_pose2.py:141-160): 12 ring cameras, 80 landmarks
    seen 4 times each, 1e-3 pixels of measurement noise, cameras and
    landmarks perturbed by 1e-2. Step 1 descends on every step from it
    and step 2 settles near the noise floor from any close step-1 result,
    so the POWER_SCHUR_COMPLEMENT and f32-state checks run here (on
    small_case's problem a PSC step 1 leaves step 2 a chaotic start).
    Returns (the stage solvers' arguments, cameras [N, 3, 4], landmarks
    [M, 3])."""
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


# The `bundle_adjust` configurations run on `ring_case` card against CPU
# (chip_smoke.py, tests/test_torch_cuda.py): POWER_SCHUR_COMPLEMENT +
# RIPOBA with an f64 state, SolverOptions() defaults with an f32 state,
# and the two unstructured configurations; (options, state dtype) each.
RING_CONFIGS = {
    "psc": (dict(solver_type_step_1=SolverType.POWER_SCHUR_COMPLEMENT,
                 max_num_iterations_step_1=4, max_num_iterations_step_2=4),
            torch.float64),
    "f32": (dict(max_num_iterations_step_1=6, max_num_iterations_step_2=6),
            torch.float32),
    # the unstructured layout in both steps, and CHOLESKY + RIPOBA (step 2
    # structured), as tests/test_torch_unstructured_stage2.py runs them
    "off": (dict(pallas_kernels="off", max_num_iterations_step_1=6,
                 max_num_iterations_step_2=6), torch.float64),
    "cholesky": (dict(solver_type_step_1=SolverType.CHOLESKY,
                      max_num_iterations_step_1=6,
                      max_num_iterations_step_2=6), torch.float64),
}


# Relative tolerance of every cost (step 1, step 2) of a `ring_pipeline`
# card run against the CPU run, per configuration. `--ring 10` on an H100
# 80GB HBM3 at 700 W: decisions and counts equal in all twenty runs, the
# largest cost gaps 3.1e-4 / 1.3e-5 (psc) and 2.7e-4 / 1.4e-5 (f32), and
# chip_smoke.py's runs up to 3.8e-4 / 9.7e-6; the step-1 ones at the
# first step, whose cost is ~800x below the start (f32 atomics' order in
# that step's solve).
# `--ring 10` of the unstructured configurations (same card): "off"
# 2.1e-4 / 1.2e-5; CHOLESKY 3.7e-3 / 1.5e-5, its step-1 gap at the first
# step, whose f32 S = Hpp + lam I - A A^T is a difference that amplifies
# the atomics' rounding of Hpp (tests/test_torch_cuda.py saw 2.5e-3).
RING_TOLS = {"psc": (2e-3, 1e-4), "f32": (2e-3, 1e-4),
             "off": (2e-3, 1e-4), "cholesky": (1e-2, 1e-4)}


def ring_pipeline(config, device, loop="off"):
    """`bundle_adjust` of `ring_case` under RING_CONFIGS[config] on
    `device` with device_lm_loop=`loop` (by default the host loop, which
    RING_TOLS was measured with). Returns (step-1 summary, step-2
    summary)."""
    kw, dtype = RING_CONFIGS[config]
    args, cam0, lm0 = ring_case()
    problem, _c, _l = from_numpy(*args[:3], cam0, lm0, device="cpu")
    opts = SolverOptions(device_lm_loop=loop, **kw)
    return bundle_adjust(problem, opts, log=lambda s: None, dtype=dtype,
                         device=device)[1:]


def ring_compare(card, cpu):
    """Per step of a card and a CPU `ring_pipeline` result: (whether the
    decisions and inner counts match, the largest relative gap of any
    cost)."""
    out = []
    for g, c in zip(card, cpu):
        same = ([(it.step_is_successful, it.linear_solver_iterations)
                 for it in g.iterations]
                == [(it.step_is_successful, it.linear_solver_iterations)
                    for it in c.iterations])
        gap = max(abs(a.cost.all.error - b.cost.all.error)
                  / abs(b.cost.all.error)
                  for a, b in zip(g.iterations, c.iterations))
        out.append((same, gap))
    return out


def ring_gaps(runs):
    """`runs` card runs of each `ring_pipeline` configuration against one
    CPU run: per run and step, `ring_compare`'s match and largest gap
    (the evidence for RING_TOLS)."""
    out = {}
    for config in RING_CONFIGS if runs else ():
        cpu = ring_pipeline(config, "cpu")
        recs = []
        for _ in range(runs):
            card = ring_pipeline(config, "cuda")
            recs.append([dict(same=same, gap=gap)
                         for same, gap in ring_compare(card, cpu)])
        print(f"ring ({config}): {runs} card runs vs CPU: decisions and "
              f"counts equal in {[sum(r[k]['same'] for r in recs) for k in (0, 1)]}"
              f"; largest cost gaps per step "
              f"{[max(r[k]['gap'] for r in recs) for k in (0, 1)]}",
              flush=True)
        out[config] = recs
    return out


def small_gaps(runs, config="composed"):
    """Final-cost gaps (relative, per step) of `runs` card runs of the
    small `bundle_adjust` under SMALL_CONFIGS[config] against its CPU
    run, decision matches, and the largest difference of an inner
    iteration count (power terms or CG iterations) per step."""
    problem, opts = small_case(config)

    def run(device):
        return bundle_adjust(copy.deepcopy(problem), opts,
                             log=lambda s: None, device=device)[1:]

    def decisions(summaries):
        return [it.step_is_successful for s in summaries for it in s.iterations]

    def count_gap(g, c):
        return max(abs(a.linear_solver_iterations - b.linear_solver_iterations)
                   for a, b in zip(g.iterations, c.iterations))

    cpu = run("cpu") if runs else None
    recs = []
    for _ in range(runs):
        card = run("cuda")
        recs.append(dict(
            gaps=[abs(g.final_cost.all.error - c.final_cost.all.error)
                  / c.final_cost.all.error for g, c in zip(card, cpu)],
            same_decisions=decisions(card) == decisions(cpu),
            count_gaps=[count_gap(g, c) for g, c in zip(card, cpu)],
        ))
    if recs:
        g1 = sorted(r["gaps"][0] for r in recs)
        print(f"small ({config}): {runs} card runs vs CPU: step-1 final gap "
              f"median {g1[len(g1) // 2]:.2e} max {g1[-1]:.2e}; step-2 max "
              f"{max(r['gaps'][1] for r in recs):.2e}; decisions equal in "
              f"{sum(r['same_decisions'] for r in recs)}; largest inner "
              f"count differences per step "
              f"{[max(r['count_gaps'][k] for r in recs) for k in (0, 1)]}",
              flush=True)
    return recs


# POWER_SCHUR_COMPLEMENT step 1 of the JAX package on the venice-89
# problem (docs/results-venice89/runs/power_schur_complement-ripoba/
# venice-89/ba_log.json): its accept/reject string over the 50 trials
# after record 0, its power-term counts and its final cost
JAX_PSC_DECISIONS = "ARRRRRAAARAAAARAAAAAAAAAARRRRAAAAAAAAAAAAAAAAAAAAA"
JAX_PSC_TERMS = [1, 10, 10, 10, 10, 10, 3, 7] + [10] * 21 + [6, 7] + [10] * 19
JAX_PSC_COST = 23.31876816537192


# CHOLESKY step 1 of the JAX package on the same problem
# (docs/results-venice89/runs/cholesky-ripoba/venice-89/ba_log.json):
# its decisions over the 10 trials after record 0 (three rejections at
# lambda 2e-4 to 1.3e-2, then steady descent to the function tolerance)
# and its final cost; its RIPOBA step 2 ends at JAX_CHOL_COST2 after 51
# records, an 8.4x drop from 130619.93
JAX_CHOL_DECISIONS = "ARRRAAAAAA"
JAX_CHOL_COSTS = [391735.1662602257, 360.0928152707893, 360.0928152707893,
                  360.0928152707893, 360.0928152707893, 244.0851204002961,
                  243.96970614159272, 243.96856047674464, 243.96799152058156,
                  243.96770454026773, 243.9675604042901]
JAX_CHOL_COST = JAX_CHOL_COSTS[-1]
JAX_CHOL_COST2 = 15606.355045782198
# (opening decisions, final cost) of each step-1 solver's JAX run; the
# POWER_VARPROJ run (BENCH_r05.json e2e_final_cost_step1) records no
# decisions
JAX_STEP1 = {
    SolverType.POWER_SCHUR_COMPLEMENT: (JAX_PSC_DECISIONS, JAX_PSC_COST),
    SolverType.CHOLESKY: (JAX_CHOL_DECISIONS, JAX_CHOL_COST),
    SolverType.POWER_VARPROJ: (None, 207.47874642216357),
}


def same_prefix(decisions, want=JAX_PSC_DECISIONS):
    """How many opening decisions of `decisions` equal `want`'s."""
    n = 0
    for a, b in zip(decisions, want):
        if a != b:
            break
        n += 1
    return n


def step1_spread(problem, runs, solver, device="cuda", mesh=False,
                 f64=False):
    """`runs` venice-89 step-1 solves with `solver` (POWER_SCHUR_COMPLEMENT,
    CHOLESKY or POWER_VARPROJ; SolverOptions() defaults otherwise) on
    `device` ("cuda", or "cpu": the plain versions), with `mesh` on a
    1-device mesh there (the SPMD window layout), with `f64` in f64
    through the plain versions (f64_structured, or f64_unstructured
    where the solver takes the unstructured layout, as CHOLESKY does):
    their records, each with the count of opening decisions it shares
    with the JAX run of that solver (JAX_STEP1)."""
    if not runs:
        return []
    want, jax_cost = JAX_STEP1[solver]
    opts = SolverOptions(solver_type_step_1=solver)
    args = (problem.obs_cam, problem.obs_lm, problem.obs_uv,
            problem.num_cameras, problem.num_landmarks)
    if mesh:
        from povar_tpu_torch.parallel.mesh import make_mesh
        from povar_tpu_torch.parallel.spmd import SpmdStage1Solver
        from povar_tpu_torch.solver.pipeline import _make_spmd_plan

        stage1 = SpmdStage1Solver(
            _make_spmd_plan(problem, 1), problem.obs_uv, problem.num_cameras,
            problem.num_landmarks, opts, make_mesh(1, device))
    else:
        stage1 = Stage1Solver(*args, opts, device=device)
    if f64:
        (f64_unstructured if stage1.unstructured else f64_structured)(stage1)
    tag = solver.value.lower() + (" mesh" if mesh else "") + (
        " f64" if f64 else "")

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    recs = []
    for k in range(runs):
        _p, c0, l0 = from_numpy(problem.obs_cam, problem.obs_lm,
                                problem.obs_uv, problem.cam_space,
                                problem.lm_p, device=device)
        if mesh:
            l0 = stage1.pad_landmarks(problem.lm_p)
        s = SolverSummary()
        sync()
        t0 = time.perf_counter()
        with (plain_step1(cams=stage1.unstructured) if f64
              else contextlib.nullcontext()):
            optimize_step1(stage1, c0, l0, opts, s, Timer(),
                           log=lambda s: None)
        sync()
        rec = _record(f"{tag} {device} {k}", s, time.perf_counter() - t0)
        rec["same_prefix"] = (None if want is None
                              else same_prefix(rec["decisions"], want))
        recs.append(rec)
    finals = sorted(r["final"] for r in recs)
    print(f"{tag} ({device}): {runs} step-1 finals {finals[0]!r} .. "
          f"{finals[-1]!r} ({finals[0] / jax_cost:.4f}x .. "
          f"{finals[-1] / jax_cost:.4f}x JAX {jax_cost}), records "
          f"{sorted({r['iterations'] + 1 for r in recs})}, opening "
          f"decisions equal to JAX's {[r['same_prefix'] for r in recs]}; "
          f"inner counts {sorted({tuple(r['terms']) for r in recs})}",
          flush=True)
    return recs


def psc_spread(problem, runs, device="cuda"):
    """`step1_spread` with POWER_SCHUR_COMPLEMENT (JAX power-term counts:
    JAX_PSC_TERMS)."""
    return step1_spread(problem, runs, SolverType.POWER_SCHUR_COMPLEMENT,
                        device)


def psc_pipeline(problem, runs):
    """`runs` venice-89 `bundle_adjust` runs with POWER_SCHUR_COMPLEMENT +
    RIPOBA on the card: each step's record (the evidence for
    chip_smoke.py's PSC_STEP2_MAX)."""
    return ba_runs(problem, runs, SolverOptions(
        solver_type_step_1=SolverType.POWER_SCHUR_COMPLEMENT), "psc ba")


def ba_runs(problem, runs, opts, label):
    """`runs` venice-89 `bundle_adjust` runs with `opts` on the card: each
    step's record, and a line with the step-2 finals and starts."""
    recs = []
    for k in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, s1, s2 = bundle_adjust(copy.deepcopy(problem), opts,
                                  log=lambda s: None)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        recs.append(dict(step1=_record(f"{label} {k} s1", s1, secs),
                         step2=_record(f"{label} {k} s2", s2, secs)))
    if recs:
        finals = sorted(r["step2"]["final"] for r in recs)
        print(f"{label}: {runs} step-2 finals {finals} from starts "
              f"{sorted(r['step2']['initial'] for r in recs)}", flush=True)
    return recs


def _accepted_gap(a, b):
    """(same decisions and inner counts, the largest relative gap between
    the costs of the records both accepted, and the initial ones) of two
    trajectories."""
    same = [(ok, n) for ok, n, _c in a] == [(ok, n) for ok, n, _c in b]
    gaps = [abs(ca - cb) / abs(cb) for k, ((ok, _n, ca), (_o, _m, cb))
            in enumerate(zip(a, b)) if ok or k == 0]
    return same, max(gaps)


# the mesh's pure f64 (pure_f64_mesh_spread, chip_smoke.py's spmd_f64
# phase): per configuration its step-1 solver, the step-1 iterations it
# runs (None: its cap) and the step-2 solvers of the witnesses run from
# its homogenized result. The witnesses start from POWER_VARPROJ's
# converged step 1: from PSC's 8 iterations RIPCG's witness parted by
# 1.7e-3 between two runs of the same kernels (`--f64-mesh 4`, NVIDIA
# H100 80GB HBM3, 700 W)
F64_MESH_CONFIGS = {
    "varproj": (SolverType.POWER_VARPROJ, None,
                (SolverTypeRiemannian.RIPOBA, SolverTypeRiemannian.RIPCG)),
    "psc": (SolverType.POWER_SCHUR_COMPLEMENT, 8, ()),
    "pcg": (SolverType.PCG, 8, ()),
}


def f64_options(solver1=SolverType.POWER_VARPROJ, iters1=None,
                solver2=SolverTypeRiemannian.RIPOBA, iters2=None):
    """SolverOptions() in pure f64 (`mixed_precision_solves=False`) with
    the given solvers and iteration caps (None: the default)."""
    o = SolverOptions(mixed_precision_solves=False, solver_type_step_1=solver1,
                      solver_type_step_2=solver2)
    if iters1 is not None:
        o.max_num_iterations_step_1 = iters1
    if iters2 is not None:
        o.max_num_iterations_step_2 = iters2
    return o


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def f64_step1(problem, options, plain, mesh=True, device="cuda"):
    """One pure-f64 step-1 solve of `problem` under `options` on
    `device`, on a 1-device mesh (the structured window layout) or with
    `mesh` False on one device (the unstructured layout), on the
    kernels or with `plain` all their plain versions on the card (on the
    CPU the plain versions run either way). Returns (summary, the end
    state (cameras [N, 3, 4], canonical landmarks [M, 3]) on `device`,
    seconds)."""
    from povar_tpu_torch.parallel.mesh import make_mesh
    from povar_tpu_torch.solver.pipeline import _make_solvers

    s1, _s2 = _make_solvers(problem, options, torch.float64, device,
                            make_mesh(1, device) if mesh else None)
    cams = torch.as_tensor(problem.cam_space, device=device)
    lms = (s1.pad_landmarks(problem.lm_p) if mesh
           else torch.as_tensor(problem.lm_p, device=device))
    summary = SolverSummary()
    _sync(device)
    t0 = time.perf_counter()
    with (plain_step1(cams=True, step2=True, slots=True) if plain
          else contextlib.nullcontext()):
        cams, lms = optimize_step1(s1, cams, lms, options, summary, Timer(),
                                   log=lambda s: None)
    _sync(device)
    secs = time.perf_counter() - t0
    if mesh:
        lms = torch.as_tensor(s1.unpad_landmarks(s1.lm_unpack(lms)),
                              device=device)
    return summary, (cams, lms), secs


def f64_mesh_witness(problem, cams_h, lms_h, options, plain):
    """The pure-f64 step-2 witness on a 1-device mesh on the state's
    device: WITNESS_ITERS iterations of `options`' step-2 solver on the
    calm landmarks of the homogenized state (cams_h, lms_h canonical)
    (calm_subproblem), on the kernels or with `plain` their plain
    versions. Returns (summary, the sub-problem's landmark count,
    seconds)."""
    from povar_tpu_torch.parallel import spmd
    from povar_tpu_torch.parallel.mesh import make_mesh

    args, lms_w = calm_subproblem(problem, cams_h, lms_h)
    o = copy.deepcopy(options)
    o.max_num_iterations_step_2 = WITNESS_ITERS
    plan = spmd.build_spmd_plan(args[0], args[1], args[3], args[4], 1,
                                spmd.PART_ALIGN)
    s2 = spmd.SpmdStage2Solver(plan, args[2], args[3], args[4], o,
                               make_mesh(1, cams_h.device.type))
    summary = SolverSummary()
    _sync(cams_h.device)
    t0 = time.perf_counter()
    with (plain_step1(cams=True, step2=True, slots=True) if plain
          else contextlib.nullcontext()):
        optimize_step2(s2, cams_h, s2.pad_landmarks(lms_w.cpu().numpy()), o,
                       summary, Timer(), log=lambda s: None)
    _sync(cams_h.device)
    return summary, args[4], time.perf_counter() - t0


def _spread_gaps(trajs):
    """{pairing: (same decisions and counts in every pair, the largest
    accepted-cost gap)} of trajectories {side: [trajectory, ...]} (sides
    False: the kernels, True: the plain versions)."""
    pairs = {"kernels vs plain": [(a, b) for a in trajs[False]
                                  for b in trajs[True]],
             "kernels vs kernels": [(a, b) for i, a in enumerate(trajs[False])
                                    for b in trajs[False][i + 1:]],
             "plain vs plain": [(a, b) for i, a in enumerate(trajs[True])
                                for b in trajs[True][i + 1:]]}
    out = {}
    for label, ps in pairs.items():
        res = [_accepted_gap(a, b) for a, b in ps]
        out[label] = (all(sm for sm, _g in res),
                      max((g for _s, g in res), default=0.0))
    return out


def pure_f64_mesh_spread(problem, runs):
    """`runs` venice-89 pure-f64 step-1 solves of each F64_MESH_CONFIGS
    configuration on a 1-device mesh on the card's kernels and as many
    on their plain versions (f64_step1), in turns, then as many step-2
    witnesses of its step-2 solver each way from the first kernel
    solve's homogenized result (f64_mesh_witness), and `runs`
    POWER_VARPROJ solves on one device (the unstructured layout): per
    run set whether all took the same decisions and inner counts and
    the largest accepted-cost gap between a kernel and a plain run and
    within each side, and between the mesh's and the one device's
    kernel runs (chip_smoke.py's F64_MESH_TOLS are twice the largest)."""
    if not runs:
        return {}
    out = {}
    for tag, (solver1, iters1, witnesses) in F64_MESH_CONFIGS.items():
        opts = f64_options(solver1, iters1)
        sets = {f"{tag} step 1": {False: [], True: []}}
        state = None
        for k in range(runs):
            for plain in (False, True):
                s, end, secs = f64_step1(problem, opts, plain)
                _record(f"f64 mesh {tag} {'plain' if plain else 'kernels'} "
                        f"{k}", s, secs)
                sets[f"{tag} step 1"][plain].append(trajectory(s))
                if state is None:
                    state = create_homogeneous(*end)
        for solver2 in witnesses:
            name = f"{tag} {solver2.value} witness"
            sets[name] = {False: [], True: []}
            wopts = f64_options(solver1, iters1, solver2)
            for k in range(runs):
                for plain in (False, True):
                    s, m, secs = f64_mesh_witness(problem, *state, wopts,
                                                  plain)
                    _record(f"f64 mesh {name} ({m} landmarks) "
                            f"{'plain' if plain else 'kernels'} {k}", s, secs)
                    sets[name][plain].append(trajectory(s))
        if tag == "varproj":
            one = []
            for k in range(runs):
                s, _end, secs = f64_step1(problem, opts, False, mesh=False)
                _record(f"f64 one device varproj kernels {k}", s, secs)
                one.append(trajectory(s))
            sets["varproj mesh vs one device"] = {
                False: sets["varproj step 1"][False], True: one}
        for name, trajs in sets.items():
            gaps = _spread_gaps(trajs)
            print(f"f64 mesh {name}: {runs} + {runs} runs; "
                  + ", ".join(f"{k} same {sm} largest gap {g:.3e}"
                              for k, (sm, g) in gaps.items()), flush=True)
            out[name] = dict(gaps=gaps, runs=trajs)
    return out


def pure_f64_spread(problem, runs):
    """`runs` venice-89 pure-f64 step-1 solves (`mixed_precision_solves=
    False`) with POWER_VARPROJ and with CHOLESKY on the card's kernels,
    and as many with their plain versions on the card (plain_step1), each
    in turns; then `runs` RIPOBA step-2 runs each way, WITNESS_ITERS
    iterations on the calm landmarks of the homogenized result of the
    first kernel POWER_VARPROJ solve: per configuration, whether all
    2 `runs` took the same decisions and inner counts, and the largest
    accepted-cost gap between a kernel run and a plain run, and within
    each side (chip_smoke.py's F64_TOL is twice the largest)."""
    if not runs:
        return {}
    args = (problem.obs_cam, problem.obs_lm, problem.obs_uv,
            problem.num_cameras, problem.num_landmarks)
    out, state = {}, None
    for solver in (SolverType.POWER_VARPROJ, SolverType.CHOLESKY, "RIPOBA"):
        tag = solver if isinstance(solver, str) else solver.value.lower()
        trajs = {False: [], True: []}
        for k in range(runs):
            for plain in (False, True):
                opts = SolverOptions(mixed_precision_solves=False)
                s = SolverSummary()
                ctx = plain_step1(cams=True, step2=True) if plain else (
                    contextlib.nullcontext())
                t0 = time.perf_counter()
                if solver == "RIPOBA":
                    sargs, lms_w = calm_subproblem(problem, *state)
                    opts.max_num_iterations_step_2 = WITNESS_ITERS
                    with ctx:
                        optimize_step2(Stage2Solver(*sargs, opts,
                                                    device="cuda"),
                                       state[0], lms_w, opts, s, Timer(),
                                       log=lambda x: None)
                else:
                    opts.solver_type_step_1 = solver
                    _p, c0, l0 = from_numpy(*args[:3], problem.cam_space,
                                            problem.lm_p, device="cuda")
                    with ctx:
                        c1, l1 = optimize_step1(
                            Stage1Solver(*args, opts, device="cuda"), c0,
                            l0, opts, s, Timer(), log=lambda x: None)
                    if state is None and not plain:
                        state = create_homogeneous(c1, l1)
                torch.cuda.synchronize()
                _record(f"f64 {tag} {'plain' if plain else 'kernels'} {k}",
                        s, time.perf_counter() - t0)
                trajs[plain].append(trajectory(s))
        pairs = {"kernels vs plain": [(a, b) for a in trajs[False]
                                      for b in trajs[True]],
                 "kernels vs kernels": [(a, b) for i, a in
                                        enumerate(trajs[False])
                                        for b in trajs[False][i + 1:]],
                 "plain vs plain": [(a, b) for i, a in enumerate(trajs[True])
                                    for b in trajs[True][i + 1:]]}
        res = {label: [_accepted_gap(a, b) for a, b in ps]
               for label, ps in pairs.items()}
        same = all(sm for r in res.values() for sm, _g in r)
        gaps = {label: max((g for _s, g in r), default=0.0)
                for label, r in res.items()}
        print(f"f64 {tag}: {runs} + {runs} runs, the same decisions and "
              f"counts in all: {same}; largest accepted-cost gaps "
              + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
              + f"; finals {sorted({t[-1][2] for t in trajs[False]})} / "
              f"{sorted({t[-1][2] for t in trajs[True]})}", flush=True)
        out[tag] = dict(same=same, gaps=gaps, kernels=trajs[False],
                        plain=trajs[True])
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--long", type=int, default=300,
                    help="raised step-2 cap of the two long runs (0: none)")
    ap.add_argument("--small", type=int, default=0)
    ap.add_argument("--small-config", default="composed",
                    choices=tuple(SMALL_CONFIGS),
                    help="the configuration of the --small runs")
    ap.add_argument("--witness", type=int, default=0)
    ap.add_argument("--step2", default="RIPOBA", choices=("RIPOBA", "RIPCG"),
                    help="the step-2 solver of the witness runs")
    ap.add_argument("--pcg", type=int, default=0,
                    help="PCG step-1 solves (the spread of their final cost)")
    ap.add_argument("--ring", type=int, default=0,
                    help="card runs of each ring_pipeline configuration "
                    "against the CPU")
    ap.add_argument("--psc", type=int, default=0,
                    help="POWER_SCHUR_COMPLEMENT step-1 solves (the spread "
                    "of their final cost)")
    ap.add_argument("--psc-device", default="cuda", choices=("cuda", "cpu"),
                    help="where the --psc solves run (cpu: the plain "
                    "versions)")
    ap.add_argument("--psc-f64", type=int, default=0,
                    help="POWER_SCHUR_COMPLEMENT step-1 solves evaluated in "
                    "f64 through the plain versions (f64_structured)")
    ap.add_argument("--varproj", type=int, default=0,
                    help="POWER_VARPROJ step-1 solves with SolverOptions() "
                    "defaults (the fused term)")
    ap.add_argument("--psc-mesh", type=int, default=0,
                    help="POWER_SCHUR_COMPLEMENT step-1 solves on a "
                    "1-device mesh (chip_smoke.py's spmd PSC check)")
    ap.add_argument("--psc-ba", type=int, default=0,
                    help="POWER_SCHUR_COMPLEMENT + RIPOBA bundle_adjust runs "
                    "(the spread of step 2's final cost)")
    ap.add_argument("--ba", type=int, default=0,
                    help="bundle_adjust runs with SolverOptions() defaults "
                    "(the spread of each step's final cost)")
    ap.add_argument("--chol", type=int, default=0,
                    help="CHOLESKY step-1 solves (the spread of their final "
                    "cost)")
    ap.add_argument("--chol-device", default="cuda", choices=("cuda", "cpu"),
                    help="where the --chol and --chol-f64 solves run (cpu: "
                    "the plain versions)")
    ap.add_argument("--chol-f64", type=int, default=0,
                    help="CHOLESKY step-1 solves evaluated in f64 through "
                    "the plain versions (f64_unstructured)")
    ap.add_argument("--f64", type=int, default=0,
                    help="pure-f64 POWER_VARPROJ and CHOLESKY step-1 solves "
                    "and RIPOBA step-2 witnesses on the card's kernels and "
                    "as many on their plain versions (pure_f64_spread)")
    ap.add_argument("--f64-mesh", type=int, default=0,
                    help="pure-f64 step-1 solves and step-2 witnesses of "
                    "F64_MESH_CONFIGS on a 1-device mesh on the card's "
                    "kernels and as many on their plain versions "
                    "(pure_f64_mesh_spread)")
    ap.add_argument("--out", default="build/step2_spread.json")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("step2_spread: needs a CUDA device")

    problem = synthetic_bal_problem_fast(89, 110_973, 5, seed=0)
    opts = SolverOptions(fused_power_term=False, device_lm_loop="off")
    args = (problem.obs_cam, problem.obs_lm, problem.obs_uv,
            problem.num_cameras, problem.num_landmarks)
    s1 = Stage1Solver(*args, opts, device="cuda")
    s2 = Stage2Solver(*args, opts, device="cuda")
    out = dict(device=torch.cuda.get_device_name(0), fixed_start=[],
               long=[], pipeline=[], small=small_gaps(a.small, a.small_config), witness=[],
               pcg=[], psc=psc_spread(problem, a.psc, a.psc_device),
               chol=step1_spread(problem, a.chol, SolverType.CHOLESKY,
                                 a.chol_device),
               chol_f64=step1_spread(problem, a.chol_f64,
                                     SolverType.CHOLESKY, a.chol_device,
                                     f64=True),
               psc_f64=step1_spread(problem, a.psc_f64,
                                    SolverType.POWER_SCHUR_COMPLEMENT,
                                    f64=True),
               varproj=step1_spread(problem, a.varproj,
                                    SolverType.POWER_VARPROJ),
               psc_mesh=step1_spread(problem, a.psc_mesh,
                                     SolverType.POWER_SCHUR_COMPLEMENT,
                                     mesh=True),
               psc_ba=psc_pipeline(problem, a.psc_ba),
               ba=ba_runs(problem, a.ba, SolverOptions(), "ba"),
               ring=ring_gaps(a.ring),
               f64=pure_f64_spread(problem, a.f64),
               f64_mesh=pure_f64_mesh_spread(problem, a.f64_mesh))
    popts = SolverOptions(solver_type_step_1=SolverType.PCG,
                          device_lm_loop="off")
    sp = Stage1Solver(*args, popts, device="cuda") if a.pcg else None
    for k in range(a.pcg):
        _p, c0, l0 = from_numpy(problem.obs_cam, problem.obs_lm,
                                problem.obs_uv, problem.cam_space,
                                problem.lm_p, device="cuda")
        s = SolverSummary()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        optimize_step1(sp, c0, l0, popts, s, Timer(), log=lambda s: None)
        torch.cuda.synchronize()
        out["pcg"].append(_record(f"pcg {k}", s, time.perf_counter() - t0))
    if a.pcg:
        finals = sorted(r["final"] for r in out["pcg"])
        print(f"pcg: {a.pcg} step-1 finals {finals[0]!r} .. {finals[-1]!r}, "
              f"median {finals[len(finals) // 2]!r}; CG counts "
              f"{sorted({tuple(r['terms']) for r in out['pcg']})}",
              flush=True)
    for k in range(a.witness):
        _p, c0, l0 = from_numpy(problem.obs_cam, problem.obs_lm,
                                problem.obs_uv, problem.cam_space,
                                problem.lm_p, device="cuda")
        s = SolverSummary()
        c1, l1 = optimize_step1(s1, c0, l0, opts, s, Timer(),
                                log=lambda s: None)
        wopts = opts if a.step2 == "RIPOBA" else SolverOptions(
            solver_type_step_2=SolverTypeRiemannian.RIPCG)
        wargs, runs = step2_witness(problem, wopts,
                                    *create_homogeneous(c1, l1))
        gaps = witness_gaps(runs, counts_when_rejected=a.step2 == "RIPOBA")
        seqs = {lab: "".join("A" if ok else "R" for ok, _n, _c in t[1:])
                for lab, (t, _s) in runs.items()}
        print(f"witness {k}: step 1 {s.final_cost.all.error!r}, "
              f"{wargs[4]} landmarks, start {runs['cpu'][0][0][2]:.6e}, "
              f"{seqs}, gaps {gaps}", flush=True)
        out["witness"].append(dict(
            step1=s.final_cost.all.error, landmarks=wargs[4],
            runs={lab: t for lab, (t, _s) in runs.items()}, gaps=gaps,
        ))

    _p, cams, lms = from_numpy(problem.obs_cam, problem.obs_lm,
                               problem.obs_uv, problem.cam_space,
                               problem.lm_p, device="cuda")
    sum1 = SolverSummary()
    cams, lms = optimize_step1(s1, cams, lms, opts, sum1, Timer(),
                               log=lambda s: None)
    out["step1"] = _record("step 1", sum1, 0.0)
    cams_h, lms_h = create_homogeneous(cams, lms)

    def step2(cap, label):
        o = copy.deepcopy(opts)
        o.max_num_iterations_step_2 = cap
        summ = SolverSummary()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        optimize_step2(s2, cams_h, lms_h, o, summ, Timer(), log=lambda s: None)
        torch.cuda.synchronize()
        return _record(label, summ, time.perf_counter() - t0)

    for k in range(a.runs):
        out["fixed_start"].append(step2(opts.max_num_iterations_step_2,
                                        f"fixed start {k}"))
    for k in range(2 if a.long else 0):
        out["long"].append(step2(a.long, f"cap {a.long} {k}"))
    for k in range(a.runs):
        p = copy.deepcopy(problem)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, r1, r2 = bundle_adjust(p, opts, log=lambda s: None)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out["pipeline"].append(dict(
            step1=_record(f"pipeline {k} s1", r1, secs),
            step2=_record(f"pipeline {k} s2", r2, secs),
        ))
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()

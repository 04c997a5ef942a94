"""The two-step stratified solve, on one device or over a mesh (the
counterpart of povar_tpu/solver/pipeline.py's `bundle_adjust`;
bundle_adjust_manual, solver/bal_bundle_adjustment.cpp:848-892):

  step 1: pOSE VarProj LM from random projective cameras
  boundary: homogenize landmarks + normalize cameras
  step 2: Riemannian joint refinement (RIPOBA or RIPCG)

Returns the optimized problem plus both step summaries.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from povar_tpu_torch.options import SolverOptions
from povar_tpu_torch.problem.problem import BalProblem
from povar_tpu_torch.solver.lm import optimize_step1, optimize_step2
from povar_tpu_torch.solver.stage1 import Stage1Solver
from povar_tpu_torch.solver.stage2 import Stage2Solver, create_homogeneous
from povar_tpu_torch.utils.summary import SolverSummary
from povar_tpu_torch.utils.timer import Timer


def _make_spmd_plan(problem: BalProblem, n_dev: int):
    """Build (and cache on the problem) the sharded windowed plan shared
    by both stage solvers."""
    from povar_tpu_torch.parallel.spmd import PART_ALIGN, build_spmd_plan

    cache = getattr(problem, "_spmd_plan_cache", None)
    if cache is not None and cache[0] == n_dev:
        return cache[1]
    plan = build_spmd_plan(
        problem.obs_cam, problem.obs_lm, problem.num_cameras,
        problem.num_landmarks, n_dev, PART_ALIGN,
    )
    problem._spmd_plan_cache = (n_dev, plan)
    return plan


def _make_solvers(problem, options, dtype, device, mesh):
    """Both stage solvers: on `device`, or on a mesh the SPMD window
    layout's (parallel/spmd.py: whole camera windows per rank, landmark
    reductions on the rank, per-camera sums and LM scalars all-reduced),
    which refuses what the JAX package runs on its GSPMD fallback."""
    if mesh is None:
        args = (problem.obs_cam, problem.obs_lm, problem.obs_uv,
                problem.num_cameras, problem.num_landmarks, options)
        return (Stage1Solver(*args, dtype=dtype, device=device),
                Stage2Solver(*args, dtype=dtype, device=device))
    from povar_tpu_torch.parallel.spmd import (
        SpmdStage1Solver,
        SpmdStage2Solver,
    )

    args = (_make_spmd_plan(problem, mesh.size), problem.obs_uv,
            problem.num_cameras, problem.num_landmarks, options, mesh)
    return (SpmdStage1Solver(*args, dtype=dtype),
            SpmdStage2Solver(*args, dtype=dtype))


def bundle_adjust(
    problem: BalProblem,
    options: Optional[SolverOptions] = None,
    log: Callable[[str], None] = print,
    dtype=torch.float64,
    device="cuda",
    mesh=None,
) -> Tuple[BalProblem, SolverSummary, SolverSummary]:
    """Run the full stratified pipeline on `device`; mutates and returns
    `problem` with optimized cam_space / lm_p / lm_p_h, plus the
    per-step summaries (step-1 summary, step-2 summary).

    `options=None` runs SolverOptions() defaults; `dtype` is the LM
    state's (f64, or f32, whose cost runs in f32 through the cam_gather
    kernel; an f64 state with `mixed_precision_solves=False` is pure
    f64, both steps on the unstructured layout with f64 solves). Both
    stage solvers are built before step 1 runs, so a configuration that
    either step does not run yet (pure f64 or CHOLESKY on a mesh, ...)
    raises NotImplementedError before any work.

    With `mesh` (parallel/mesh.make_mesh: this rank of a mesh, on the
    mesh's device, which replaces `device`), both stages run the SPMD
    window layout (parallel/spmd.py), each rank on its shard with the
    same LM decisions; every rank returns the whole problem, and only
    rank 0 logs. A mesh runs an f64 state in mixed precision with
    `pallas_kernels` on and an iterative step-1 solver; anything else
    raises NotImplementedError."""
    options = options or SolverOptions()
    timer_total = Timer()
    s1, s2 = _make_solvers(problem, options, dtype, device, mesh)
    n_mesh = 1 if mesh is None else mesh.size
    if mesh is not None and mesh.rank != 0:
        log = _quiet

    summary1 = SolverSummary(num_threads_given=n_mesh,
                             num_threads_used=n_mesh)
    cams = torch.as_tensor(problem.cam_space, dtype=dtype, device=s1.device)
    if mesh is None:
        lms = torch.as_tensor(problem.lm_p, dtype=dtype, device=s1.device)
    else:
        # landmark state lives in the plan's device-major padded order,
        # each rank holding its shard; canonical again at the end
        lms = s1.pad_landmarks(problem.lm_p)
    cams, lms = optimize_step1(
        s1, cams, lms, options, summary1, timer_total, log
    )
    # step 1's device loop (on the card its graph and memory pool),
    # freed before step 2 makes its own
    s1.device_runs.clear()

    cams, lms_h = create_homogeneous(cams, lms)
    summary2 = SolverSummary(num_threads_given=n_mesh,
                             num_threads_used=n_mesh)
    cams, lms_h = optimize_step2(
        s2, cams, lms_h, options, summary2, timer_total, log
    )

    problem.cam_space = cams.cpu().numpy()
    lms_h_np = (lms_h.cpu().numpy() if mesh is None
                else s1.unpad_landmarks(lms_h))
    problem.lm_p_h = lms_h_np
    problem.lm_p = lms_h_np[:, :3] / lms_h_np[:, 3:4]
    return problem, summary1, summary2


def _quiet(_line: str) -> None:
    """The log of a rank other than 0."""

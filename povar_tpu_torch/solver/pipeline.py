"""The two-step stratified solve on one device (the counterpart of
povar_tpu/solver/pipeline.py's `bundle_adjust` without a mesh;
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


def bundle_adjust(
    problem: BalProblem,
    options: Optional[SolverOptions] = None,
    log: Callable[[str], None] = print,
    dtype=torch.float64,
    device="cuda",
) -> Tuple[BalProblem, SolverSummary, SolverSummary]:
    """Run the full stratified pipeline on `device`; mutates and returns
    `problem` with optimized cam_space / lm_p / lm_p_h, plus the
    per-step summaries (step-1 summary, step-2 summary).

    `options=None` runs SolverOptions() defaults; `dtype` is the LM
    state's (f64, or f32, whose cost runs in f32 through the cam_gather
    kernel). Both stage solvers are built before step 1 runs, so a
    configuration that either step does not run yet (pure f64, more
    than 1024 cameras, ...) raises NotImplementedError before any
    work. Multi-device solves (the JAX package's `mesh`) are not ported
    (ROADMAP.md queue 1 item 13)."""
    options = options or SolverOptions()
    timer_total = Timer()
    args = (problem.obs_cam, problem.obs_lm, problem.obs_uv,
            problem.num_cameras, problem.num_landmarks, options)
    s1 = Stage1Solver(*args, dtype=dtype, device=device)
    s2 = Stage2Solver(*args, dtype=dtype, device=device)

    summary1 = SolverSummary(num_threads_given=1, num_threads_used=1)
    cams = torch.as_tensor(problem.cam_space, dtype=dtype, device=s1.device)
    lms = torch.as_tensor(problem.lm_p, dtype=dtype, device=s1.device)
    cams, lms = optimize_step1(
        s1, cams, lms, options, summary1, timer_total, log
    )

    cams, lms_h = create_homogeneous(cams, lms)
    summary2 = SolverSummary(num_threads_given=1, num_threads_used=1)
    cams, lms_h = optimize_step2(
        s2, cams, lms_h, options, summary2, timer_total, log
    )

    problem.cam_space = cams.cpu().numpy()
    lms_h_np = lms_h.cpu().numpy()
    problem.lm_p_h = lms_h_np
    problem.lm_p = lms_h_np[:, :3] / lms_h_np[:, 3:4]
    return problem, summary1, summary2

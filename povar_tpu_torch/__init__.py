"""povar_tpu_torch — the PyTorch / CUDA port of povar_tpu.

Initialization-free stratified projective bundle adjustment (Power
Variable Projection, tum-vision/povar) on an NVIDIA H100. This package
runs the two-step solve, `bundle_adjust`, with `SolverOptions()`
defaults: step 1, pOSE Variable Projection LM with the POWER_VARPROJ
solver (or POWER_SCHUR_COMPLEMENT, or PCG); the homogenize/normalize
boundary (`create_homogeneous`); step 2, Riemannian LM with the RIPOBA
solver (or RIPCG); m = 10 power terms through the fused power-term
kernels, f64 LM state and costs (or an f32 state, `dtype=torch.float32`),
f32 inner solves, on the structured per-observation layout of the JAX
package. Its per-observation passes are hand-written CUDA
kernels for sm_90a (csrc/), built with nvcc at first use
(ops/_build.py); on tensors that lie on the CPU the same calls run their
plain PyTorch versions (ops/pose_ref.py, ops/pose2_ref.py,
ops/cam_ref.py). Entry
points run on the card (device="cuda") unless the caller asks for the
CPU. The command-line app is `python -m povar_tpu_torch.cli`
(`povar-bal-torch`). `bundle_adjust(..., mesh=make_mesh(...))` runs the
JAX package's multi-device SPMD window layout (parallel/spmd.py,
`SpmdStage1Solver` / `SpmdStage2Solver`) with one process per device
(parallel/mesh.py); its three slot reduce/expand kernels are CUDA too.

The JAX package `povar_tpu` is the reference this port is held against.
Nothing here imports jax or povar_tpu: the numpy-only modules the port
needs (options, problem, BAL I/O, synthetic generators, summaries, the
ba_log writer) are copies.

    from povar_tpu_torch import (
        SolverOptions, bundle_adjust, synthetic_bal_problem_fast,
    )
    problem, summary1, summary2 = bundle_adjust(
        synthetic_bal_problem_fast(89, 110973, 5, seed=0), SolverOptions())
"""

from povar_tpu_torch.options import SolverOptions
from povar_tpu_torch.parallel.mesh import make_mesh
from povar_tpu_torch.parallel.spmd import SpmdStage1Solver, SpmdStage2Solver
from povar_tpu_torch.problem import (
    BalProblem,
    from_numpy,
    synthetic_bal_problem,
    synthetic_bal_problem_fast,
)
from povar_tpu_torch.solver.lm import optimize_step1, optimize_step2
from povar_tpu_torch.solver.pipeline import bundle_adjust
from povar_tpu_torch.solver.stage1 import Stage1Solver
from povar_tpu_torch.solver.stage2 import Stage2Solver, create_homogeneous
from povar_tpu_torch.utils.summary import SolverSummary
from povar_tpu_torch.utils.timer import Timer

__version__ = "0.3.0"

__all__ = [
    "BalProblem",
    "SolverOptions",
    "SolverSummary",
    "SpmdStage1Solver",
    "SpmdStage2Solver",
    "Stage1Solver",
    "Stage2Solver",
    "Timer",
    "bundle_adjust",
    "create_homogeneous",
    "from_numpy",
    "make_mesh",
    "optimize_step1",
    "optimize_step2",
    "synthetic_bal_problem",
    "synthetic_bal_problem_fast",
]

"""povar_tpu_torch — the PyTorch / CUDA port of povar_tpu.

Initialization-free stratified projective bundle adjustment (Power
Variable Projection, tum-vision/povar) on an NVIDIA H100. This package
runs step 1 of the solve: pOSE Variable Projection LM with the
POWER_VARPROJ solver (m = 10 power terms, f64 LM state and costs, f32
inner solves), on the structured per-observation layout of the JAX
package. Its seven per-observation passes are hand-written CUDA kernels
for sm_90a (csrc/), built with nvcc at first use (ops/_build.py); on
tensors that lie on the CPU the same calls run their plain PyTorch
versions (ops/pose_ref.py).

The JAX package `povar_tpu` is the reference this port is held against.
Nothing here imports jax or povar_tpu: the numpy-only modules the slice
needs (options, problem, synthetic generators, summaries) are copies.

    from povar_tpu_torch import (
        SolverOptions, Stage1Solver, optimize_step1,
        synthetic_bal_problem_fast, from_numpy,
    )
"""

from povar_tpu_torch.options import SolverOptions
from povar_tpu_torch.problem import (
    BalProblem,
    from_numpy,
    synthetic_bal_problem,
    synthetic_bal_problem_fast,
)
from povar_tpu_torch.solver.lm import optimize_step1
from povar_tpu_torch.solver.stage1 import Stage1Solver
from povar_tpu_torch.utils.summary import SolverSummary
from povar_tpu_torch.utils.timer import Timer

__version__ = "0.1.0"

__all__ = [
    "BalProblem",
    "SolverOptions",
    "SolverSummary",
    "Stage1Solver",
    "Timer",
    "from_numpy",
    "optimize_step1",
    "synthetic_bal_problem",
    "synthetic_bal_problem_fast",
]

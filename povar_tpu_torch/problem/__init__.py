from povar_tpu_torch.problem.problem import (
    BalProblem,
    DatasetSummary,
    from_numpy,
)
from povar_tpu_torch.problem.synthetic import (
    synthetic_bal_problem,
    synthetic_bal_problem_fast,
)

__all__ = [
    "BalProblem",
    "DatasetSummary",
    "from_numpy",
    "synthetic_bal_problem",
    "synthetic_bal_problem_fast",
]

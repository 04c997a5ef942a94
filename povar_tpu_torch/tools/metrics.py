"""Metric accessors over loaded ba_logs.

Equivalent of python/rootba/metric.py:31-190: a registry of named
metrics (cost, iteration counts, stage times, memory, ...), each an
accessor over a loaded Log plus formatting/highlight policy, with
support for relative-to-baseline display (relative_to_experiment /
relative_to_metric / ratio-or-difference) and "name@itN" experiment
specs pinning a metric to a specific iteration.

Independent implementation against this framework's Log model
(tools/log.py); accessor names match the reference registry
so experiment configs port over.

A copy of povar_tpu/tools/metrics.py with its imports rewritten to this
package, which never imports jax or povar_tpu.
"""

from __future__ import annotations

import copy
import math
from typing import Callable, Dict, List, Optional

import numpy as np

from povar_tpu_torch.tools.log import Log


class ExperimentSpec:
    """'name' or 'name@itN' — an experiment reference, optionally
    pinned to iteration N (metric.py ExperimentSpec)."""

    def __init__(self, string: str):
        if "@it" in string:
            self.name, it = string.split("@it")
            self.it = int(it)
        else:
            self.name = string
            self.it = -1

    def display_name(self, display: str) -> str:
        return display if self.it == -1 else f"{display} @ it{self.it}"


class Metric:
    """A named scalar over a run's log."""

    def __init__(
        self,
        display_name: str,
        accessor: Callable[[Log, int], float],
        decimals: int = 0,
        format_string: str = "{:.{prec}f}",
        highlight_top: bool = True,
        geometric_mean: bool = False,
        larger_is_better: bool = False,
    ):
        self.display_name = display_name
        self.accessor = accessor
        self.decimals = decimals
        self.display_decimals: Optional[int] = None
        self.format_string = format_string
        self.highlight_top = highlight_top
        self.geometric_mean = geometric_mean
        self.larger_is_better = larger_is_better
        self.relative_to_experiment: Optional[ExperimentSpec] = None
        self.relative_to_metric: Optional["Metric"] = None
        self.ratio = True
        self.failed_threshold: Optional[float] = None

    def configure(self, spec: dict) -> "Metric":
        """Apply a config-table override (metric.py set_config)."""
        if any(
            k in spec
            for k in ("relative_to_experiment", "relative_to_metric")
        ):
            # relative display defaults: 3 decimals, geometric mean
            self.decimals = 3
            self.display_decimals = 3
            self.format_string = "{:.3f}"
            self.geometric_mean = True
        for k in (
            "display_name", "decimals", "display_decimals",
            "format_string", "highlight_top", "larger_is_better",
            "geometric_mean", "ratio", "failed_threshold",
        ):
            if k in spec:
                setattr(self, k, spec[k])
        if "relative_to_experiment" in spec:
            self.relative_to_experiment = ExperimentSpec(
                spec["relative_to_experiment"]
            )
        if "relative_to_metric" in spec:
            self.relative_to_metric = get_metric(spec["relative_to_metric"])
        return self

    def effective_display_decimals(self) -> int:
        if self.display_decimals is not None:
            return self.display_decimals
        return self.decimals

    def value(self, exps, exp, seq: str, it: int = -1) -> float:
        """Evaluate on experiment `exp`'s run for sequence `seq`,
        applying the relative-to baseline if configured. `exps` maps
        experiment name -> experiment (for relative_to_experiment)."""
        log = exp.runs[seq].log
        v = self.accessor(log, it)
        base_acc = (
            self.relative_to_metric.accessor
            if self.relative_to_metric is not None
            else self.accessor
        )
        if self.relative_to_experiment is not None:
            base_log = (
                exps[self.relative_to_experiment.name].runs[seq].log
            )
            base_it = self.relative_to_experiment.it
        else:
            base_log = log
            base_it = it
        if (
            self.relative_to_metric is not None
            or self.relative_to_experiment is not None
        ):
            base = base_acc(base_log, base_it)
            v = v / base if self.ratio else base - v
        return v

    def format(self, v: float) -> str:
        if v is None or (isinstance(v, float) and math.isnan(v)):
            return "-"
        return self.format_string.format(
            v, prec=self.effective_display_decimals()
        )


def _it_field(log: Log, field: str, it: int, section: str = "iterations"):
    arr = log.iteration_array(field, section)
    if len(arr) == 0:
        return float("nan")
    return arr[it]


def _solver(log: Log, field: str, section: str = "solver"):
    return float(log.data.get(section, {}).get(field, float("nan")))


def _sum(log: Log, field: str, section: str = "iterations"):
    return float(np.sum(log.iteration_array(field, section)))


# Registry: same metric names as metric.py:137-177 so experiment
# configs port over (plus *_step1 variants for the first pipeline step,
# which the reference logs under solver1/iterations1).
METRICS: Dict[str, Metric] = dict(
    cost=Metric("cost", lambda l, it: _it_field(l, "cost", it), 3,
                format_string="{:.{prec}e}"),
    cost_valid=Metric("cost valid",
                      lambda l, it: _it_field(l, "cost_valid", it), 3,
                      format_string="{:.{prec}e}"),
    cost_avg_valid=Metric(
        "cost avg valid",
        lambda l, it: _it_field(l, "cost_avg_valid", it), 3),
    num_it_total=Metric(
        "#it", lambda l, it: _it_field(l, "iteration", it), 0),
    num_it_valid=Metric(
        "#it valid",
        lambda l, it: float(np.sum(
            l.iteration_array("step_is_valid")[1:])), 0),
    num_it_successful=Metric(
        "#it succ",
        lambda l, it: float(np.sum(
            l.iteration_array("step_is_successful")[1:])), 0),
    num_it_inner=Metric(
        "#it inner",
        lambda l, it: _sum(l, "linear_solver_iterations"), 0),
    num_lin_solve=Metric(
        "#lin-solve",
        lambda l, it: _solver(l, "num_linear_solves"), 0),
    num_res_eval=Metric(
        "#res-eval",
        lambda l, it: _solver(l, "num_residual_evaluations"), 0),
    num_jac_eval=Metric(
        "#jac-eval",
        lambda l, it: _solver(l, "num_jacobian_evaluations"), 0),
    solver_total_time=Metric(
        "t total (s)",
        lambda l, it: _solver(l, "total_time_in_seconds"), 1),
    solver_preprocessor_time=Metric(
        "t preproc. (s)",
        lambda l, it: _solver(l, "preprocessor_time_in_seconds"), 1),
    solver_minimizer_time=Metric(
        "t minim. (s)",
        lambda l, it: _solver(l, "minimizer_time_in_seconds"), 1),
    solver_postprocessor_time=Metric(
        "t postproc. (s)",
        lambda l, it: _solver(l, "postprocessor_time_in_seconds"), 1),
    solver_linear_solver_time=Metric(
        "t lin-solve (s)",
        lambda l, it: _solver(l, "linear_solver_time_in_seconds"), 1),
    solver_residual_evaluation_time=Metric(
        "t res-eval (s)",
        lambda l, it: _solver(l, "residual_evaluation_time_in_seconds"),
        1),
    solver_jacobian_evaluation_time=Metric(
        "t jac-eval (s)",
        lambda l, it: _solver(l, "jacobian_evaluation_time_in_seconds"),
        1),
    stage1_time=Metric(
        "stage 1 time (s)", lambda l, it: _sum(l, "stage1_time"), 1),
    stage2_time=Metric(
        "stage 2 time (s)", lambda l, it: _sum(l, "stage2_time"), 1),
    cg_time=Metric(
        "cg time (s)",
        lambda l, it: _sum(l, "solve_reduced_system_time"), 1),
    cg_time_per_inner_it=Metric(
        "cg-time / 1000-inner-it (s)",
        lambda l, it: 1000.0 * _sum(l, "solve_reduced_system_time")
        / max(_sum(l, "linear_solver_iterations"), 1.0), 1),
    resident_memory_peak=Metric(
        "mem peak (GB)",
        lambda l, it: _solver(l, "resident_memory_peak") / 2**30, 1),
    # step-1 (pOSE VarProj) variants: reference logs step 1 under
    # solver1/iterations1 (ba_log.cpp layout)
    cost_step1=Metric(
        "cost s1",
        lambda l, it: _it_field(l, "cost", it, "iterations1"), 3,
        format_string="{:.{prec}e}"),
    num_it_step1=Metric(
        "#it s1",
        lambda l, it: _it_field(l, "iteration", it, "iterations1"), 0),
    solver_total_time_step1=Metric(
        "t total s1 (s)",
        lambda l, it: _solver(l, "minimizer_time_in_seconds", "solver1"),
        1),
)


def get_metric(name_or_spec) -> Metric:
    """Resolve a metric by name or {name: ..., <overrides>} table."""
    if isinstance(name_or_spec, str):
        return copy.copy(METRICS[name_or_spec])
    m = copy.copy(METRICS[name_or_spec["name"]])
    return m.configure(name_or_spec)


def metrics_from_spec(spec: List) -> List[Metric]:
    return [get_metric(m) for m in spec]

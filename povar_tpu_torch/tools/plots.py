"""Convergence plots and performance-profile figures.

Equivalent of the core of python/rootba/latex/plot.py (~800 LoC of
config-driven matplotlib grids: cost-vs-time and cost-vs-iteration
curves per sequence with solver variants overlaid, log axes, tolerance
markers) and latex/performance_profiles.py (Dolan-More profile
figures). Matplotlib is imported lazily and with the Agg backend so the
tools run headless.

A copy of povar_tpu/tools/plots.py with its imports rewritten to this
package, which never imports jax or povar_tpu.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from povar_tpu_torch.tools.log import Log


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def convergence_grid(
    runs: Dict[str, Dict[str, Log]],
    path: str,
    x: str = "time",  # "time" | "iteration"
    section: str = "iterations",
    tolerances: Sequence[float] = (0.01,),
    ncols: int = 3,
    title: Optional[str] = None,
):
    """Grid of convergence curves: one subplot per problem, one curve
    per solver (cost over cumulative time or iteration index, log-y).
    Horizontal lines mark min_cost*(1+tol) for each tolerance — the
    thresholds the performance profiles measure against
    (latex/plot.py cost plots + latex/performance_profiles.py)."""
    plt = _plt()
    problems = sorted(runs)
    n = len(problems)
    ncols = max(1, min(ncols, n))
    nrows = math.ceil(n / ncols)
    fig, axes = plt.subplots(
        nrows, ncols, figsize=(4.5 * ncols, 3.2 * nrows), squeeze=False
    )
    for ax in axes.flat[n:]:
        ax.set_visible(False)
    for i, prob in enumerate(problems):
        ax = axes.flat[i]
        best = np.inf
        for solver in sorted(runs[prob]):
            log = runs[prob][solver]
            if log is None:
                continue
            t, c = log.cost_curve(section)
            if len(c) == 0:
                continue
            best = min(best, float(c.min()))
            xs = t if x == "time" else np.arange(len(c))
            ax.plot(xs, c, marker=".", markersize=3, label=solver)
        if np.isfinite(best):
            for tol in tolerances:
                ax.axhline(
                    best * (1.0 + tol), color="gray", ls="--", lw=0.8
                )
        ax.set_yscale("log")
        ax.set_title(prob, fontsize=9)
        ax.set_xlabel("time [s]" if x == "time" else "iteration")
        ax.set_ylabel("cost")
        ax.grid(True, alpha=0.3)
        if i == 0:
            ax.legend(fontsize=7)
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path


def profile_figure(
    taus: np.ndarray,
    profiles: Dict[str, np.ndarray],
    path: str,
    title: Optional[str] = None,
    log_x: bool = False,
):
    """Render a Dolan-More performance profile (fraction of problems
    solved within tau x best time, per solver)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(5.5, 3.8))
    for solver in sorted(profiles):
        ax.step(taus, profiles[solver], where="post", label=solver)
    if log_x:
        ax.set_xscale("log")
    ax.set_xlabel(r"relative time $\tau$")
    ax.set_ylabel("fraction of problems")
    ax.set_ylim(-0.02, 1.02)
    ax.grid(True, alpha=0.3)
    ax.legend(fontsize=8)
    if title:
        ax.set_title(title)
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path


def timing_breakdown_figure(
    logs: Dict[str, Log],
    path: str,
    section: str = "iterations",
    fields: Sequence[str] = (
        "jacobian_evaluation_time",
        "scale_landmark_jacobian_time",
        "scale_pose_jacobian_time",
        "perform_qr_time",
        "stage2_time",
        "prepare_time",
        "compute_preconditioner_time",
        "solve_reduced_system_time",
        "back_substitution_time",
        "update_cameras_time",
        "residual_evaluation_time",
    ),
    title: Optional[str] = None,
):
    """Stacked per-stage time bars, one bar per run — the ba_log view
    of where solve time goes (the reference prints these timings per
    iteration; this aggregates them like its memory/time plots)."""
    plt = _plt()
    names = sorted(logs)
    fig, ax = plt.subplots(figsize=(1.6 + 1.1 * len(names), 4.0))
    bottoms = np.zeros(len(names))
    for f in fields:
        vals = np.array(
            [float(np.sum(logs[n].iteration_array(f, section)))
             for n in names]
        )
        if not np.any(vals > 0):
            continue
        ax.bar(names, vals, bottom=bottoms,
               label=f.replace("_time", "").replace("_", " "))
        bottoms += vals
    ax.set_ylabel("time [s]")
    ax.grid(True, axis="y", alpha=0.3)
    ax.legend(fontsize=7)
    if title:
        ax.set_title(title)
    plt.setp(ax.get_xticklabels(), rotation=30, ha="right", fontsize=8)
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path

"""Results tables and performance profiles.

Equivalent of python/rootba/generate_tables.py +
latex/performance_profiles.py: per-problem results tables (final cost,
time-to-tolerance, iterations) and Dolan-More performance profiles
comparing solver configurations by time to reach cost thresholds.

A copy of povar_tpu/tools/tables.py with its imports rewritten to this
package, which never imports jax or povar_tpu.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from povar_tpu_torch.tools.log import Log


def time_to_cost_tolerance(
    log: Log, tolerance: float, section: str = "iterations"
) -> Optional[float]:
    """Wall time until the cost first reaches
    min_cost * (1 + tolerance) (the reference's performance-profile
    metric: time-to-cost-tolerance relative to the best cost achieved)."""
    t, c = log.cost_curve(section)
    if len(c) == 0:
        return None
    threshold = c.min() * (1.0 + tolerance)
    idx = np.argmax(c <= threshold)
    if c[idx] > threshold:
        return None
    return float(t[idx])


def results_table(
    runs: Dict[str, Dict[str, Log]],
    tolerance: float = 0.01,
) -> str:
    """Plain-text results table: rows = problems, cols = solvers,
    cells = final cost / time-to-tolerance."""
    solvers = sorted({s for per in runs.values() for s in per})
    lines = ["problem".ljust(28) + "".join(s.ljust(26) for s in solvers)]
    for prob in sorted(runs):
        row = prob.ljust(28)
        for s in solvers:
            log = runs[prob].get(s)
            if log is None:
                row += "-".ljust(26)
                continue
            fc = log.final_cost()
            tt = time_to_cost_tolerance(log, tolerance)
            cell = f"{fc:.4e} / {tt:.2f}s" if fc is not None else "-"
            row += cell.ljust(26)
        lines.append(row)
    return "\n".join(lines)


def performance_profile(
    times: Dict[str, List[Optional[float]]],
    taus: Optional[Sequence[float]] = None,
) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Dolan-More performance profile.

    times[solver][i] = time of solver on problem i (None = failed).
    Returns (taus, {solver: fraction of problems solved within
    tau * best_time}).
    """
    solvers = list(times)
    n_prob = len(next(iter(times.values())))
    mat = np.full((len(solvers), n_prob), np.inf)
    for si, s in enumerate(solvers):
        for pi, t in enumerate(times[s]):
            if t is not None:
                mat[si, pi] = t
    best = mat.min(axis=0)
    if taus is None:
        taus = np.linspace(1.0, 10.0, 200)
    taus = np.asarray(taus)
    profiles = {}
    for si, s in enumerate(solvers):
        ratio = mat[si] / best
        profiles[s] = np.array(
            [(ratio <= tau).mean() for tau in taus]
        )
    return taus, profiles


def latex_results_table(
    runs: Dict[str, Dict[str, Log]], tolerance: float = 0.01
) -> str:
    """LaTeX variant of the results table (generate_tables.py output)."""
    solvers = sorted({s for per in runs.values() for s in per})
    header = (
        "\\begin{tabular}{l" + "c" * len(solvers) + "}\n\\toprule\n"
        + "problem & " + " & ".join(solvers) + " \\\\\n\\midrule\n"
    )
    body = ""
    for prob in sorted(runs):
        cells = []
        for s in solvers:
            log = runs[prob].get(s)
            if log is None or log.final_cost() is None:
                cells.append("--")
            else:
                tt = time_to_cost_tolerance(log, tolerance)
                tts = f"{tt:.2f}" if tt is not None else "--"
                cells.append(f"{log.final_cost():.3e} / {tts}s")
        body += prob.replace("_", "\\_") + " & " + " & ".join(cells)
        body += " \\\\\n"
    return header + body + "\\bottomrule\n\\end{tabular}\n"


# -------------------------------------------------- metric-driven tables
# (latex/overview_table.py:21-109 + latex/results_table.py equivalents,
# rendered as aligned text and as LaTeX tabular source)


_PROBLEM_ACCESSORS = {
    "#cam": lambda info: f"{int(info.get('num_cameras', 0)):,}",
    "#lm": lambda info: f"{int(info.get('num_landmarks', 0)):,}",
    "#obs": lambda info: f"{int(info.get('num_observations', 0)):,}",
    "#obs-per-cam": lambda info: "{:,.1f}".format(
        info.get("num_observations", 0)
        / max(info.get("num_cameras", 1), 1)
    ),
    "#obs-per-lm-mean": lambda info: "{:.1f}".format(
        info.get("per_lm_obs", {}).get("mean", 0.0)
    ),
    "#obs-per-lm-max": lambda info: str(
        int(info.get("per_lm_obs", {}).get("max", 0))
    ),
    "rcs-sparsity": lambda info: "{:.0f}%".format(
        100.0 * info.get("rcs_sparsity", 0.0)
    ),
}


def overview_table(exps: Dict, columns, filter_regex=None) -> str:
    """Problem-overview table: rows = sequences, column groups =
    experiments, cells = problem-size stats from each run's log
    (the latex/overview_table.py accessors: #cam, #lm, #obs,
    #obs-per-cam, #obs-per-lm-mean/max, rcs-sparsity).

    `columns` = list of (experiment_name, [stat names])."""
    seqs = sorted(
        {s for name, _ in columns for s in exps[name].sequences(filter_regex)}
    )
    flat = [(name, stat) for name, stats in columns for stat in stats]
    # column width: widest stat label + 2 so long labels ("#obs-per-
    # lm-mean") keep a separator instead of jamming into the neighbor
    width = max(16, max(len(stat) for _, stat in flat) + 2)
    head1 = "".ljust(28) + "".join(
        name.ljust(width * len(stats)) for name, stats in columns
    )
    head2 = "".ljust(28) + "".join(
        stat.ljust(width) for _, stat in flat
    )
    lines = [head1, head2, "-" * len(head2)]
    for seq in seqs:
        row = seq.ljust(28)
        for name, stat in flat:
            run = exps[name].runs.get(seq)
            if run is None or run.log is None:
                row += ("(failed)" if run is not None else "?").ljust(width)
                continue
            info = dict(run.log.problem_info)
            row += str(_PROBLEM_ACCESSORS[stat](info)).ljust(width)
        lines.append(row)
    return "\n".join(lines)


def metric_results_table(
    exps: Dict,
    experiment_names: Sequence[str],
    metric_specs: Sequence,
    filter_regex=None,
    it: int = -1,
    latex: bool = False,
) -> str:
    """Results table driven by the metric registry
    (tools/metrics.py): rows = sequences, column groups = metrics,
    sub-columns = experiments — the layout of
    latex/results_table.py. Supports every registry metric including
    relative-to-experiment baselines; appends the per-metric mean
    (geometric where the metric requests it) like the reference's
    summary row."""
    from povar_tpu_torch.tools.metrics import metrics_from_spec

    metrics = metrics_from_spec(list(metric_specs))
    seqs = sorted(
        {
            s
            for name in experiment_names
            for s in exps[name].sequences(filter_regex)
        }
    )
    cells: Dict[tuple, str] = {}
    values: Dict[tuple, list] = {}
    for m_i, m in enumerate(metrics):
        for name in experiment_names:
            col_vals = []
            for seq in seqs:
                run = exps[name].runs.get(seq)
                if run is None or run.log is None or run.is_failed:
                    cells[(seq, m_i, name)] = "x"
                    continue
                try:
                    v = m.value(exps, exps[name], seq, it)
                except Exception:
                    cells[(seq, m_i, name)] = "-"
                    continue
                cells[(seq, m_i, name)] = m.format(v)
                col_vals.append(v)
            values[(m_i, name)] = col_vals
    width = 14

    def mean_cell(m_i, m, name):
        vals = [v for v in values.get((m_i, name), []) if np.isfinite(v)]
        if not vals:
            return "-"
        if m.geometric_mean:
            mean = float(np.exp(np.mean(np.log(np.maximum(vals, 1e-30)))))
        else:
            mean = float(np.mean(vals))
        return m.format(mean)

    if latex:
        ncol = len(metrics) * len(experiment_names)
        out = "\\begin{tabular}{l" + "r" * ncol + "}\n\\toprule\n"
        out += (
            " & "
            + " & ".join(
                f"\\multicolumn{{{len(experiment_names)}}}{{c}}"
                f"{{{m.display_name}}}"
                for m in metrics
            )
            + " \\\\\n"
        )
        out += (
            " & "
            + " & ".join(
                n for _ in metrics for n in experiment_names
            )
            + " \\\\\n\\midrule\n"
        )
        for seq in seqs:
            out += seq.replace("_", "\\_")
            for m_i in range(len(metrics)):
                for name in experiment_names:
                    out += " & " + cells[(seq, m_i, name)]
            out += " \\\\\n"
        out += "\\midrule\nmean"
        for m_i, m in enumerate(metrics):
            for name in experiment_names:
                out += " & " + mean_cell(m_i, m, name)
        out += " \\\\\n\\bottomrule\n\\end{tabular}\n"
        return out

    head1 = "".ljust(28) + "".join(
        m.display_name.ljust(width * len(experiment_names))
        for m in metrics
    )
    head2 = "".ljust(28) + "".join(
        n[:width - 1].ljust(width)
        for _ in metrics
        for n in experiment_names
    )
    lines = [head1, head2, "-" * len(head2)]
    for seq in seqs:
        row = seq.ljust(28)
        for m_i in range(len(metrics)):
            for name in experiment_names:
                row += cells[(seq, m_i, name)].ljust(width)
        lines.append(row)
    row = "mean".ljust(28)
    for m_i, m in enumerate(metrics):
        for name in experiment_names:
            row += mean_cell(m_i, m, name).ljust(width)
    lines.append(row)
    return "\n".join(lines)


def summarize_table(
    exps: Dict,
    experiment_names: Sequence[str],
    metric_specs: Sequence,
    filter_regex=None,
    it: int = -1,
    latex: bool = False,
) -> str:
    """Sequence-aggregated comparison: rows = metrics, columns =
    experiments, cells = (geometric) mean over all sequences, best
    value bolded / second italicized (latex) or marked * / '
    (text) — latex/summarize_sequences_table.py:22-88 equivalent."""
    from povar_tpu_torch.tools.metrics import metrics_from_spec

    metrics = metrics_from_spec(list(metric_specs))
    seqs = sorted(
        {
            s
            for name in experiment_names
            for s in exps[name].sequences(filter_regex)
        }
    )
    means: Dict[tuple, float] = {}
    for m_i, m in enumerate(metrics):
        for name in experiment_names:
            vals = []
            for seq in seqs:
                run = exps[name].runs.get(seq)
                if run is None or run.log is None or run.is_failed:
                    continue
                try:
                    vals.append(m.value(exps, exps[name], seq, it))
                except Exception:
                    continue
            vals = [v for v in vals if np.isfinite(v)]
            if not vals:
                means[(m_i, name)] = float("nan")
            elif m.geometric_mean:
                means[(m_i, name)] = float(
                    np.exp(np.mean(np.log(np.maximum(vals, 1e-30))))
                )
            else:
                means[(m_i, name)] = float(np.mean(vals))

    def top_two(m_i, m):
        vals = sorted(
            {
                v
                for name in experiment_names
                if np.isfinite(v := means[(m_i, name)])
            },
            reverse=m.larger_is_better,
        )
        best = vals[0] if vals else None
        second = vals[1] if len(vals) > 1 else None
        return best, second

    if latex:
        out = (
            "\\begin{tabular}{l" + "c" * len(experiment_names)
            + "}\n\\toprule\n & "
            + " & ".join(experiment_names)
            + " \\\\\n\\midrule\n"
        )
        for m_i, m in enumerate(metrics):
            best, second = top_two(m_i, m)
            out += m.display_name
            for name in experiment_names:
                v = means[(m_i, name)]
                cell = m.format(v)
                if v == best:
                    cell = "\\textbf{" + cell + "}"
                elif v == second:
                    cell = "\\textit{" + cell + "}"
                out += " & " + cell
            out += " \\\\\n"
        return out + "\\bottomrule\n\\end{tabular}\n"

    width = 16
    lines = [
        "".ljust(24)
        + "".join(n[: width - 1].ljust(width) for n in experiment_names)
    ]
    lines.append("-" * (24 + width * len(experiment_names)))
    for m_i, m in enumerate(metrics):
        best, second = top_two(m_i, m)
        row = m.display_name[:23].ljust(24)
        for name in experiment_names:
            v = means[(m_i, name)]
            cell = m.format(v)
            if v == best:
                cell += " *"
            elif v == second:
                cell += " '"
            row += cell.ljust(width)
        lines.append(row)
    return "\n".join(lines)

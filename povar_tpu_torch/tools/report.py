"""Report generator: one command from run directories to tables,
profiles, and plots.

Equivalent of python/rootba/generate_tables.py + the latex/ rendering
layer: load an experiments config (with substitutions/templates,
tools/experiments.py), then render every `[[results]]` section —
overview tables, metric results tables, Dolan-More performance
profiles, convergence plot grids, timing breakdowns — into an output
directory as text, LaTeX, and PNG artifacts plus a combined report.md.

    python -m povar_tpu_torch.tools.report experiments.toml [-o OUT]

Config sketch (TOML):

    [substitutions]
    base = "runs"

    [[experiments]]
    name = "power"
    pattern = "${base}/power/*"

    [[results]]
    class = "results_table"
    name = "costs"
    experiments = ["power", "pcg"]
    metrics = ["cost", "solver_total_time"]

    [[results]]
    class = "performance_profile"
    name = "profile-1pc"
    experiments = ["power", "pcg"]
    tolerance = 0.01

A copy of povar_tpu/tools/report.py with its imports rewritten to this
package, which never imports jax or povar_tpu.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List

from povar_tpu_torch.tools.experiments import (
    load_experiments_config,
    load_experiments,
)
from povar_tpu_torch.tools import tables as tables_mod
from povar_tpu_torch.tools import plots as plots_mod


def _runs_by_problem(exps, names, filter_regex=None):
    """{problem: {experiment: Log}} for the named experiments."""
    out: Dict[str, Dict[str, object]] = {}
    for name in names:
        for seq in exps[name].sequences(filter_regex):
            run = exps[name].runs[seq]
            if run.log is not None:
                out.setdefault(seq, {})[name] = run.log
    return out


def render_results(config: dict, exps, out_dir: str) -> List[str]:
    """Render every results spec; returns the artifact paths."""
    os.makedirs(out_dir, exist_ok=True)
    artifacts: List[str] = []
    report: List[str] = ["# Results report\n"]
    for i, spec in enumerate(config["results"]):
        cls = spec.get("class", "results_table")
        name = spec.get("name", f"{cls}-{i}")
        fr = spec.get("filter_regex", config["options"].get("filter_regex"))
        exp_names = spec.get(
            "experiments", [e["name"] for e in config["experiments"]]
        )
        report.append(f"\n## {name}\n")
        if cls == "overview_table":
            stats = spec.get(
                "stats",
                ["#cam", "#lm", "#obs", "#obs-per-lm-mean", "rcs-sparsity"],
            )
            txt = tables_mod.overview_table(
                exps, [(exp_names[0], stats)], filter_regex=fr
            )
            path = os.path.join(out_dir, f"{name}.txt")
            open(path, "w").write(txt + "\n")
            artifacts.append(path)
            report.append("```\n" + txt + "\n```\n")
        elif cls == "results_table":
            metrics = spec.get(
                "metrics", ["cost", "num_it_total", "solver_total_time"]
            )
            txt = tables_mod.metric_results_table(
                exps, exp_names, metrics, filter_regex=fr
            )
            tex = tables_mod.metric_results_table(
                exps, exp_names, metrics, filter_regex=fr, latex=True
            )
            path = os.path.join(out_dir, f"{name}.txt")
            open(path, "w").write(txt + "\n")
            open(os.path.join(out_dir, f"{name}.tex"), "w").write(tex)
            artifacts += [path, os.path.join(out_dir, f"{name}.tex")]
            report.append("```\n" + txt + "\n```\n")
        elif cls == "summarize_sequences_table":
            metrics = spec.get(
                "metrics", ["cost", "num_it_total", "solver_total_time"]
            )
            txt = tables_mod.summarize_table(
                exps, exp_names, metrics, filter_regex=fr
            )
            tex = tables_mod.summarize_table(
                exps, exp_names, metrics, filter_regex=fr, latex=True
            )
            path = os.path.join(out_dir, f"{name}.txt")
            open(path, "w").write(txt + "\n")
            open(os.path.join(out_dir, f"{name}.tex"), "w").write(tex)
            artifacts += [path, os.path.join(out_dir, f"{name}.tex")]
            report.append("```\n" + txt + "\n```\n")
        elif cls == "performance_profile":
            tol = spec.get("tolerance", 0.01)
            runs = _runs_by_problem(exps, exp_names, fr)
            problems = sorted(runs)
            times = {
                n: [
                    tables_mod.time_to_cost_tolerance(runs[p][n], tol)
                    if n in runs[p] else None
                    for p in problems
                ]
                for n in exp_names
            }
            taus, profiles = tables_mod.performance_profile(times)
            path = os.path.join(out_dir, f"{name}.png")
            plots_mod.profile_figure(
                taus, profiles, path,
                title=f"time to cost tol {tol:g}",
            )
            artifacts.append(path)
            report.append(f"![{name}]({name}.png)\n")
        elif cls == "plot":
            runs = _runs_by_problem(exps, exp_names, fr)
            path = os.path.join(out_dir, f"{name}.png")
            plots_mod.convergence_grid(
                runs, path,
                x=spec.get("x", "time"),
                section=spec.get("section", "iterations"),
                tolerances=spec.get("tolerances", [0.01]),
                title=spec.get("title", name),
            )
            artifacts.append(path)
            report.append(f"![{name}]({name}.png)\n")
        elif cls == "timing_breakdown":
            runs = _runs_by_problem(exps, exp_names, fr)
            for prob in sorted(runs):
                path = os.path.join(out_dir, f"{name}-{prob}.png")
                plots_mod.timing_breakdown_figure(
                    runs[prob], path, title=prob
                )
                artifacts.append(path)
                report.append(f"![{name}-{prob}]({name}-{prob}.png)\n")
        else:
            print(f"warning: unknown results class {cls!r}",
                  file=sys.stderr)
    md = os.path.join(out_dir, "report.md")
    open(md, "w").write("".join(report))
    artifacts.append(md)
    return artifacts


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="render tables/profiles/plots from run directories"
    )
    p.add_argument("config", help="experiments TOML")
    p.add_argument("-o", "--output-path", default=None)
    p.add_argument("--base-path", default=None)
    p.add_argument("--filter-regex", default=None)
    args = p.parse_args(argv)
    config = load_experiments_config(
        args.config,
        overrides={
            "output_path": args.output_path,
            "base_path": args.base_path,
            "filter_regex": args.filter_regex,
        },
    )
    exps = load_experiments(config)
    out_dir = config["options"]["output_path"]
    artifacts = render_results(config, exps, out_dir)
    for a in artifacts:
        print(a)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Quick convergence plots from ba_log.json files.

Equivalent of python/rootba/plot_logs.py: matplotlib cost-vs-time and
cost-vs-iteration curves for one or more runs.

Usage: python -m povar_tpu_torch.tools.plot_logs ba_log.json [more.json ...]

A copy of povar_tpu/tools/plot_logs.py with its imports rewritten to this
package, which never imports jax or povar_tpu.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

from povar_tpu_torch.tools.log import Log


def plot_logs(
    paths: List[str],
    out_path: Optional[str] = None,
    section: str = "iterations",
):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax_t, ax_i) = plt.subplots(1, 2, figsize=(11, 4))
    for path in paths:
        log = Log.load(path)
        label = os.path.basename(os.path.dirname(path) or path)
        t, c = log.cost_curve(section)
        ax_t.semilogy(t, c, marker=".", label=label)
        ax_i.semilogy(range(len(c)), c, marker=".", label=label)
    ax_t.set_xlabel("time [s]")
    ax_t.set_ylabel("cost")
    ax_i.set_xlabel("iteration")
    for ax in (ax_t, ax_i):
        ax.grid(True, alpha=0.3)
        ax.legend(fontsize=7)
    fig.tight_layout()
    out = out_path or "ba_log_plot.png"
    fig.savefig(out, dpi=130)
    return out


if __name__ == "__main__":
    out = plot_logs(sys.argv[1:])
    print(f"wrote {out}")

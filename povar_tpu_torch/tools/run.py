"""Run/experiment model: load result directories from batch runs.

Equivalent of python/rootba/run.py (Run: per-run-dir config/status/
output/log with failure detection) and the caching Experiment loader of
python/rootba/experiments.py (content-hash keyed cache), adapted to
this framework's artifacts (rootba_config.toml / config.json,
status.log, output.log, ba_log.json).

A copy of povar_tpu/tools/run.py with its imports rewritten to this
package, which never imports jax or povar_tpu.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import pickle
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from povar_tpu_torch.tools.log import Log


@dataclass
class Run:
    """One solver run directory."""

    dirpath: str
    name: str = ""
    config: Optional[dict] = None
    log: Optional[Log] = None
    status: str = ""
    output: str = ""

    @property
    def is_failed(self) -> bool:
        """Failure detection: batch runs write 'Completed' to status.log
        on success (the reference's scripts/run-all-in.sh protocol)."""
        return "Completed" not in self.status

    @staticmethod
    def load(dirpath: str) -> "Run":
        run = Run(dirpath=dirpath, name=os.path.basename(dirpath.rstrip("/")))
        status_path = os.path.join(dirpath, "status.log")
        if os.path.exists(status_path):
            run.status = open(status_path).read()
        out_path = os.path.join(dirpath, "output.log")
        if os.path.exists(out_path):
            run.output = open(out_path).read()
        cfg_json = os.path.join(dirpath, "config.json")
        if os.path.exists(cfg_json):
            run.config = json.load(open(cfg_json))
        log_path = os.path.join(dirpath, "ba_log.json")
        if os.path.exists(log_path):
            try:
                run.log = Log.load(log_path)
            except Exception:
                run.log = None
        return run


@dataclass
class Experiment:
    """A named collection of runs (one per problem/config)."""

    name: str
    runs: Dict[str, Run] = field(default_factory=dict)
    display_name: str = ""

    def sequences(self, filter_regex: Optional[str] = None) -> List[str]:
        """Run (problem) names, optionally regex-filtered
        (experiments.py Experiment.sequences)."""
        import re

        names = sorted(self.runs)
        if filter_regex:
            pat = re.compile(filter_regex)
            names = [n for n in names if pat.search(n)]
        return names

    @staticmethod
    def load(
        name: str,
        pattern: str,
        cache_dir: Optional[str] = None,
    ) -> "Experiment":
        """Load all run dirs matching a glob; optional pickle cache keyed
        by the content hash of the status files (so re-running a batch
        invalidates the cache, like the reference's experiments.py)."""
        dirs = sorted(d for d in glob.glob(pattern) if os.path.isdir(d))
        key = None
        if cache_dir:
            h = hashlib.sha256(name.encode())
            for d in dirs:
                sp = os.path.join(d, "status.log")
                h.update(d.encode())
                if os.path.exists(sp):
                    h.update(open(sp, "rb").read())
            key = os.path.join(cache_dir, f"exp-{h.hexdigest()[:16]}.pkl")
            if os.path.exists(key):
                with open(key, "rb") as f:
                    return pickle.load(f)
        exp = Experiment(name=name)
        for d in dirs:
            run = Run.load(d)
            exp.runs[run.name] = run
        if key:
            os.makedirs(cache_dir, exist_ok=True)
            with open(key, "wb") as f:
                pickle.dump(exp, f)
        return exp

    @property
    def failed_runs(self) -> List[str]:
        return [n for n, r in self.runs.items() if r.is_failed]

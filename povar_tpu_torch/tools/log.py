"""Log model: load ba_log.json files into numpy-friendly objects.

Equivalent of python/rootba/log.py (Log munch wrapper with __index /
__values run-length decoding): loads both this framework's logs and the
reference's ba_log.json/ubjson files, exposing per-iteration arrays.

A copy of povar_tpu/tools/log.py with its imports rewritten to this
package, which never imports jax or povar_tpu.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np


class AttrDict(dict):
    """Attribute-style access like the reference's munch objects."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return AttrDict(v) if isinstance(v, dict) else v


def _convert(data: Any) -> Any:
    """Decode the reference's `<name>__index` / `<name>__values` pairs
    (python/rootba/log.py:56-63 semantics): `__values` holds the
    flattened concatenation of per-entry arrays and `__index` their
    START offsets, so the field decodes by splitting the value array at
    the start indices — np.split(values, idx[1:]) — stacking into a 2-D
    array when all rows have equal length. Applied recursively through
    mappings and lists at load time."""
    if isinstance(data, dict):
        out: Dict[str, Any] = {}
        for k, v in data.items():
            if k.endswith("__values"):
                continue  # handled with its __index twin
            if k.endswith("__index"):
                values = np.asarray(data[k[: -len("__index")] + "__values"])
                idx = list(v)
                res = np.split(values, idx[1:])
                if all(len(res[0]) == len(x) for x in res):
                    res = np.array(res)
                out[k[: -len("__index")]] = res
            else:
                out[k] = _convert(v)
        return out
    if isinstance(data, list):
        return [_convert(x) for x in data]
    return data


class Log:
    """A loaded ba_log.json with convenient iteration arrays."""

    def __init__(self, data: Dict[str, Any]):
        self.data = AttrDict(data)

    @staticmethod
    def load(path: str) -> "Log":
        if path.endswith(".ubjson"):
            from povar_tpu_torch.utils import ubjson

            with open(path, "rb") as f:
                return Log(_convert(ubjson.loads(f.read())))
        with open(path) as f:
            return Log(_convert(json.load(f)))

    @property
    def problem_info(self) -> AttrDict:
        return AttrDict(self.data.get("problem_info", {}))

    def _iterations(self, section: str) -> List[Dict[str, Any]]:
        return self.data.get(section, [])

    def iteration_array(
        self, field: str, section: str = "iterations"
    ) -> np.ndarray:
        its = self._iterations(section)
        return np.array([it.get(field, 0.0) for it in its])

    def cost_curve(self, section: str = "iterations"):
        """(cumulative_time, cost) over successful iterations (the
        convergence curve used by the reference's plots)."""
        its = self._iterations(section)
        t = [
            it["cumulative_time"]
            for it in its
            if it.get("step_is_successful")
        ]
        c = [it["cost"] for it in its if it.get("step_is_successful")]
        return np.asarray(t), np.asarray(c)

    def final_cost(self, section: str = "iterations") -> Optional[float]:
        its = self._iterations(section)
        for it in reversed(its):
            if it.get("step_is_successful"):
                return float(it["cost"])
        return None

    def total_time(self, section_solver: str = "solver") -> float:
        s = self.data.get(section_solver, {})
        return float(s.get("total_time_in_seconds", 0.0))

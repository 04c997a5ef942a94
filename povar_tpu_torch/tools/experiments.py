"""Experiments config: load a TOML spec describing runs + report layout.

Equivalent capability to python/rootba/experiments.py:292-623 (the
config model behind generate_tables.py): an experiments file names
solver runs on disk, and a `results` list describes which tables,
profiles, and plots to render. Repetitive specs are compressed with

  - substitutions: named values; `${name}` interpolates into strings,
    a bare "<name>" string is replaced by the value itself (so lists /
    tables can be substituted wholesale);
  - templates: named prototype tables with `args` lists; a spec entry
    `template = "name"` expands into one entry per element of each
    list-valued arg (cartesian product), splicing the expansion into
    the surrounding list.

This is an independent re-implementation: same capability surface,
different mechanics (plain dicts, no munch; expansion is a single
recursive pass).

A copy of povar_tpu/tools/experiments.py with its imports rewritten to this
package, which never imports jax or povar_tpu.
"""

from __future__ import annotations

import itertools
import os
import re
from typing import Any, Dict, List, Optional

_VAR = re.compile(r"\$\{(\w+)\}")


def _substitute(obj: Any, subs: Dict[str, Any]) -> Any:
    """Recursively apply `${name}` / "<name>" substitutions."""
    if isinstance(obj, dict):
        return {k: _substitute(v, subs) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_substitute(v, subs) for v in obj]
    if isinstance(obj, str):
        if len(obj) > 2 and obj[0] == "<" and obj[-1] == ">":
            name = obj[1:-1]
            if name in subs:
                return _substitute(subs[name], subs)
            return obj
        out, n = _VAR.subn(lambda m: str(subs[m.group(1)]), obj)
        return _substitute(out, subs) if n else out
    return obj


def _expand_templates(
    entries: List[dict], templates: Dict[str, dict], subs: Dict[str, Any]
) -> List[dict]:
    """Expand `template = "name"` entries; list-valued template args
    produce the cartesian product, spliced in place."""
    out: List[dict] = []
    for entry in entries:
        if not isinstance(entry, dict) or "template" not in entry:
            out.append(_substitute(entry, subs))
            continue
        tdef = templates[entry["template"]]
        arg_names = tdef.get("args", [])
        # each arg either given in the entry or defaulted in the def
        arg_values = []
        for a in arg_names:
            v = entry.get(a, tdef.get(a))
            if v is None:
                raise KeyError(
                    f"template {entry['template']!r} argument {a!r} "
                    "missing"
                )
            v = _substitute(v, subs)
            arg_values.append(v if isinstance(v, list) else [v])
        for combo in itertools.product(*arg_values):
            local = dict(subs)
            local.update(dict(zip(arg_names, combo)))
            new = {
                k: _substitute(v, local)
                for k, v in tdef.items()
                if k not in ("args", "name") and k not in arg_names
            }
            # entry keys (other than template/args) override the
            # template body
            for k, v in entry.items():
                if k != "template" and k not in arg_names:
                    new[k] = _substitute(v, local)
            out.append(new)
    return out


def load_experiments_config(
    path: str, overrides: Optional[dict] = None
) -> dict:
    """Load + expand an experiments TOML. Returns a dict with keys
    options / experiments / results (all expanded)."""
    try:
        import tomllib

        with open(path, "rb") as f:
            config = tomllib.load(f)
    except ImportError:  # pragma: no cover - py<3.11
        import toml

        config = toml.load(path)

    config.setdefault("options", {})
    opts = config["options"]
    opts.setdefault("base_path", os.path.dirname(os.path.abspath(path)))
    opts.setdefault("cache_dir", None)
    opts.setdefault("output_path", "results")
    opts.setdefault("filter_regex", None)
    config.setdefault("substitutions", {})
    config.setdefault("templates", [])
    config.setdefault("experiments", [])
    config.setdefault("results", [])

    for k, v in (overrides or {}).items():
        if v is not None:
            opts[k] = v

    subs = dict(config["substitutions"])
    templates = {t["name"]: t for t in config["templates"]}
    config["experiments"] = _expand_templates(
        config["experiments"], templates, subs
    )
    config["results"] = _expand_templates(
        config["results"], templates, subs
    )
    for spec in config["experiments"]:
        spec.setdefault("display_name", spec.get("name", "?"))
        spec.setdefault("pattern", [])
        if isinstance(spec["pattern"], str):
            spec["pattern"] = [spec["pattern"]]
    return config


def load_experiments(config: dict):
    """Instantiate tools.run.Experiment objects for every experiment
    spec (glob patterns relative to options.base_path)."""
    from povar_tpu_torch.tools.run import Experiment

    base = config["options"]["base_path"]
    cache = config["options"].get("cache_dir")
    exps: Dict[str, Any] = {}
    for spec in config["experiments"]:
        name = spec["name"]
        merged = None
        for pat in spec["pattern"]:
            e = Experiment.load(
                name, os.path.join(base, pat), cache_dir=cache
            )
            if merged is None:
                merged = e
            else:
                merged.runs.update(e.runs)
        merged = merged or Experiment(name=name)
        merged.display_name = spec.get("display_name", name)
        exps[name] = merged
    return exps

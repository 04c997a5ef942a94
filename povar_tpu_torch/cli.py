"""Command-line app mirroring `bin/bal` (src/app/bal.cpp:44-103), on
the card: the counterpart of povar_tpu/cli.py with the same flags.

Pipeline: parse (TOML config + CLI overrides, cli/bal_cli_utils.cpp:51-130)
-> load + normalize problem -> two-step bundle adjustment on `--device`
-> postprocess (save optimized state) -> save ba_log.json (the JAX
package's schema).

Every option field is exposed as a generated kebab-case flag
(--solver-<field>, --dataset-<field>, with --no- boolean forms), like
the reference's options-visitor CLI generation (cli/cli_options.cpp:43-147).
The solve runs on the card (`--device cuda`, the default) and exits 1
without one; `--device cpu` runs the kernels' plain versions on the CPU.
`--mesh-devices N` (N >= 1) runs the SPMD window layout over N ranks
(parallel/spmd.py): N = 1 in this process, N > 1 in N spawned processes
(NCCL on N cards, gloo with `--device cpu`); only rank 0 logs and writes
ba_log.json. On the card an N above the card count exits 1.

Usage:
  python -m povar_tpu_torch.cli --input data_custom/problem-49-7776-pre.txt
  python -m povar_tpu_torch.cli --input problem.txt --create-dataset
  python -m povar_tpu_torch.cli --config rootba_config.toml --dump-config
  python -m povar_tpu_torch.cli --input problem.txt --device cpu \
      --mesh-devices 2
"""

from __future__ import annotations

import argparse
import dataclasses
import enum
import os
import sys
from typing import Any

from povar_tpu_torch.options import (
    BalAppOptions,
    load_toml,
    option_meta,
    options_to_toml,
    validate_options,
)
from povar_tpu_torch.problem.bal_io import load_normalized_bal_problem
from povar_tpu_torch.problem.problem import DatasetSummary
from povar_tpu_torch.utils import ba_log
from povar_tpu_torch.utils.profiling import device_memory_stats, trace
from povar_tpu_torch.utils.timer import Timer


def _add_dataclass_args(
    parser: argparse.ArgumentParser, obj: Any, prefix: str
) -> None:
    """Generate --<prefix>-<kebab-field> flags from a dataclass, like
    the reference's CliArgumentsOptionsVisitor, with help text and
    range annotations from the options metadata
    (cli/cli_options.cpp:43-147)."""
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            _add_dataclass_args(parser, v, prefix)
            continue
        flag = f"--{prefix}-{f.name.replace('_', '-')}"
        rng, help_text = option_meta(type(obj), f.name)
        help_text = help_text or ""
        if rng is not None:
            help_text += f" (range [{rng[0]:g}, {rng[1]:g}])"
        help_text += f" (default: {v.value if isinstance(v, enum.Enum) else v})"
        if isinstance(v, bool):
            parser.add_argument(
                flag, dest=f"{prefix}__{f.name}", default=None,
                action="store_true", help=help_text,
            )
            parser.add_argument(
                f"--no-{prefix}-{f.name.replace('_', '-')}",
                dest=f"{prefix}__{f.name}", action="store_false",
                help=argparse.SUPPRESS,
            )
        elif isinstance(v, enum.Enum):
            parser.add_argument(
                flag, dest=f"{prefix}__{f.name}", default=None,
                type=str, help=help_text,
            )
        elif isinstance(v, int):
            parser.add_argument(
                flag, dest=f"{prefix}__{f.name}", default=None,
                type=int, help=help_text,
            )
        elif isinstance(v, float):
            parser.add_argument(
                flag, dest=f"{prefix}__{f.name}", default=None,
                type=float, help=help_text,
            )
        else:
            parser.add_argument(
                flag, dest=f"{prefix}__{f.name}", default=None,
                type=str, help=help_text,
            )


def _apply_overrides(obj: Any, ns: argparse.Namespace, prefix: str) -> None:
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            _apply_overrides(v, ns, prefix)
            continue
        val = getattr(ns, f"{prefix}__{f.name}", None)
        if val is None:
            continue
        if isinstance(v, enum.Enum):
            setattr(obj, f.name, type(v)(str(val).upper()))
        else:
            setattr(obj, f.name, type(v)(val))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="povar-bal-torch",
        description="initialization-free stratified projective bundle "
        "adjustment on BAL problems, on an NVIDIA GPU (PyTorch / CUDA)",
    )
    parser.add_argument("--config", default=None,
                        help="rootba_config.toml-style config file")
    parser.add_argument("--input", default=None, help="input BAL problem")
    parser.add_argument("--create-dataset", action="store_true",
                        help="randomize cameras and write data_custom/")
    parser.add_argument("--dump-config", action="store_true",
                        help="print effective config and exit")
    parser.add_argument("--log-file", default="ba_log.json")
    parser.add_argument("--log-ubjson", action="store_true",
                        help="also write the log as UBJSON next to the "
                        "JSON file (ba_log SaveLogFlags analogue)")
    parser.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler Chrome trace of the "
                        "solve into this directory (trace.json)")
    parser.add_argument("--mesh-devices", default=0, type=int,
                        help="ranks of the SPMD window layout to shard the "
                        "solve over, one device each (0: the single-device "
                        "solve; with --device cpu, N gloo processes)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the solve runs: the card (default; "
                        "exits 1 without one) or the CPU")
    defaults = BalAppOptions()
    _add_dataclass_args(parser, defaults.solver, "solver")
    _add_dataclass_args(parser, defaults.dataset, "dataset")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    # config layering: defaults <- toml <- CLI flags
    if args.config and os.path.exists(args.config):
        opts = load_toml(args.config)
    elif os.path.exists("rootba_config.toml") and args.config is None:
        opts = load_toml("rootba_config.toml")
    else:
        opts = BalAppOptions()
    _apply_overrides(opts.solver, args, "solver")
    _apply_overrides(opts.dataset, args, "dataset")

    violations = validate_options(opts.solver) + validate_options(
        opts.dataset
    )
    if violations:
        for msg in violations:
            print(f"error: option {msg}", file=sys.stderr)
        return 1
    if args.input:
        opts.dataset.input = args.input
    if args.create_dataset:
        opts.dataset.create_dataset = True

    if args.dump_config:
        # reloadable TOML, like the reference's effective-config print
        # (bal_cli_utils.cpp:118-126): dump -> rerun round-trips
        print(options_to_toml(opts), end="")
        return 0

    if not opts.dataset.input:
        print("error: no --input problem given", file=sys.stderr)
        return 1

    timer_total = Timer()
    timing: dict = {}
    dataset_summary = DatasetSummary()
    try:
        problem = load_normalized_bal_problem(
            opts.dataset, dataset_summary, timing
        )
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print(
            "error: --device cuda but torch finds no CUDA device (pass "
            "--device cpu to solve on the CPU)",
            file=sys.stderr,
        )
        return 1
    if args.device == "cuda" and args.mesh_devices > torch.cuda.device_count():
        print(
            f"error: --mesh-devices {args.mesh_devices} but only "
            f"{torch.cuda.device_count()} devices available",
            file=sys.stderr,
        )
        return 1

    solve = (args, opts, problem, dataset_summary, timing, timer_total)
    if args.mesh_devices > 1:
        from povar_tpu_torch.parallel.mesh import spawn

        spawn(_solve, args.mesh_devices, args.device, solve)
    else:
        mesh = None
        if args.mesh_devices == 1:
            from povar_tpu_torch.parallel.mesh import make_mesh

            mesh = make_mesh(1, args.device)
        _solve(mesh, *solve)
    print(f"Saved log to {args.log_file}")
    return 0


def _solve(mesh, args, opts, problem, dataset_summary, timing,
           timer_total) -> None:
    """Solve on `args.device`, or as this rank of `mesh`, and on rank 0
    save the optimized state and ba_log.json."""
    from povar_tpu_torch.solver.pipeline import bundle_adjust

    t_opt = Timer()
    with trace(args.profile_dir if mesh is None or mesh.rank == 0 else None):
        problem, s1, s2 = bundle_adjust(problem, opts.solver,
                                        device=args.device, mesh=mesh)
    timing["optimize_time"] = t_opt.elapsed()
    if mesh is not None and mesh.rank != 0:
        return

    t_post = Timer()
    if opts.dataset.save_output:
        problem.save_npz(opts.dataset.output_optimized_path)
    timing["postprocess_time"] = t_post.elapsed()
    timing["total"] = timer_total.elapsed()

    ba_log.save_json(
        args.log_file, dataset_summary, s1, s2, timing,
        save_ubjson=args.log_ubjson,
        device_memory=device_memory_stats(),
    )


if __name__ == "__main__":
    sys.exit(main())

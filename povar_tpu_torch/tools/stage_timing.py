"""Per-stage spans of the LM iteration under `detailed_timing`, and the
BAL loader's tokenizers, timed.

    python -m povar_tpu_torch.tools.stage_timing breakdown [SCALE ...]
    python -m povar_tpu_torch.tools.stage_timing bal-load [SCALE ...]
    python -m povar_tpu_torch.tools.stage_timing launches [--reps N]

`breakdown` (card only) runs `bundle_adjust` with SolverOptions()
defaults and `detailed_timing=True` at each scale (default venice-89;
the scales of tools/large_scale.py) after a warm-up call, and prints
each step's per-span median in ms over the records that fill the span,
the staged run's wall time per iteration beside the host loop's
(`device_lm_loop="off"`) and the device loop's (the defaults), and the
card's name and power limit. `bal-load` writes the scale's problem as
BAL text (`write_bal_text`, into a temporary directory) and times one
load of it through the numpy tokenizer (problem/bal_io.numpy_tokens)
and through the native one (utils/native.py, its build apart), checks
that both give the same f64 bits, and prints the seconds (default
venice-1778, 4,969,615 observations). `launches` (card only) prints, as
one JSON line, the kernel launches of each of `--reps` warm bench
iterations (linearize + trial under tools/large_scale.py's
bench_options, venice-89) of both steps for seven configurations, of
the package it imports: run as `(cd DIR && PYTHONPATH=. python
<repo>/povar_tpu_torch/tools/stage_timing.py launches)` it counts an
earlier tree's (DIR: `git archive <commit> povar_tpu_torch` unpacked),
so that a change's launches are held to its parent's. chip_smoke.py's
`detailed_timing` phase uses the span tables and checks below.

The spans each solver fills are those of the JAX package's staged
solvers (povar_tpu/solver/stage1.py:954-1140, stage2.py:298-395, and
lm.py's residual evaluation): the linearization's on the first trial
after one, the solve's and the apply's on every trial whose increment
is finite.
"""

from __future__ import annotations

import argparse
import copy
import os
import statistics
import sys
import tempfile
import time

LIN = {1: {"jacobian_evaluation", "scale_landmark_jacobian",
           "scale_pose_jacobian"},
       2: {"jacobian_evaluation", "scale_landmark_jacobian",
           "scale_pose_jacobian", "perform_qr"}}
SOLVE = {
    "POWER_VARPROJ": {"stage2", "prepare", "solve_reduced_system"},
    "POWER_SCHUR_COMPLEMENT": {"stage2", "landmark_damping", "prepare",
                               "solve_reduced_system"},
    "PCG": {"stage2", "prepare", "compute_preconditioner",
            "solve_reduced_system"},
    "CHOLESKY": {"stage2", "solve_reduced_system"},
    "RIPOBA": {"stage2", "landmark_damping", "prepare",
               "solve_reduced_system"},
    "RIPCG": {"stage2", "landmark_damping", "prepare",
              "compute_preconditioner", "solve_reduced_system"},
}
APPLY = {"update_cameras", "back_substitution", "residual_evaluation"}
# every span, in the order of an iteration
SPANS = ("jacobian_evaluation", "scale_landmark_jacobian",
         "scale_pose_jacobian", "perform_qr", "stage2", "landmark_damping",
         "prepare", "compute_preconditioner", "solve_reduced_system",
         "update_cameras", "back_substitution", "residual_evaluation")


def span_seconds(it, span: str) -> float:
    return getattr(it, f"{span}_time_in_seconds")


def spans_filled(it) -> set:
    """The spans > 0 of an IterationSummary."""
    return {k for k in SPANS if span_seconds(it, k) > 0}


def expected_spans(step: int, solver: str, valid, successful) -> list:
    """Per record of a staged step (its records' step_is_valid and
    step_is_successful flags): the set of spans JAX fills in a record
    whose step is valid, None for iteration 0 and for the others: the
    linearization's on record 1 and after every accepted step, the
    solve's and the apply's."""
    out = [None]
    for i in range(1, len(valid)):
        if not valid[i]:
            out.append(None)
            continue
        want = SOLVE[solver] | APPLY
        if i == 1 or successful[i - 1]:
            want = want | LIN[step]
        out.append(want)
    return out


def check_spans(step: int, solver: str, summary) -> int:
    """Each record with a valid step fills exactly the spans JAX fills,
    each > 0, and its spans (landmark_damping, the same span as stage2,
    counted once) sum to at most its iteration_time. Returns the number
    of records checked (at least one); raises AssertionError."""
    its = summary.iterations
    want = expected_spans(step, solver, [it.step_is_valid for it in its],
                          [it.step_is_successful for it in its])
    checked = 0
    for it, w in zip(its, want):
        if w is None:
            continue
        got = spans_filled(it)
        if got != w:
            raise AssertionError(
                f"step {step} ({solver}) record {it.iteration}: spans > 0 "
                f"{sorted(got)}, expected {sorted(w)}")
        total = sum(span_seconds(it, k) for k in SPANS
                    if k != "landmark_damping")
        if not total <= it.iteration_time_in_seconds:
            raise AssertionError(
                f"step {step} record {it.iteration}: spans sum to {total} s "
                f"> iteration_time {it.iteration_time_in_seconds} s")
        checked += 1
    if not checked:
        raise AssertionError(f"step {step}: no record with a valid step")
    return checked


def span_medians_ms(summary) -> dict:
    """{span: median ms over the records that fill it}, in SPANS order,
    and "iteration" (the median iteration_time of records 1 on)."""
    out = {}
    for k in SPANS:
        vals = [span_seconds(it, k) for it in summary.iterations[1:]
                if span_seconds(it, k) > 0]
        if vals:
            out[k] = statistics.median(vals) * 1e3
    out["iteration"] = statistics.median(
        it.iteration_time_in_seconds for it in summary.iterations[1:]) * 1e3
    return out


def wall_ms_per_iteration(summary) -> float:
    """A step's wall ms per record past iteration 0: from the end of
    record 0 to the end of the last (the device loop's records share its
    wall time evenly)."""
    its = summary.iterations
    return ((its[-1].cumulative_time_in_seconds
             - its[0].cumulative_time_in_seconds)
            / max(1, len(its) - 1) * 1e3)


def format_medians(label: str, med: dict) -> str:
    return f"{label}: " + ", ".join(f"{k} {v:.3f}" for k, v in med.items())


def make_problem(scale: str):
    """venice-89 (bench.py's problem, chip_smoke.py's), or a scale of
    tools/large_scale.py."""
    from povar_tpu_torch.problem.synthetic import synthetic_bal_problem_fast
    from povar_tpu_torch.tools import large_scale

    if scale == "venice-89":
        return synthetic_bal_problem_fast(89, 110_973, 5, seed=0)
    return large_scale.make_problem(scale)


def _card() -> str:
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def breakdown(scale: str) -> dict:
    """The staged `bundle_adjust` with defaults at `scale` (warm: a first
    call apart), its spans checked (check_spans) and their medians, and
    the staged, host-loop and device-loop wall ms per iteration of each
    step. Returns {"step1": medians, "step2": medians, "wall": {...}}."""
    from povar_tpu_torch import SolverOptions, bundle_adjust

    problem = make_problem(scale)
    runs = {"staged": SolverOptions(detailed_timing=True),
            "host loop": SolverOptions(device_lm_loop="off"),
            "device loop": SolverOptions()}
    out = {"wall": {}}
    for label, opts in runs.items():
        for _ in range(2):  # the first call builds and captures
            _, s1, s2 = bundle_adjust(copy.deepcopy(problem), opts,
                                      log=lambda s: None)
        out["wall"][label] = (wall_ms_per_iteration(s1),
                              wall_ms_per_iteration(s2))
        if label == "staged":
            check_spans(1, "POWER_VARPROJ", s1)
            check_spans(2, "RIPOBA", s2)
            out["step1"], out["step2"] = (span_medians_ms(s1),
                                          span_medians_ms(s2))
            out["records"] = (len(s1.iterations), len(s2.iterations))
    return out


def bal_load(p, name: str) -> dict:
    """Seconds to write problem `p` as BAL text and to tokenize it with
    numpy and natively (one load each, warm page cache; the native build
    apart), the token count and the file's bytes; raises unless both
    tokenizers give the same f64 bits."""
    import numpy as np

    from povar_tpu_torch.problem.bal_io import numpy_tokens
    from povar_tpu_torch.problem.synthetic import write_bal_text
    from povar_tpu_torch.utils import native

    native.library()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, f"{name}.txt")
        t0 = time.perf_counter()
        write_bal_text(path, p.num_cameras, p.num_landmarks, p.obs_cam,
                       p.obs_lm, p.obs_uv, lm_p=p.lm_p)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        fast = native.parse_tokens(path)
        t_native = time.perf_counter() - t0
        t0 = time.perf_counter()
        plain = numpy_tokens(path)
        t_numpy = time.perf_counter() - t0
        size = os.path.getsize(path)
    if not (fast.shape == plain.shape
            and np.array_equal(fast.view(np.int64), plain.view(np.int64))):
        raise AssertionError(f"{name}: native tokens != numpy tokens")
    return dict(observations=p.num_observations, tokens=int(fast.size),
                bytes=size, write_s=t_write, numpy_s=t_numpy,
                native_s=t_native)


def bench_launches(reps: int) -> dict:
    """{"<config> step <k>": [launch counts of each warm bench iteration
    after the first]} at venice-89 for SolverOptions() defaults, the
    composed term, "off", pure f64, PCG + RIPCG, PSC and CHOLESKY."""
    import torch

    from povar_tpu_torch import (
        SolverOptions, Stage1Solver, Stage2Solver, create_homogeneous)
    from povar_tpu_torch.ops import launches
    from povar_tpu_torch.options import SolverType, SolverTypeRiemannian
    from povar_tpu_torch.tools.large_scale import bench_options

    p = make_problem("venice-89")
    args = (p.obs_cam, p.obs_lm, p.obs_uv, p.num_cameras, p.num_landmarks)
    configs = {
        "defaults": SolverOptions(),
        "composed": SolverOptions(fused_power_term=False),
        "off": SolverOptions(pallas_kernels="off"),
        "f64": SolverOptions(mixed_precision_solves=False),
        "pcg": SolverOptions(solver_type_step_1=SolverType.PCG,
                             solver_type_step_2=SolverTypeRiemannian.RIPCG),
        "psc": SolverOptions(
            solver_type_step_1=SolverType.POWER_SCHUR_COMPLEMENT),
        "cholesky": SolverOptions(solver_type_step_1=SolverType.CHOLESKY),
    }
    out = {}
    for label, o in configs.items():
        c = torch.as_tensor(p.cam_space, device="cuda")
        s1 = Stage1Solver(*args, bench_options(o), device="cuda")
        lm = s1.lm_pack(s1.initialize_varproj(c))
        c2, lm2 = create_homogeneous(
            c, Stage1Solver(*args, o, device="cuda").initialize_varproj(c))
        s2 = Stage2Solver(*args, bench_options(o), device="cuda")
        for step, s, cc, ll in ((1, s1, c, lm), (2, s2, c2, s2.lm_pack(lm2))):
            seen = []
            for _ in range(reps + 1):
                launches.reset_launch_counts()
                s.trial(cc, ll, s.linearize(cc, ll), 1e-4)
                torch.cuda.synchronize()
                seen.append({k: v for k, v in launches.launch_counts().items()
                             if v})
            out[f"{label} step {step}"] = seen[1:]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("breakdown", "bal-load", "launches"))
    ap.add_argument("scales", nargs="*")
    ap.add_argument("--reps", type=int, default=6)
    args = ap.parse_args(argv)
    if args.what == "launches":
        import json

        print(_card(), flush=True)
        print("LAUNCHES " + json.dumps(bench_launches(args.reps),
                                       sort_keys=True), flush=True)
        return 0
    if args.what == "breakdown":
        import torch

        if not torch.cuda.is_available():
            print("stage_timing breakdown: no CUDA device", file=sys.stderr)
            return 1
        print(_card(), flush=True)
        for scale in args.scales or ["venice-89"]:
            r = breakdown(scale)
            print(f"{scale}: staged records {r['records']}", flush=True)
            for step in ("step1", "step2"):
                print(format_medians(f"{scale} {step} median ms", r[step]),
                      flush=True)
            for label, (w1, w2) in r["wall"].items():
                print(f"{scale} {label}: wall ms per iteration step 1 "
                      f"{w1:.3f}, step 2 {w2:.3f}", flush=True)
        return 0
    for scale in args.scales or ["venice-1778"]:
        r = bal_load(make_problem(scale), scale)
        print(f"{scale}: {r['observations']} observations, {r['tokens']} "
              f"tokens, {r['bytes'] / 1e6:.1f} MB; write {r['write_s']:.2f} "
              f"s; numpy {r['numpy_s']:.3f} s, native {r['native_s']:.3f} s "
              f"({r['numpy_s'] / r['native_s']:.1f}x); same bits",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

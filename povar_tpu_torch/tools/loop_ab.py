"""The device LM loop against the host loop on the card.

    python -m povar_tpu_torch.tools.loop_ab [SCALE ...] [--runs N]

SCALE: venice-89 (synthetic_bal_problem_fast(89, 110973, 5, seed=0), the
scale of bench.py and chip_smoke.py) or one of tools/large_scale.py's
(venice-1778, final-13682, ...). Default: venice-89 venice-1778.

For each scale, with SolverOptions() defaults (POWER_VARPROJ + RIPOBA,
eta = 1e-2) and each loop, "off" (the host loop, solver/lm.py) and
"auto" (the device loop, solver/device_loop.py), each step is run on one
stage solver twice: a first call (the device loop captures its CUDA
graph there) and a warm one (the device loop replays the graph), step 2
from the homogenized result of the host loop's step 1. Per call it
prints the wall seconds to a synchronisation, the trials, the wall and
device time per trial (the summed device activities of the profiler's
trace, warm call only), the device's busy share, the blocking host synchronisations
(those torch's sync debug mode flags, which are the implicit ones: a
copy to the host, `.item()`; plus the device loop's explicit
synchronisations of a capture, device_loop.CAPTURE_SYNCS) and the peak device memory; for the
device loop also the capture and instantiation seconds, the graph's
top-level nodes and its memory pool's bytes. Then `--runs` rounds of
`bundle_adjust` under "off" and "auto" in turns (off, auto, auto, off,
...): seconds and peak memory. Each scale ends with one JSON line.

Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import sys
import time
import warnings

import torch

from povar_tpu_torch import (
    SolverOptions,
    SolverSummary,
    Stage1Solver,
    Stage2Solver,
    Timer,
    bundle_adjust,
    create_homogeneous,
    optimize_step1,
    optimize_step2,
)
from povar_tpu_torch.problem.synthetic import synthetic_bal_problem_fast
from povar_tpu_torch.solver.device_loop import CAPTURE_SYNCS

VENICE89 = (89, 110973, 5)


def make_problem(scale: str):
    if scale == "venice-89":
        return synthetic_bal_problem_fast(*VENICE89, seed=0)
    from povar_tpu_torch.tools.large_scale import make_problem as large

    return large(scale)


@contextlib.contextmanager
def counted_syncs():
    """Count the blocking host synchronisations inside the block (torch's
    sync debug mode in "warn"): yields a list that gets the count."""
    out = []
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield out
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    out.append(sum("synchroniz" in str(w.message) for w in seen))


# the device activities of a profile's trace (kernels, copies, fills)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_activity(prof):
    """(summed device time in us, kernel names) of a profile, read from
    its exported trace, which keeps every activity record: the event
    list of `prof.events()` loses some of the kernels a CUDA graph
    launches (all of them share the launch's correlation id)."""
    import os
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    events = [e for e in trace.get("traceEvents", [])
              if e.get("cat") in DEVICE_CATS]
    return (sum(float(e.get("dur", 0.0)) for e in events),
            {e["name"] for e in events if e["cat"] == "kernel"})


def run_step(step: int, solver, state, options, profile: bool = False):
    """One optimize_step1 / optimize_step2 call on `solver` from `state`
    (cams, lms), counted and timed. Returns (summary, result, stats)."""
    from torch.profiler import ProfilerActivity, profile as profiler

    optimize = optimize_step1 if step == 1 else optimize_step2
    summary = SolverSummary()
    captures = sum(r.captures for r in solver.device_runs.values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ctx = (profiler(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
           if profile else contextlib.nullcontext())
    with ctx as prof, counted_syncs() as syncs:
        t0 = time.perf_counter()
        out = optimize(solver, *state, options, summary, Timer(),
                       log=lambda s: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    trials = len(summary.iterations) - 1
    stats = dict(wall_s=wall, trials=trials, syncs=syncs[0],
                 peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    if profile:
        dev, names = device_activity(prof)
        stats.update(device_us_per_trial=dev / max(trials, 1),
                     wall_us_per_trial=wall * 1e6 / max(trials, 1),
                     busy=dev * 1e-6 / wall, kernels=sorted(names))
    runs = solver.device_runs.values()
    stats["syncs"] += CAPTURE_SYNCS * (sum(r.captures for r in runs)
                                       - captures)
    for run in runs:
        stats.update(capture_s=run.capture_s, instantiate_s=run.instantiate_s,
                     nodes=run.nodes, pool_bytes=pool_bytes(run),
                     ran=sorted(run.ran_kernels()))
    return summary, out, stats


def pool_bytes(run):
    """Bytes the memory pool of a DeviceLmRun's graph holds (None where
    the installed torch cannot say)."""
    graph = getattr(run, "_graph", None)
    snap = getattr(getattr(graph, "pool", None), "snapshot", None)
    if snap is None:
        return None
    return sum(seg.get("total_size", 0) for seg in snap())


def _print(label, stats):
    keep = {k: v for k, v in stats.items() if k not in ("kernels", "ran")}
    print(f"{label}: " + ", ".join(
        f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
        for k, v in keep.items()), flush=True)


def compare_loops(problem, base: SolverOptions, label: str) -> dict:
    """Both steps under "off" and "auto", a first and a warm call each
    (module docstring). Returns {f"step{s} {mode} {call}": stats}."""
    args = (problem.obs_cam, problem.obs_lm, problem.obs_uv,
            problem.num_cameras, problem.num_landmarks)
    cams = torch.as_tensor(problem.cam_space, device="cuda")
    lms = torch.as_tensor(problem.lm_p, device="cuda")
    out, start2 = {}, None
    for step, cls in ((1, Stage1Solver), (2, Stage2Solver)):
        for mode in ("off", "auto"):
            opts = copy.deepcopy(base)
            opts.device_lm_loop = mode
            solver = cls(*args, opts, device="cuda")
            state = (cams, lms) if step == 1 else start2
            for call in ("first", "warm"):
                summary, res, stats = run_step(step, solver, state, opts,
                                               profile=call == "warm")
                seq = "".join("A" if it.step_is_successful else "R"
                              for it in summary.iterations[1:])
                stats["final_cost"] = summary.final_cost.all.error
                _print(f"{label} step {step} {mode} {call} ({seq})", stats)
                out[f"step{step} {mode} {call}"] = stats
            if step == 1 and mode == "off":
                start2 = create_homogeneous(*res)
    return out


def bundle_seconds(problem, base: SolverOptions, runs: int, label: str):
    """`runs` rounds of bundle_adjust under "off" and "auto" in turns.
    Returns {mode: [(seconds, peak GiB), ...]}."""
    out = {"off": [], "auto": []}
    order = [m for r in range(runs)
             for m in (("off", "auto") if r % 2 == 0 else ("auto", "off"))]
    for mode in order:
        opts = copy.deepcopy(base)
        opts.device_lm_loop = mode
        p = copy.deepcopy(problem)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, s1, s2 = bundle_adjust(p, opts, log=lambda s: None, device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        out[mode].append((secs, peak))
        print(f"{label} bundle_adjust {mode}: {secs:.3f} s, peak {peak:.2f} "
              f"GiB, records {len(s1.iterations)} + {len(s2.iterations)}, "
              f"final {s1.final_cost.all.error!r} "
              f"{s2.final_cost.all.error!r}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scales", nargs="*",
                    default=["venice-89", "venice-1778"])
    ap.add_argument("--runs", type=int, default=2)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("loop_ab: no CUDA device", file=sys.stderr)
        return 1
    import subprocess

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    for scale in a.scales:
        t0 = time.perf_counter()
        problem = make_problem(scale)
        print(f"{scale}: generated in {time.perf_counter() - t0:.1f} s",
              flush=True)
        res = compare_loops(problem, SolverOptions(), scale)
        for stats in res.values():
            stats.pop("kernels", None)
            stats.pop("ran", None)
        ba = bundle_seconds(problem, SolverOptions(), a.runs, scale)
        print(json.dumps({"scale": scale, "steps": res, "bundle_adjust": ba,
                          "device": torch.cuda.get_device_name(0)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

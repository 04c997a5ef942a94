"""Large-N runs of povar_tpu_torch on one card: the port's counterpart of
benchmarks/large_scale_smoke.py, which runs the JAX package.

    python -m povar_tpu_torch.tools.large_scale [SCALE ...] [--loops]
    python -m povar_tpu_torch.tools.large_scale spread [final-13682]
        [--runs 8]
    python -m povar_tpu_torch.tools.large_scale starts [--runs 8]

Scales (large_scale_smoke.py's SCALES: cameras, landmarks, observations
per landmark, camera locality):

  venice-1778              (1,778, 993,923, 5, 64), ~5.0M observations
  final-13682              (13,682, 4,585,579, 5, 64), ~22.9M observations
  venice-1778-uniform      locality 0: cameras uniform over [0, N)
  venice-1778-adversarial  synthetic_bal_problem_adversarial (heavy-tailed
  final-13682-adversarial  track lengths, mixed spans, 1% loop closures,
                           scrambled camera ids), mean 5 per landmark

`--loops` lays `add_loop_closures_and_scramble` (1% global-span loop
closures, camera ids scrambled; benchmarks/adversarial_plan.py's
structure) over each scale. Default: the five scales in that order.

For each scale, on the card with SolverOptions() defaults (POWER_VARPROJ
+ RIPOBA, the fused power terms): the generation's seconds (numpy, on
the host), the set-up's (both stage solvers, synchronised), the slot
rows and the parts of the fused-term plan, the warm step-1 and step-2
iterations (linearize + trial from the VarProj start and its homogenized
form, with bench.py's fixed work: m = 10 power terms, eta = 0; REPS
chained, one synchronisation: wall ms an iteration; the profiler's
summed device time of the same iterations: device us an iteration and
the device's busy share), one `bundle_adjust` (its seconds to a
synchronisation, the records of each step, initial and final costs)
and the peak device memory of the scale
(torch.cuda.max_memory_allocated). Each scale ends with one JSON line.

`spread` runs the venice-1778 step 1's first LARGE_N_ITERS iterations
`--runs` times on the card's kernels and as often on their plain
versions on the card, and prints the largest relative gap of an
accepted cost between any kernel run and any plain run, and whether
every run took the same decisions and power-term counts: chip_smoke.py's
LARGE_N_TOL is twice that gap. `spread final-13682` does the same for
final-13682's first step-1 iteration and one step-2 trial from one
start (first_steps; both stage solvers built once): chip_smoke.py's
FINAL_TOLS are twice its gaps, step by step.

`starts` runs final-13682's step 2 from the LM loop's own start `--runs`
times on shared stage solvers: the kernels' step 1 after START2_ITERS
iterations, homogenized, then FINAL_STEP2_ITERS step-2 iterations. It
prints each run's decisions, costs and first accepted trial
(chip_smoke.py's large_n (d) runs `bundle_adjust` with START2_ITERS +
FINAL_STEP2_ITERS iterations), and whether one step-2 trial at
STEP2_LAMBDA from that start has a finite increment.

Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time

import torch

from povar_tpu_torch import (
    SolverOptions,
    SolverSummary,
    Stage1Solver,
    Stage2Solver,
    Timer,
    bundle_adjust,
    create_homogeneous,
    from_numpy,
    optimize_step1,
    optimize_step2,
)
from povar_tpu_torch.problem.synthetic import (
    add_loop_closures_and_scramble,
    synthetic_bal_problem_adversarial,
    synthetic_bal_problem_fast,
)

# (cams, lms, obs per landmark, camera locality; -1: the adversarial
# generator), benchmarks/large_scale_smoke.py:37-46
SCALES = {
    "venice-1778": (1778, 993_923, 5, 64),
    "final-13682": (13_682, 4_585_579, 5, 64),
    "venice-1778-uniform": (1778, 993_923, 5, 0),
    "venice-1778-adversarial": (1778, 993_923, 5, -1),
    "final-13682-adversarial": (13_682, 4_585_579, 5, -1),
}
# the step-1 iterations the spread (and chip_smoke.py's large_n (c))
# compares: only the first is reproducible. From its second trial on the
# venice-1778 start is chaotic in f32 rounding on either side: of 8 runs
# of the first 5 iterations on the card's kernels one went AAAAA and
# seven AARRR, of 8 on their plain versions one ARARR, one AAAAA and six
# AARRR (a trial's cost 2158 or above 2183 from states 3e-6 apart;
# NVIDIA H100 80GB HBM3, 700 W)
LARGE_N_ITERS = 1
# first_steps' step 2: one trial at damping STEP2_LAMBDA (the CPU
# tests', tests/test_torch_large_n.py) from one fixed start, the
# homogenized VarProj initialization of the problem's cameras (the warm
# step-2 iteration's): the kernels' step 1 after START2_ITERS
# iterations moves run to run (step 2's start cost 9.9e10-2.6e12 in
# `starts`), and with it the trial's gap, or its increment turns NaN on
# the kernels and on the plain versions alike; `starts` counts those
STEP2_LAMBDA = 1e2
# step 1's iterations before step 2 in chip_smoke.py's final-13682
# `bundle_adjust` and in `starts`, and step 2's there: from the LM
# loop's own start, lambda 1e-4, the first trials give a NaN increment
# or a rising cost by f32 rounding alone (one chip_smoke.py run with 3
# step-2 iterations took no step; `starts`, 20 runs: the first accepted
# trial the 3rd in 18, the 4th in 2; NVIDIA H100 80GB HBM3, 700 W), and
# each reject raises lambda by the vee schedule, 2x, 4x, 8x, ..., so the
# seventh trial runs at 2.1e2, past STEP2_LAMBDA
START2_ITERS = 3
FINAL_STEP2_ITERS = 10
# chained iterations a timing
REPS = 10


def make_problem(scale: str, loops: bool = False, seed: int = 0):
    """The scale's problem from `seed` (large_scale_smoke.py's
    generators), with loop closures and scrambled cameras laid over it
    where `loops`."""
    n_cams, n_lms, obs_per_lm, locality = SCALES[scale]
    if locality < 0:
        problem = synthetic_bal_problem_adversarial(
            n_cams, n_lms, mean_obs_per_lm=obs_per_lm, seed=seed)
    else:
        problem = synthetic_bal_problem_fast(
            n_cams, n_lms, obs_per_lm, seed=seed, locality=locality)
    if loops:
        problem = add_loop_closures_and_scramble(problem, 0.01, seed=seed + 1)
    return problem


def bench_options(base: SolverOptions) -> SolverOptions:
    """`base` with bench.py's fixed work per iteration: m = 10 power
    terms, no early exit."""
    o = copy.deepcopy(base)
    o.power_sc_iterations = 10
    o.eta = 0.0
    o.r_tolerance = -1.0
    return o


def iteration_times(step, c, lm, reps: int = REPS):
    """(wall ms, device us, busy share) of one warm chained iteration:
    `reps` calls of `step` (c, lm) -> (c, lm, err) chained with one
    synchronisation, then the same under the profiler, whose device
    operations' summed durations give the device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cc, ll, err = step(c, lm)  # warm
    float(err)
    t0 = time.perf_counter()
    cc, ll = c, lm
    for _ in range(reps):
        cc, ll, err = step(cc, ll)
    float(err)
    wall = (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cc, ll = c, lm
        for _ in range(reps):
            cc, ll, err = step(cc, ll)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    dev = sum(e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA)
    return wall * 1e3, dev / reps, dev / (prof_wall * 1e6)


def run_scale(scale: str, loops: bool) -> dict:
    torch.cuda.reset_peak_memory_stats()
    name = scale + ("-loops" if loops else "")
    t0 = time.perf_counter()
    problem = make_problem(scale, loops)
    gen_s = time.perf_counter() - t0
    print(f"== {name}: N = {problem.num_cameras}, M = "
          f"{problem.num_landmarks}, {problem.num_observations} "
          f"observations; generated in {gen_s:.2f} s", flush=True)
    opts = SolverOptions()
    args = (problem.obs_cam, problem.obs_lm, problem.obs_uv,
            problem.num_cameras, problem.num_landmarks)
    t0 = time.perf_counter()
    s1 = Stage1Solver(*args, bench_options(opts), device="cuda")
    s2 = Stage2Solver(*args, bench_options(opts), device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    o_pad = int(s1.obs.cam.shape[0])
    plan = s1.e0_plan
    print(f"set-up {setup_s:.2f} s (both stage solvers): O = {o_pad} slot "
          f"rows, fused-term parts {None if plan is None else plan.parts}, "
          f"suffix {None if plan is None else plan.suffix}", flush=True)

    c = torch.as_tensor(problem.cam_space, device="cuda")
    lm0 = s1.initialize_varproj(c)

    def step1(c, lm):
        lin = s1.linearize(c, lm)
        nc, nl, _ok, _it, _ld, err = s1.trial(c, lm, lin, 1e-4)
        return nc, nl, err["error_all"]

    def step2(c, lm):
        lin = s2.linearize(c, lm)
        nc, nl, _ok, _it, _ld, err = s2.trial(c, lm, lin, 1e-4)
        return nc, nl, err["error_all"]

    it1 = iteration_times(step1, c, s1.lm_pack(lm0))
    c2, lm2 = create_homogeneous(c, lm0)
    it2 = iteration_times(step2, c2, s2.lm_pack(lm2))
    for label, (wall, dev, busy) in (("step-1", it1), ("step-2", it2)):
        print(f"warm {label} iteration (linearize + trial, eta=0, m=10, "
              f"{REPS} chained): wall {wall:.3f} ms, device {dev:.1f} us "
              f"(busy share {busy:.3f})", flush=True)
    del s1, s2, lm0, c2, lm2

    p = copy.deepcopy(problem)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _out, sum1, sum2 = bundle_adjust(p, opts, log=lambda s: None,
                                     device="cuda")
    torch.cuda.synchronize()
    ba_s = time.perf_counter() - t0
    costs = [(s.iterations[0].cost.all.error, s.final_cost.all.error)
             for s in (sum1, sum2)]
    peak = torch.cuda.max_memory_allocated()
    print(f"bundle_adjust {ba_s:.2f} s: "
          f"records {len(sum1.iterations)} + {len(sum2.iterations)}; step 1 "
          f"{costs[0][0]!r} -> {costs[0][1]!r}, step 2 {costs[1][0]!r} -> "
          f"{costs[1][1]!r}; peak device memory {peak / 2**30:.2f} GiB",
          flush=True)
    out = dict(scale=name, n_cams=problem.num_cameras,
               n_lms=problem.num_landmarks,
               n_obs=problem.num_observations, slot_rows=o_pad,
               generation_s=gen_s, setup_s=setup_s,
               step1_wall_ms=it1[0], step1_device_us=it1[1],
               step1_busy=it1[2], step2_wall_ms=it2[0],
               step2_device_us=it2[1], step2_busy=it2[2],
               bundle_adjust_s=ba_s,
               records=[len(sum1.iterations), len(sum2.iterations)],
               costs=costs, peak_bytes=peak)
    print(json.dumps(out), flush=True)
    return out


def first_iterations(problem, plain: bool, iters: int = LARGE_N_ITERS):
    """The SolverOptions() step 1's first `iters` iterations on the card
    (its kernels, or with `plain` their plain versions on the card).
    Returns (summary, seconds)."""
    import contextlib

    from povar_tpu_torch.tools.step2_spread import plain_step1

    opts = SolverOptions()
    opts.max_num_iterations_step_1 = iters
    _, cams, lms = from_numpy(problem.obs_cam, problem.obs_lm,
                              problem.obs_uv, problem.cam_space,
                              problem.lm_p, device="cuda")
    solver = Stage1Solver(problem.obs_cam, problem.obs_lm, problem.obs_uv,
                          problem.num_cameras, problem.num_landmarks, opts,
                          device="cuda")
    summary = SolverSummary()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with plain_step1() if plain else contextlib.nullcontext():
        optimize_step1(solver, cams, lms, opts, summary, Timer(),
                       lambda s: None)
    torch.cuda.synchronize()
    return summary, time.perf_counter() - t0


def first_steps(problem, s1, s2, plain: bool, start2=None):
    """On the stage solvers s1, s2 of `problem` (built once, any number
    of runs): step 1's first LARGE_N_ITERS iterations from the problem's
    state, then one step-2 trial at STEP2_LAMBDA from `start2` (cameras
    and homogeneous landmarks; None: the homogenized VarProj
    initialization of the problem's cameras), on the card's kernels or,
    with `plain`, all their plain versions on the card. Returns (step-1
    summary, the trial's {ok, terms, l_diff, cost}, step 2's start,
    seconds of the compared work)."""
    import contextlib

    from povar_tpu_torch.tools.step2_spread import plain_step1

    opts = copy.deepcopy(s1.opts)
    opts.max_num_iterations_step_1 = LARGE_N_ITERS
    cams = torch.as_tensor(problem.cam_space, device="cuda")
    lms = torch.as_tensor(problem.lm_p, device="cuda")
    if start2 is None:
        start2 = create_homogeneous(cams, s1.initialize_varproj(cams))
    summary = SolverSummary()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with (plain_step1(cams=True, step2=True) if plain
          else contextlib.nullcontext()):
        optimize_step1(s1, cams, lms, opts, summary, Timer(), lambda s: None)
        c2, l2 = start2[0], s2.lm_pack(start2[1])
        _c, _l, ok, terms, l_diff, err = s2.trial(c2, l2, s2.linearize(c2, l2),
                                                  STEP2_LAMBDA)
        trial = dict(ok=bool(ok), terms=int(terms), l_diff=float(l_diff),
                     cost=float(err["error_all"]))
    torch.cuda.synchronize()
    return summary, trial, start2, time.perf_counter() - t0


def decisions(summary):
    """(accepted, power terms) of each record after the first."""
    return [(it.step_is_successful, it.linear_solver_iterations)
            for it in summary.iterations[1:]]


def accepted_costs(summary):
    """The initial cost and every accepted one."""
    return [it.cost.all.error for k, it in enumerate(summary.iterations)
            if k == 0 or it.step_is_successful]


def recorded_costs(summary):
    """The initial cost and every trial's, accepted or rejected."""
    return [it.cost.all.error for it in summary.iterations
            if it.cost is not None]


def spread(runs: int, scale: str = "venice-1778") -> list:
    """The first-iterations spread of `scale` (the module docstring):
    venice-1778's step 1 (first_iterations; its accepted costs), or
    final-13682's step 1 (first_steps; every trial's cost) and its
    step-2 trial (l_diff and cost). Returns the largest
    kernel-against-plain gap of each step."""
    problem = make_problem(scale)
    steps = 1 if scale == "venice-1778" else 2
    # per step: (decisions, compared values) of a run's result
    views = [(decisions, accepted_costs if steps == 1 else recorded_costs),
             (lambda t: [(t["ok"], t["terms"])],
              lambda t: [t["l_diff"], t["cost"]])][:steps]
    if steps == 2:
        args = (problem.obs_cam, problem.obs_lm, problem.obs_uv,
                problem.num_cameras, problem.num_landmarks)
        s1 = Stage1Solver(*args, SolverOptions(), device="cuda")
        s2 = Stage2Solver(*args, SolverOptions(), device="cuda")
    sides = {False: [], True: []}
    start2 = None
    for r in range(runs):
        for plain in (False, True):
            torch.cuda.reset_peak_memory_stats()
            if steps == 1:
                s, secs = first_iterations(problem, plain)
                run = (s,)
            else:
                *run, start2, secs = first_steps(problem, s1, s2, plain,
                                                 start2)
            sides[plain].append(run)
            for step, (s, (dec, vals)) in enumerate(zip(run, views), 1):
                print(f"run {r} {'plain' if plain else 'kernels'} step "
                      f"{step}: {dec(s)} {vals(s)}", flush=True)
            print(f"  {secs:.2f} s, peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
                  flush=True)

    out = []
    for k, (dec, vals) in enumerate(views):
        def gap(xs, ys):
            return max(abs(g - w) / abs(w) for a in xs for b in ys
                       for g, w in zip(vals(a), vals(b)))

        kern = [run[k] for run in sides[False]]
        plain = [run[k] for run in sides[True]]
        same = all(dec(s) == dec(kern[0]) for s in kern + plain)
        out.append(gap(kern, plain))
        print(json.dumps(dict(scale=scale, step=k + 1, spread_runs=runs,
                              same_decisions=same, largest_gap=out[-1],
                              within_side=dict(kernels=gap(kern, kern),
                                               plain=gap(plain, plain)))),
              flush=True)
    return out


def step2_starts(runs: int, iters: int = FINAL_STEP2_ITERS) -> list:
    """final-13682's step 2 from the LM loop's own start (the module
    docstring's `starts`). Returns, per run, the step-2 iteration of the
    first accepted trial (None: none in `iters`) and whether the trial
    at STEP2_LAMBDA from that start has a finite increment."""
    problem = make_problem("final-13682")
    args = (problem.obs_cam, problem.obs_lm, problem.obs_uv,
            problem.num_cameras, problem.num_landmarks)
    opts = SolverOptions(max_num_iterations_step_1=START2_ITERS,
                         max_num_iterations_step_2=iters)
    s1 = Stage1Solver(*args, opts, device="cuda")
    s2 = Stage2Solver(*args, opts, device="cuda")
    cams = torch.as_tensor(problem.cam_space, device="cuda")
    lms = torch.as_tensor(problem.lm_p, device="cuda")
    firsts, finite = [], []
    for r in range(runs):
        c, l_h = create_homogeneous(*optimize_step1(
            s1, cams, lms, opts, SolverSummary(), Timer(), lambda s: None))
        l2 = s2.lm_pack(l_h)
        ok = s2.trial(c, l2, s2.linearize(c, l2), STEP2_LAMBDA)[2]
        finite.append(bool(ok))
        summary = SolverSummary()
        optimize_step2(s2, c, l_h, opts, summary, Timer(), lambda s: None)
        seq = "".join("A" if ok else "R" for ok, _ in decisions(summary))
        firsts.append(seq.index("A") + 1 if "A" in seq else None)
        print(f"run {r} step 2: {seq}, first accepted trial {firsts[-1]}, "
              f"costs {recorded_costs(summary)}; trial at lambda "
              f"{STEP2_LAMBDA:g} finite: {finite[-1]}", flush=True)
    print(json.dumps(dict(scale="final-13682", step2_iterations=iters,
                          runs=runs, first_accepted=firsts,
                          finite_at_step2_lambda=finite)), flush=True)
    return firsts, finite


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scales", nargs="*",
                    help=f"'spread', 'starts', or scales of "
                    f"{tuple(SCALES)}")
    ap.add_argument("--loops", action="store_true",
                    help="lay add_loop_closures_and_scramble over each scale")
    ap.add_argument("--runs", type=int, default=8,
                    help="spread: runs on each side; starts: runs")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("large_scale: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    if a.scales[:1] == ["spread"]:
        for scale in a.scales[1:] or ["venice-1778"]:
            if scale not in ("venice-1778", "final-13682"):
                ap.error(f"spread takes venice-1778 or final-13682, not "
                         f"{scale!r}")
            spread(a.runs, scale)
        return 0
    if a.scales == ["starts"]:
        step2_starts(a.runs)
        return 0
    for scale in a.scales or list(SCALES):
        if scale not in SCALES:
            ap.error(f"unknown scale {scale!r}")
        run_scale(scale, a.loops)
    return 0


if __name__ == "__main__":
    sys.exit(main())

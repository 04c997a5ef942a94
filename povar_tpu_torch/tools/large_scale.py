"""Large-N runs of povar_tpu_torch on one card: the port's counterpart of
benchmarks/large_scale_smoke.py, which runs the JAX package.

    python -m povar_tpu_torch.tools.large_scale [SCALE ...] [--loops]
    python -m povar_tpu_torch.tools.large_scale spread [final-13682]
        [--runs 8] [--solver CHOLESKY | --mesh]
    python -m povar_tpu_torch.tools.large_scale mesh [SCALE ...]
        [--devices 4 1] [--loops]
    python -m povar_tpu_torch.tools.large_scale ba [SCALE ...] [--runs 8]
    python -m povar_tpu_torch.tools.large_scale starts [--runs 8]
    python -m povar_tpu_torch.tools.large_scale band [SCALE ...]
    python -m povar_tpu_torch.tools.large_scale band-spread [--runs 8]

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

`spread --mesh` runs the same on a 1-device mesh (the SPMD window
layout, parallel/spmd.py; both stage solvers built once), the slot
kernels among the kernels swapped for their plain versions:
chip_smoke.py's MESH_LARGE_N_TOL and MESH_FINAL_TOLS are twice its gaps.

`mesh` builds each scale's SPMD window plan for each of `--devices`
(default 4, then 1) as a rank builds it (plan_stats: seconds, peak and
held host bytes, lane utilization, windows and parts per class,
has_duplicates, a rank's lanes, slot rows and landmark slots), then on
a 1-device mesh (mesh_run) times the set-up, the warm step-1 and step-2
iterations against the one-device path's in turns, and one
`bundle_adjust(mesh=make_mesh(1))`. Default: venice-1778 and
final-13682.

`ba` runs `bundle_adjust` with SolverOptions() defaults on a 1-device
mesh and on one device in turns, `--runs` times each, each from the
scale's own state (ba_turns): seconds, and each step's records,
decisions, initial and final cost and termination. Default:
final-13682.

`spread --solver CHOLESKY` (venice-1778 only) compares CHOLESKY's first
BAND_ITERS iterations instead; its dense route ends at 1536 cameras, so
venice-1778 takes the banded one of solver/band_chol.py.

`band` runs CHOLESKY's route at each scale (default venice-1778,
venice-1778-uniform, final-13682, final-13682-adversarial; band_run):
the route (band, full band or the PCG fallback, with the JAX package's
warning), bw, K, S, the plan's seconds and device bytes, the
construction's seconds, BAND_ITERS step-1 iterations, the milliseconds
of one assembly, one factorization and solve, and one trial (CUDA
events), the banded increment's residual (band_residual), and the peak
device memory. `band-spread` solves one linearization of venice-89 (no
band: one supernode) and of BANDED_1000 (a band of several supernodes)
by the banded route and by the dense one `--runs` times, each time from
a fresh linearization, in mixed precision and in pure f64, and prints
the largest relative gap of the increments; then the residual of the
banded increment of `--runs` fresh linearizations of venice-1778 and of
final-13682 (mixed precision): chip_smoke.py's BAND_DENSE_TOLS and
BAND_RESIDUAL_TOLS are twice those.

Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import subprocess
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
    make_mesh,
    optimize_step1,
    optimize_step2,
)
from povar_tpu_torch.options import SolverType
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
# CHOLESKY's step-1 iterations in `band` and in the CHOLESKY spread
BAND_ITERS = 2
# where `band-spread` (and chip_smoke.py's band_chol (a)) hold the
# banded route to the dense one (cameras, landmarks, observations per
# landmark, camera locality): venice-89, bench.py's problem, whose graph
# has no band (one supernode, the full band), and a locality problem
# small enough for the dense route (A and S 7.8 GB in f32, 15.6 in f64)
# whose band has several supernodes (bw 120, K 128, S 8), so that the
# coupling blocks and the sweeps across supernodes run
VENICE_89 = (89, 110_973, 5, 0)
BANDED_1000 = (1000, 50_000, 5, 64)


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


def iteration_times(step, c, lm, reps: int = REPS, top: int = 0):
    """(wall ms, device us, busy share) of one warm chained iteration:
    `reps` calls of `step` (c, lm) -> (c, lm, err) chained with one
    synchronisation, then the same under the profiler, whose device
    operations' summed durations give the device time; with `top`, the
    `top` device operations by time an iteration are printed."""
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
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + (
                e.time_range.elapsed_us())
    dev = sum(by_name.values())
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {us / reps:10.1f} us an iteration  {name[:80]}",
              flush=True)
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


def stage_solvers(problem, options, mesh=None):
    """Both stage solvers of `problem` on the card under `options`, or
    on this rank of `mesh` the SPMD window layout's (its plan built once
    and kept on the problem, as bundle_adjust keeps it)."""
    from povar_tpu_torch.solver.pipeline import _make_solvers

    return _make_solvers(problem, options, torch.float64, "cuda", mesh)


def lm_state(solver, lm_p):
    """`solver`'s landmark state of the canonical landmarks lm_p (numpy):
    on a mesh its rank's shard (pad_landmarks), else the whole array, on
    the solver's device."""
    if hasattr(solver, "pad_landmarks"):
        return solver.pad_landmarks(lm_p)
    return torch.as_tensor(lm_p, device=solver.device)


def plan_stats(problem, n_dev: int, label: str, trace: bool = True) -> dict:
    """`problem`'s SPMD window plan for n_dev devices, as each rank builds
    it (the whole plan, then the whole combine reduce, in its own
    process): seconds of each, with `trace` the host bytes at the peak
    (of a second build under tracemalloc, which sees numpy's buffers),
    the bytes the plan and combine hold after it, lane utilization, the
    window width, windows and parts of each class, has_duplicates, and a
    rank's lanes, slot rows and landmark slots against the observations.
    The plan stays on the problem (`bundle_adjust`'s cache), so the mesh
    solvers built next for the same n_dev reuse it."""
    import tracemalloc

    from povar_tpu_torch.parallel.spmd import build_uniform_combine
    from povar_tpu_torch.solver.pipeline import _make_spmd_plan

    def build():
        problem._spmd_plan_cache = None
        t0 = time.perf_counter()
        plan = _make_spmd_plan(problem, n_dev)
        t1 = time.perf_counter()
        combine = build_uniform_combine(plan.row_lm_ext, n_dev,
                                        plan.n_rows_dev, plan.m_dev)
        return plan, combine, t1 - t0, time.perf_counter() - t1

    # timed untraced, then (with `trace`) built again under tracemalloc
    # for the bytes (tracing slows Python's own allocations)
    plan, combine, plan_s, combine_s = build()
    peak = None
    if trace:
        tracemalloc.start()
        plan, combine, _s, _s = build()
        peak = tracemalloc.get_traced_memory()[1]
        tracemalloc.stop()
    held = sum(a.nbytes for a in plan if hasattr(a, "nbytes")) + sum(
        t.numel() * t.element_size() for t in (*combine.idx, *combine.mask,
                                               combine.inv_order))
    out = dict(
        scale=label, n_dev=n_dev, n_cams=problem.num_cameras,
        n_obs=problem.num_observations, plan_s=plan_s, combine_s=combine_s,
        peak_host_bytes=peak, held_host_bytes=held,
        lane_utilization=plan.lane_utilization, width=plan.width,
        classes=[dict(windows=cl.n_windows, parts=cl.parts,
                      win_lanes=cl.win_lanes) for cl in plan.layout],
        has_duplicates=plan.has_duplicates, lanes_per_rank=plan.o_dev,
        slot_rows_per_rank=plan.n_rows_dev, landmarks_per_rank=plan.m_dev)
    peak_txt = "not traced" if peak is None else f"{peak / 2**30:.2f} GiB"
    print(f"{label} plan, D = {n_dev}: {plan_s:.2f} s (+ combine "
          f"{combine_s:.2f} s), peak host {peak_txt}, held "
          f"{held / 2**30:.2f} GiB; width {plan.width}, lane utilization "
          f"{plan.lane_utilization:.4f}, classes {out['classes']}, "
          f"duplicates {plan.has_duplicates}; a rank: {plan.o_dev} lanes, "
          f"{plan.n_rows_dev} slot rows, {plan.m_dev} landmark slots for "
          f"{problem.num_observations} observations in all", flush=True)
    return out


def mesh_run(problem, label: str) -> dict:
    """The 1-device mesh at one scale with SolverOptions() defaults: the
    set-up of both mesh stage solvers and of the one-device ones, the
    warm step-1 and step-2 iterations of each (bench_options, REPS
    chained; mesh and one device in turns, twice, the second time with
    the eight longest device operations), then one
    `bundle_adjust(mesh=make_mesh(1))` (seconds, records, costs) and the
    peak device memory."""
    torch.cuda.reset_peak_memory_stats()
    opts = SolverOptions()
    solvers, setup = {}, {}
    for name, mesh in (("mesh", make_mesh(1)), ("one device", None)):
        t0 = time.perf_counter()
        solvers[name] = stage_solvers(problem, bench_options(opts), mesh)
        torch.cuda.synchronize()
        setup[name] = time.perf_counter() - t0
    print(f"{label}: set-up {setup['mesh']:.2f} s on the mesh (its plan "
          f"kept), {setup['one device']:.2f} s on one device", flush=True)
    c = torch.as_tensor(problem.cam_space, device="cuda")
    times = {name: [] for name in solvers}
    for rnd in range(2):
        for name, (s1, s2) in solvers.items():
            lm0 = s1.initialize_varproj(c)
            c2, lm2 = create_homogeneous(c, lm0)
            its = []
            for s, cc, ll in ((s1, c, lm0), (s2, c2, lm2)):
                def step(cc, ll, s=s):
                    lin = s.linearize(cc, ll)
                    nc, nl, _ok, _it, _ld, err = s.trial(cc, ll, lin, 1e-4)
                    return nc, nl, err["error_all"]

                if rnd:
                    print(f"{label} {name}, step {len(its) + 1}: device "
                          "operations by time", flush=True)
                its.append(iteration_times(step, cc, s.lm_pack(ll),
                                           top=8 if rnd else 0))
            times[name].append(its)
            print(f"{label} {name}: warm step-1 / step-2 iteration "
                  f"(linearize + trial, eta=0, m=10, {REPS} chained): wall "
                  f"{its[0][0]:.3f} / {its[1][0]:.3f} ms, device "
                  f"{its[0][1]:.1f} / {its[1][1]:.1f} us (busy "
                  f"{its[0][2]:.3f} / {its[1][2]:.3f})", flush=True)
    del solvers, lm0, c2, lm2
    ba = ba_run(problem, label, make_mesh(1))
    out = dict(scale=label, setup_s=setup, iterations=times,
               bundle_adjust_s=ba["seconds"], records=ba["records"],
               costs=ba["costs"],
               peak_bytes=torch.cuda.max_memory_allocated())
    print(json.dumps(out), flush=True)
    return out


def ba_run(problem, label: str, mesh=None) -> dict:
    """One `bundle_adjust` of a copy of `problem` with SolverOptions()
    defaults on the card, or on `mesh`: its seconds to a
    synchronisation, and each step's records, decisions (A / R),
    initial and final cost, termination type and message."""
    p = copy.deepcopy(problem)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _out, sum1, sum2 = bundle_adjust(p, SolverOptions(), log=lambda s: None,
                                     mesh=mesh)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    steps = [dict(records=len(s.iterations),
                  decisions="".join("A" if ok else "R"
                                    for ok, _n in decisions(s)),
                  costs=(s.iterations[0].cost.all.error,
                         s.final_cost.all.error),
                  termination=s.termination_type, message=s.message)
             for s in (sum1, sum2)]
    where = "one device" if mesh is None else f"mesh=make_mesh({mesh.size})"
    print(f"{label} bundle_adjust({where}) {secs:.2f} s: " + "; ".join(
        f"step {k} {st['records']} records {st['decisions']}, "
        f"{st['costs'][0]!r} -> {st['costs'][1]!r}, {st['termination']} "
        f"({st['message']})" for k, st in enumerate(steps, 1)), flush=True)
    return dict(scale=label, mesh=mesh is not None, seconds=secs,
                records=[st["records"] for st in steps],
                costs=[st["costs"] for st in steps], steps=steps)


def ba_turns(problem, label: str, runs: int) -> list:
    """`runs` bundle_adjusts (ba_run) on a 1-device mesh and as many on
    one device, in turns, each from the problem's own state; the mesh's
    plan built once (plan_stats), as bundle_adjust keeps it."""
    plan_stats(problem, 1, label, trace=False)
    out = []
    for _ in range(runs):
        for mesh in (make_mesh(1), None):
            out.append(ba_run(problem, label, mesh))
            print(json.dumps(out[-1]), flush=True)
    return out


def first_iterations(problem, plain: bool, iters: int = LARGE_N_ITERS,
                     solver: str = "POWER_VARPROJ", stage1=None):
    """Step 1's first `iters` iterations with SolverOptions() and
    `solver` on the card (its kernels, or with `plain` their plain
    versions on the card, the camera-table and slot ones too), on a new
    stage-1 solver or on `stage1` (built once for several runs, a mesh's
    too). Returns (summary, seconds)."""
    from povar_tpu_torch.tools.step2_spread import plain_step1

    opts = SolverOptions(solver_type_step_1=SolverType[solver])
    if stage1 is None:
        stage1 = Stage1Solver(problem.obs_cam, problem.obs_lm,
                              problem.obs_uv, problem.num_cameras,
                              problem.num_landmarks, opts, device="cuda")
    opts = copy.deepcopy(stage1.opts)
    opts.max_num_iterations_step_1 = iters
    cams = torch.as_tensor(problem.cam_space, device="cuda")
    lms = lm_state(stage1, problem.lm_p)
    summary = SolverSummary()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with (plain_step1(cams=True, slots=True) if plain
          else contextlib.nullcontext()):
        optimize_step1(stage1, cams, lms, opts, summary, Timer(),
                       lambda s: None)
    torch.cuda.synchronize()
    return summary, time.perf_counter() - t0


def first_steps(problem, s1, s2, plain: bool, start2=None):
    """On the stage solvers s1, s2 of `problem` (built once, any number
    of runs; a 1-device mesh's too): step 1's first LARGE_N_ITERS
    iterations from the problem's state, then one step-2 trial at
    STEP2_LAMBDA from `start2` (cameras and homogeneous landmarks, a
    mesh's in its shard; None: the homogenized VarProj initialization of
    the problem's cameras), on the card's kernels or, with `plain`, all
    their plain versions on the card. Returns (step-1 summary, the
    trial's {ok, terms, l_diff, cost}, step 2's start, seconds of the
    compared work)."""
    from povar_tpu_torch.tools.step2_spread import plain_step1

    opts = copy.deepcopy(s1.opts)
    opts.max_num_iterations_step_1 = LARGE_N_ITERS
    cams = torch.as_tensor(problem.cam_space, device="cuda")
    lms = lm_state(s1, problem.lm_p)
    if start2 is None:
        start2 = create_homogeneous(cams, s1.initialize_varproj(cams))
    summary = SolverSummary()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with (plain_step1(cams=True, step2=True, slots=True) if plain
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


def spread(runs: int, scale: str = "venice-1778",
           solver: str = "POWER_VARPROJ", mesh: bool = False) -> list:
    """The first-iterations spread of `scale` (the module docstring):
    venice-1778's step 1 (first_iterations; its accepted costs, or with
    CHOLESKY every trial's cost over BAND_ITERS iterations), or
    final-13682's step 1 (first_steps; every trial's cost) and its
    step-2 trial (l_diff and cost); with `mesh` on a 1-device mesh's
    stage solvers (built once). Returns the largest kernel-against-plain
    gap of each step."""
    problem = make_problem(scale)
    steps = 1 if scale == "venice-1778" else 2
    chol = solver == "CHOLESKY"
    # per step: (decisions, compared values) of a run's result
    views = [(decisions, accepted_costs if steps == 1 and not chol
              else recorded_costs),
             (lambda t: [(t["ok"], t["terms"])],
              lambda t: [t["l_diff"], t["cost"]])][:steps]
    s1 = None
    if steps == 2 or mesh:
        t0 = time.perf_counter()
        s1, s2 = stage_solvers(problem, SolverOptions(),
                               make_mesh(1) if mesh else None)
        print(f"set-up {time.perf_counter() - t0:.1f} s", flush=True)
    sides = {False: [], True: []}
    start2 = None
    for r in range(runs):
        for plain in (False, True):
            torch.cuda.reset_peak_memory_stats()
            if steps == 1:
                s, secs = first_iterations(
                    problem, plain, BAND_ITERS if chol else LARGE_N_ITERS,
                    solver, s1)
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
        print(json.dumps(dict(scale=scale, solver=solver, mesh=mesh,
                              step=k + 1, spread_runs=runs,
                              same_decisions=same, largest_gap=out[-1],
                              within_side=dict(kernels=gap(kern, kern),
                                               plain=gap(plain, plain)))),
              flush=True)
    return out


@contextlib.contextmanager
def banded_route():
    """CHOLESKY's dense route closed (stage1.DENSE_CHOL_MAX 0) for the
    stage-1 solvers built while the block runs: they take the banded
    route at any camera count, as past 1536 cameras."""
    from povar_tpu_torch.solver import stage1

    saved = stage1.DENSE_CHOL_MAX
    stage1.DENSE_CHOL_MAX = 0
    try:
        yield
    finally:
        stage1.DENSE_CHOL_MAX = saved


def route_of(solver) -> str:
    """CHOLESKY's route on a stage-1 solver: "dense", "band", "full band"
    or "pcg" (the fallback)."""
    if solver._chol_pcg_fallback:
        return "pcg"
    if solver._band_plan is None:
        return "dense"
    meta = solver._band_plan.meta
    return "full band" if meta.bw >= meta.n_cams - 1 else "band"


def event_ms(fn, reps: int = 3) -> float:
    """Median CUDA-event milliseconds of `fn()` over `reps` calls after a
    warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def band_residual(solver, lin, lam: float) -> float:
    """||S x - b|| / ||b|| of CHOLESKY's increment inc = -x at (lin,
    lam) on a stage-1 solver's banded route, with S applied matrix-free
    as PCG applies it (hpp + lam I less E0 through e0_u and e0_scatter,
    slots._pcg_iterate_u) in the solve dtype: an answer that shares
    nothing with the band's assembly and factorization but hpp and b."""
    from povar_tpu_torch.solver.slots import mv

    inc, _ = solver.solve_cholesky(lin, lam)
    lam_s = solver._solve_scalar(lam)
    hll_inv, hll_inv_bl = solver._hll_inv_u(lin.Jl, lin.r, None)
    hpp, b = solver._hpp_b_u(lin.Jp, lin.Jl, lin.r, hll_inv_bl)
    w = solver._e0_factor_u(lin.Jp, lin.Jl, hll_inv)
    x = -inc.to(b.dtype)
    sx = mv(hpp, x) + lam_s * x - solver._e0_w_matvec(x, w)
    return float((sx - b).norm() / b.norm())


def band_trial_ms(solver, cams, lms, lam: float = 1e-4) -> dict:
    """Milliseconds (CUDA events) of CHOLESKY's pieces at the state
    (cams, lms): one assembly (band_chol.assemble_band) and one
    factorization and solve (band_chol.solve_band) of the banded route,
    and one whole trial (solve, apply, cost) on any route; and on the
    banded route the increment's residual (band_residual)."""
    from povar_tpu_torch.ops import linalg
    from povar_tpu_torch.solver import band_chol

    lin = solver.linearize(cams, lms)
    out = dict(trial_ms=event_ms(lambda: solver.trial(cams, lms, lin, lam)))
    if solver._band_plan is not None:
        out["residual"] = band_residual(solver, lin, lam)
        meta, arrs = solver._band_plan.meta, solver._band_arrays
        lam_s = solver._solve_scalar(lam)
        hll_inv, hll_inv_bl = solver._hll_inv_u(lin.Jl, lin.r, None)
        hpp, b = solver._hpp_b_u(lin.Jp, lin.Jl, lin.r, hll_inv_bl)
        w = torch.einsum("kio,kjo->ijo", lin.Jp, lin.Jl)
        wl = torch.einsum("ijo,jko->iko", w, solver._gather_lm_x(
            linalg.cholesky_smallf(hll_inv))).contiguous()
        del w
        out["assembly_ms"] = event_ms(
            lambda: band_chol.assemble_band(meta, arrs, wl, hpp, lam_s))
        s_flat = band_chol.assemble_band(meta, arrs, wl, hpp, lam_s)
        del wl
        out["factor_solve_ms"] = event_ms(
            lambda: band_chol.solve_band(meta, arrs, s_flat.clone(), b))
    return out


def band_run(problem, label: str, iters: int = BAND_ITERS,
             plain: bool = False) -> dict:
    """CHOLESKY step 1 on `problem` (module docstring, `band`): the
    solver built on the card (its route, the warnings it raised, bw, K,
    S, the plan's seconds and device bytes, the construction's seconds),
    `iters` iterations of optimize_step1 (the host loop; with `plain` on
    the plain versions of the kernels) from the problem's state, with the
    kernels' launch counters zeroed just before and read just after
    ("launches"), then
    band_trial_ms at the VarProj start, and the peak device memory.
    Prints one line and returns a dict (with the summary under
    "summary")."""
    from povar_tpu_torch.ops import launches
    from povar_tpu_torch.solver import band_chol
    from povar_tpu_torch.tools.step2_spread import plain_step1

    opts = SolverOptions(solver_type_step_1=SolverType.CHOLESKY,
                         max_num_iterations_step_1=iters)
    args = (problem.obs_cam, problem.obs_lm, problem.obs_uv,
            problem.num_cameras, problem.num_landmarks)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        s1 = Stage1Solver(*args, opts, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    warned = [str(w.message) for w in caught
              if issubclass(w.category, RuntimeWarning)]
    meta = None if s1._band_plan is None else s1._band_plan.meta
    cams = torch.as_tensor(problem.cam_space, device="cuda")
    lms = torch.as_tensor(problem.lm_p, device="cuda")
    summary = SolverSummary()
    t0 = time.perf_counter()
    launches.reset_launch_counts()
    with plain_step1(cams=True) if plain else contextlib.nullcontext():
        optimize_step1(s1, cams, lms, opts, summary, Timer(),
                       lambda s: None)
    torch.cuda.synchronize()
    step1_s = time.perf_counter() - t0
    counts = launches.launch_counts()
    times = band_trial_ms(s1, cams, s1.initialize_varproj(cams))
    out = dict(
        scale=label, route=route_of(s1),
        bw=None if meta is None else meta.bw,
        K=None if meta is None else meta.K,
        S=None if meta is None else meta.S,
        plan_s=s1.band_plan_seconds,
        plan_bytes=(None if meta is None
                    else band_chol.plan_bytes(s1._band_arrays)),
        setup_s=setup_s, step1_s=step1_s, iterations=iters,
        records=len(summary.iterations),
        decisions="".join("A" if it.step_is_successful else "R"
                          for it in summary.iterations[1:]),
        inner=[it.linear_solver_iterations for it in summary.iterations],
        costs=recorded_costs(summary), **times,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        warnings=[w[:60] for w in warned])
    print(json.dumps(out), flush=True)
    out.update(summary=summary, warned=warned, launches=counts)
    return out


def band_spread(runs: int, lam: float = 1e-4) -> dict:
    """The banded route's spreads (module docstring, `band-spread`):
    venice-89's and BANDED_1000's banded increment against the dense one,
    per run a fresh linearization of the VarProj start solved by both
    routes at `lam`, in mixed precision and in pure f64; then the banded
    increment's residual (band_residual) of a fresh linearization of
    venice-1778's and final-13682's VarProj start per run, in mixed
    precision. Returns {problem: {"mixed": gaps, "f64": gaps}} and
    {"residual": {scale: residuals}}."""
    out = {}
    for name, shape in (("venice-89", VENICE_89),
                        ("banded-1000", BANDED_1000)):
        n_cams, n_lms, obs_per_lm, locality = shape
        problem = synthetic_bal_problem_fast(n_cams, n_lms, obs_per_lm,
                                             seed=0, locality=locality)
        args = (problem.obs_cam, problem.obs_lm, problem.obs_uv,
                problem.num_cameras, problem.num_landmarks)
        cams = torch.as_tensor(problem.cam_space, device="cuda")
        out[name] = {}
        for config, mixed in (("mixed", True), ("f64", False)):
            opts = SolverOptions(solver_type_step_1=SolverType.CHOLESKY,
                                 mixed_precision_solves=mixed)
            dense = Stage1Solver(*args, opts, device="cuda")
            with banded_route(), warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                band = Stage1Solver(*args, opts, device="cuda")
            meta = band._band_plan.meta
            lms = dense.initialize_varproj(cams)
            gaps = []
            for r in range(runs):
                lin = dense.linearize(cams, lms)
                want, _ = dense.solve_cholesky(lin, lam)
                got, _ = band.solve_cholesky(lin, lam)
                gaps.append(float((got - want).norm() / want.norm()))
                print(f"{name} {config} (bw {meta.bw}, K {meta.K}, S "
                      f"{meta.S}) run {r}: band vs dense {gaps[-1]:.3e}",
                      flush=True)
            out[name][config] = gaps
            del dense, band, lin, want, got
    out["residual"] = {}
    for scale in ("venice-1778", "final-13682"):
        problem = make_problem(scale)
        opts = SolverOptions(solver_type_step_1=SolverType.CHOLESKY)
        solver = Stage1Solver(problem.obs_cam, problem.obs_lm,
                              problem.obs_uv, problem.num_cameras,
                              problem.num_landmarks, opts, device="cuda")
        cams = torch.as_tensor(problem.cam_space, device="cuda")
        lms = solver.initialize_varproj(cams)
        res = []
        for r in range(runs):
            res.append(band_residual(solver, solver.linearize(cams, lms),
                                     lam))
            print(f"{scale} ({route_of(solver)}, S "
                  f"{solver._band_plan.meta.S}) run {r}: residual "
                  f"{res[-1]:.3e}", flush=True)
        out["residual"][scale] = res
        del solver, problem, cams, lms
    print(json.dumps(dict(
        band_spread_runs=runs, lam=lam,
        largest={k: ({c: max(g) for c, g in v.items()})
                 for k, v in out.items()})), flush=True)
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
                    help=f"'spread', 'starts', 'band', 'band-spread', "
                    f"'mesh', 'ba', or scales of {tuple(SCALES)}")
    ap.add_argument("--loops", action="store_true",
                    help="lay add_loop_closures_and_scramble over each scale")
    ap.add_argument("--runs", type=int, default=8,
                    help="spread, band-spread, ba: runs on each side; "
                    "starts: runs")
    ap.add_argument("--solver", default="POWER_VARPROJ",
                    choices=["POWER_VARPROJ", "CHOLESKY"],
                    help="spread: step 1's solver")
    ap.add_argument("--mesh", action="store_true",
                    help="spread: on a 1-device mesh")
    ap.add_argument("--devices", type=int, nargs="+", default=[4, 1],
                    help="mesh: the plan's device counts")
    a = ap.parse_args(argv)
    if a.solver != "POWER_VARPROJ" and a.scales[:1] != ["spread"]:
        ap.error("--solver applies to spread only")
    if a.mesh and (a.scales[:1] != ["spread"] or a.solver == "CHOLESKY"):
        ap.error("--mesh applies to spread with POWER_VARPROJ only")
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
            if scale not in ("venice-1778", "final-13682") or (
                    a.solver == "CHOLESKY" and scale != "venice-1778"):
                ap.error(f"spread takes venice-1778 or final-13682 (with "
                         f"CHOLESKY venice-1778), not {scale!r}")
            spread(a.runs, scale, a.solver, a.mesh)
        return 0
    if a.scales[:1] == ["mesh"]:
        for scale in a.scales[1:] or ["venice-1778", "final-13682"]:
            if scale not in SCALES:
                ap.error(f"unknown scale {scale!r}")
            t0 = time.perf_counter()
            problem = make_problem(scale, a.loops)
            label = scale + ("-loops" if a.loops else "")
            print(f"== {label}: generated in {time.perf_counter() - t0:.2f} "
                  "s", flush=True)
            # the last plan built stays on the problem for mesh_run
            for n_dev in sorted(set(a.devices) - {1}, reverse=True) + [1]:
                print(json.dumps(plan_stats(problem, n_dev, label)),
                      flush=True)
            mesh_run(problem, label)
        return 0
    if a.scales[:1] == ["ba"]:
        for scale in a.scales[1:] or ["final-13682"]:
            if scale not in SCALES:
                ap.error(f"unknown scale {scale!r}")
            ba_turns(make_problem(scale), scale, a.runs)
        return 0
    if a.scales == ["starts"]:
        step2_starts(a.runs)
        return 0
    if a.scales == ["band-spread"]:
        band_spread(a.runs)
        return 0
    if a.scales[:1] == ["band"]:
        for scale in a.scales[1:] or ["venice-1778", "venice-1778-uniform",
                                      "final-13682",
                                      "final-13682-adversarial"]:
            if scale not in SCALES:
                ap.error(f"unknown scale {scale!r}")
            band_run(make_problem(scale), scale)
        return 0
    for scale in a.scales or list(SCALES):
        if scale not in SCALES:
            ap.error(f"unknown scale {scale!r}")
        run_scale(scale, a.loops)
    return 0


if __name__ == "__main__":
    sys.exit(main())

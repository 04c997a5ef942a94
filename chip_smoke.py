"""Smoke run of povar_tpu_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Drives step 1 of the solve (pOSE VarProj LM, POWER_VARPROJ, m = 10) of
the PyTorch / CUDA port in phases, each printing its lines and raising on
failure (a failure exits non-zero and prints no result line):

1. device   a CUDA device, its name and power limit (nvidia-smi);
2. build    the seven kernels of povar_tpu_torch/csrc/ from source;
3. kernels  each kernel at the venice-89 shapes (O = 557,056 padded
            observations, N = 89 cameras) on seeded inputs, against its
            plain PyTorch version on the same card, with CUDA-event
            times (median of 20 calls) and profiler device times (mean
            of 20 calls) for both; the large-N variant of
            hpp_b_structured at N = 1024;
4. slice    a 6-iteration solve of a small problem on the card against
            the same solve through the plain versions on the CPU; then
            the venice-89-scale solve (synthetic_bal_problem_fast(89,
            110973, 5, seed=0), SolverOptions() defaults except
            fused_power_term=False, device_lm_loop="off") with launch
            counters zeroed just before and read just after: every
            kernel must have run, accepted costs must fall strictly, and
            the final cost must be within 1e-3 relative of 207.47874642216357,
            the JAX package's final step-1 cost on the same problem
            (BENCH_r05.json); then a warm repeat of the solve, the warm
            time of one full step-1 iteration as bench.py times it
            (linearize + trial, eta = 0, m = 10, 50 chained iterations,
            one synchronisation) and a profiler breakdown of it.

The second-to-last line is {"kernels": [...]} (per-kernel route, source,
replaced TPU kernel, launches in the main solve, max abs error against
the plain version, and both times); the last line is
{"ok": true, "device": {...}}. Needs the repository (the package and its
kernel sources) beside this file; imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

JAX_FINAL_COST = 207.47874642216357  # BENCH_r05.json e2e_final_cost_step1
N_CAMS, N_LMS, OBS_PER_LM = 89, 110_973, 5
REPS = 20
SOURCE = "povar_tpu_torch/csrc/pose1.cu"
REPLACES = {
    "prepare": "povar_tpu/ops/pallas_pose.py:285",
    "e0_factor": "povar_tpu/ops/pallas_pose.py:385",
    "hpp_b_structured": "povar_tpu/ops/pallas_pose.py:489",
    "e0_u_structured": "povar_tpu/ops/pallas_pose.py:568",
    "e0_scatter_structured": "povar_tpu/ops/pallas_pose.py:623",
    "apply_ldiff": "povar_tpu/ops/pallas_pose.py:846",
    "pose_error": "povar_tpu/ops/pallas_pose.py:1319",
}
# tolerances, relative to max |plain|: elementwise outputs see only FMA
# contraction; per-camera sums and l_diff also see the order of f32
# atomics; the f64 cost sees the order of f64 sums
TOL_ELEM, TOL_SUM, TOL_F64 = 1e-5, 1e-4, 1e-12


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median of `reps` CUDA-event timings of one call, after a warm-up.
    The events bracket the whole call, so a call whose host side
    (Python, allocation, launch) outlasts its device work is timed at
    its host cost: see device_us for the device's own time."""
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
    return statistics.median(times)


def device_us(fn, reps: int = REPS) -> float:
    """Device time of one call in microseconds: the summed durations of
    every device operation (kernels, fills, copies) the profiler records
    over `reps` calls, divided by `reps`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(
        e.time_range.elapsed_us() for e in prof.events()
        if e.device_type == DeviceType.CUDA
    ) / reps


def compare(name, got, want, tols):
    """max |got - want| per output against tol * max |want|; raises on a
    miss. Returns the largest absolute error."""
    worst = 0.0
    for k, (g, w, tol) in enumerate(zip(got, want, tols)):
        g64, w64 = g.double(), w.double()
        if g64.shape != w64.shape:
            raise AssertionError(f"{name}[{k}]: shape {g64.shape} != {w64.shape}")
        if not bool(torch.isfinite(g64).all()):
            raise AssertionError(f"{name}[{k}]: non-finite kernel output")
        err = float((g64 - w64).abs().max())
        scale = float(w64.abs().max())
        if not err <= tol * scale:
            raise AssertionError(
                f"{name}[{k}]: max |kernel - plain| = {err:.3e} > "
                f"{tol:g} * {scale:.3e}"
            )
        worst = max(worst, err)
    return worst


def kernel_inputs(solver, problem, seed=0):
    """Seeded inputs at the solver's shapes: the real slot layout (cam,
    uv, mask) and numpy-seeded random operands."""
    rng = np.random.default_rng(seed)
    dev = solver.device
    o, n = int(solver.obs.cam.shape[0]), solver.n_cams
    mask = solver._mask1

    def f32(*shape, lo=None, hi=None):
        a = (rng.standard_normal(shape) if lo is None
             else rng.uniform(lo, hi, shape))
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    sw = f32(1, o, lo=0.5, hi=1.0) * mask
    return dict(
        cam=solver.obs.cam, uv=solver._uv_s, mask=mask,
        ct=torch.as_tensor(
            problem.cam_space.reshape(n, 12).T.copy(), dtype=torch.float32,
            device=dev,
        ),
        x=f32(3, o), sw=sw, w=sw * sw, r_w=f32(4, o) * mask,
        jls=f32(3, o, lo=0.1, hi=1.0), hib=f32(3, o), lh=f32(9, o),
        h=f32(9, o) * mask, z=f32(12, n), sb=f32(3, o), inc=f32(12, n),
        inc_lm=f32(3, o),
        ct64=torch.as_tensor(
            problem.cam_space.reshape(n, 12).T.copy(), dtype=torch.float64,
            device=dev,
        ),
        x64=torch.as_tensor(rng.standard_normal((3, o)), device=dev),
        uv64=solver.obs.uv,
    )


def check_kernels(solver, problem, alpha):
    from povar_tpu_torch.ops import pose_kernels as pk
    from povar_tpu_torch.ops import pose_ref as pr

    d = kernel_inputs(solver, problem)
    n = solver.n_cams
    a = dict(alpha=alpha)
    cases = {
        "prepare": (
            lambda m: m.prepare(d["cam"], d["ct"], d["x"], d["uv"],
                                d["mask"], robust=0, huber=1.0, **a),
            [TOL_ELEM] * 4 + [TOL_SUM],
        ),
        "e0_factor": (
            lambda m: (m.e0_factor(d["cam"], d["ct"], d["uv"], d["w"],
                                   d["jls"], d["lh"], **a),),
            [TOL_ELEM],
        ),
        "hpp_b_structured": (
            lambda m: m.hpp_b_structured(d["cam"], d["ct"], d["x"], d["uv"],
                                         d["sw"], d["r_w"], d["jls"],
                                         d["hib"], n, **a),
            [TOL_SUM, TOL_SUM],
        ),
        "e0_u_structured": (
            lambda m: (m.e0_u_structured(d["cam"], d["x"], d["h"], d["z"]),),
            [TOL_ELEM],
        ),
        "e0_scatter_structured": (
            lambda m: (m.e0_scatter_structured(d["cam"], d["x"], d["h"],
                                               d["sb"], n),),
            [TOL_SUM],
        ),
        "apply_ldiff": (
            lambda m: (m.apply_ldiff(d["cam"], d["x"], d["uv"], d["sw"],
                                     d["r_w"], d["jls"], d["inc_lm"],
                                     d["ct"], d["inc"], **a),),
            [TOL_SUM],
        ),
        "pose_error": (
            lambda m: m.pose_error(d["cam"], d["ct64"], d["x64"], d["uv64"],
                                   d["mask"], robust=0, huber=1.0, **a),
            [TOL_F64, TOL_F64, 0.0],
        ),
    }
    results = {}
    for name, (run, tols) in cases.items():
        got = run(pk)
        torch.cuda.synchronize()
        want = run(pr)
        err = compare(name, got, want, tols)
        ms = cuda_ms(lambda: run(pk))
        plain_ms = cuda_ms(lambda: run(pr))
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        print(f"{name:<22} max_abs_err {err:.3e}  events: kernel {ms:.4f} ms"
              f" plain {plain_ms:.4f} ms  device: kernel "
              f"{device_us(lambda: run(pk)):.1f} us plain "
              f"{device_us(lambda: run(pr)):.1f} us", flush=True)

    # the large-N route of hpp_b_structured (direct global atomics when
    # 156 N floats of accumulators exceed a block's shared memory)
    rng = np.random.default_rng(1)
    nb = 1024
    cam_big = torch.as_tensor(
        rng.integers(0, nb, d["cam"].shape[0]).astype(np.int32),
        device=solver.device,
    )
    ct_big = torch.as_tensor(
        rng.standard_normal((12, nb)), dtype=torch.float32,
        device=solver.device,
    )

    def big(m):
        return m.hpp_b_structured(cam_big, ct_big, d["x"], d["uv"], d["sw"],
                                  d["r_w"], d["jls"], d["hib"], nb, **a)

    err = compare("hpp_b_structured N=1024", big(pk), big(pr),
                  [TOL_SUM, TOL_SUM])
    print(f"hpp_b_structured N=1024 max_abs_err {err:.3e}  events: kernel "
          f"{cuda_ms(lambda: big(pk)):.4f} ms plain "
          f"{cuda_ms(lambda: big(pr)):.4f} ms  device: kernel "
          f"{device_us(lambda: big(pk)):.1f} us plain "
          f"{device_us(lambda: big(pr)):.1f} us", flush=True)
    return results


def solve(problem, options, device, log=lambda s: None):
    """Build the solver and run optimize_step1. Returns (summary,
    (cams, lms), set-up seconds, solve seconds), the solve timed to a
    device synchronisation."""
    from povar_tpu_torch import (
        SolverSummary, Stage1Solver, Timer, from_numpy, optimize_step1,
    )

    t0 = time.perf_counter()
    _, cams, lms = from_numpy(
        problem.obs_cam, problem.obs_lm, problem.obs_uv, problem.cam_space,
        problem.lm_p, device=device,
    )
    solver = Stage1Solver(
        problem.obs_cam, problem.obs_lm, problem.obs_uv,
        problem.num_cameras, problem.num_landmarks, options, device=device,
    )
    summary = SolverSummary()
    if device == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = optimize_step1(solver, cams, lms, options, summary, Timer(), log)
    if device == "cuda":
        torch.cuda.synchronize()
    return summary, out, t1 - t0, time.perf_counter() - t1


def trajectory(summary):
    return [
        (it.step_is_successful, it.linear_solver_iterations,
         it.cost.all.error if it.cost is not None else None)
        for it in summary.iterations
    ]


def check_small():
    """The slice on a small problem, card against CPU (plain versions):
    the same decisions and term counts, costs within 1e-3 relative (f32
    inner solves in another summation order)."""
    from povar_tpu_torch import SolverOptions, synthetic_bal_problem

    problem, _ = synthetic_bal_problem(n_cams=8, n_lms=60, obs_per_lm=5,
                                       seed=7)
    opts = SolverOptions()
    opts.max_num_iterations_step_1 = 6
    opts.fused_power_term = False
    opts.device_lm_loop = "off"
    trajs = [trajectory(solve(problem, opts, dev)[0]) for dev in ("cuda", "cpu")]
    gap = 0.0
    for (ok_g, it_g, c_g), (ok_c, it_c, c_c) in zip(*trajs):
        if (ok_g, it_g) != (ok_c, it_c):
            raise AssertionError(f"small solve: card {trajs[0]} != cpu {trajs[1]}")
        gap = max(gap, abs(c_g - c_c) / abs(c_c))
    if len(trajs[0]) != len(trajs[1]) or not gap <= 1e-3:
        raise AssertionError(f"small solve: cost gap {gap:.3e} (> 1e-3)")
    print(f"small problem (8 cams, 60 lms): card == cpu decisions over "
          f"{len(trajs[0])} iterations, max cost gap {gap:.3e}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from povar_tpu_torch import SolverOptions, synthetic_bal_problem_fast
    from povar_tpu_torch.ops import _build
    from povar_tpu_torch.ops import pose_kernels as pk

    phase("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} x{torch.cuda.device_count()}", flush=True)

    phase("build")
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"built {lib.name} in {time.perf_counter() - t0:.2f} s", flush=True)
    for line in _build.build_log().splitlines():
        if "Function properties" in line or "Used" in line or "spill" in line:
            print("  ptxas " + line.strip(), flush=True)

    phase("kernels (venice-89 shapes)")
    t0 = time.perf_counter()
    problem = synthetic_bal_problem_fast(N_CAMS, N_LMS, OBS_PER_LM, seed=0)
    opts = SolverOptions()
    opts.fused_power_term = False
    opts.device_lm_loop = "off"
    from povar_tpu_torch import Stage1Solver

    probe = Stage1Solver(
        problem.obs_cam, problem.obs_lm, problem.obs_uv,
        problem.num_cameras, problem.num_landmarks, opts, device="cuda",
    )
    print(f"problem {problem.num_observations} obs -> O = "
          f"{probe.obs.cam.shape[0]} padded, N = {probe.n_cams}; set-up "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    results = check_kernels(probe, problem, opts.alpha)
    del probe

    phase("slice")
    check_small()
    pk.reset_launch_counts()
    summary, (cams, lms), setup_s, solve_s = solve(problem, opts, "cuda")
    counts = pk.launch_counts()
    its = summary.iterations
    seq = "".join("A" if it.step_is_successful else "R" for it in its[1:])
    terms = [it.linear_solver_iterations for it in its[1:]]
    final = summary.final_cost.all.error
    rel = abs(final - JAX_FINAL_COST) / JAX_FINAL_COST
    print(f"iterations {len(its) - 1} ({summary.termination_type}: "
          f"{summary.message})", flush=True)
    print(f"accept/reject {seq}", flush=True)
    print(f"power terms {terms}", flush=True)
    print(f"initial cost {its[0].cost.all.error!r} final cost {final!r} "
          f"rel diff to JAX {rel:.3e}", flush=True)
    print(f"launches {counts}", flush=True)
    print(f"first solve {solve_s:.3f} s (solver set-up {setup_s:.3f} s)",
          flush=True)
    accepted = [it.cost.all.error for it in its if it.step_is_successful]
    if any(b >= a for a, b in zip(accepted, accepted[1:])):
        raise AssertionError(f"accepted costs not strictly decreasing: {accepted}")
    if not rel <= 1e-3:
        raise AssertionError(f"final cost {final} off JAX {JAX_FINAL_COST}")
    if min(counts.values()) == 0:
        raise AssertionError(f"a kernel of the path never launched: {counts}")
    if tuple(cams.shape) != (N_CAMS, 3, 4) or tuple(lms.shape) != (N_LMS, 3):
        raise AssertionError(f"output shapes {cams.shape} {lms.shape}")
    if not (bool(torch.isfinite(cams).all()) and bool(torch.isfinite(lms).all())):
        raise AssertionError("non-finite optimized state")

    summary2, _, setup2_s, warm_s = solve(problem, opts, "cuda")
    final2 = summary2.final_cost.all.error
    if not abs(final2 - JAX_FINAL_COST) <= 1e-3 * JAX_FINAL_COST:
        raise AssertionError(f"warm repeat: final cost {final2}")
    print(f"warm solve {warm_s:.3f} s (solver set-up {setup2_s:.3f} s), "
          f"{len(summary2.iterations) - 1} iterations, final cost "
          f"{final2!r}", flush=True)

    bench = SolverOptions()
    bench.fused_power_term = False
    bench.device_lm_loop = "off"
    bench.power_sc_iterations = 10
    bench.eta = 0.0
    bench.r_tolerance = -1.0
    s = Stage1Solver(
        problem.obs_cam, problem.obs_lm, problem.obs_uv,
        problem.num_cameras, problem.num_landmarks, bench, device="cuda",
    )
    c = torch.as_tensor(problem.cam_space, device="cuda")
    lm = s.lm_pack(s.initialize_varproj(c))

    def step(c, lm):
        lin = s.linearize(c, lm)
        nc, nl, _ok, _it, _ld, err = s.trial(c, lm, lin, 1e-4)
        return nc, nl, err["error_all"]

    step(c, lm)
    torch.cuda.synchronize()
    reps = 50
    t0 = time.perf_counter()
    cc, ll = c, lm
    for _ in range(reps):
        cc, ll, err = step(cc, ll)
    float(err)
    per_it = (time.perf_counter() - t0) / reps
    print(f"warm step-1 iteration (linearize + trial, eta=0, m=10, "
          f"{reps} chained): {per_it * 1e3:.3f} ms", flush=True)
    profile_iterations(step, c, lm)

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
             launches=counts[name], **results[name])
        for name in pk.KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}))
    return 0


def profile_iterations(step, c, lm, reps: int = 5) -> None:
    """Device time by kernel over `reps` chained iterations, and the
    device's busy share of the wall time (torch.profiler; diagnostics
    only: a profiler that records nothing prints so and fails nothing)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            c, lm, err = step(c, lm)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, n = kern.get(e.name, (0.0, 0))
            kern[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    if not kern:
        print("profile: no device events recorded", flush=True)
        return
    busy = sum(t for t, _n in kern.values())
    calls = sum(n for _t, n in kern.values())
    print(f"profile over {reps} iterations: device {busy / reps:.1f} us/it "
          f"of {wall_us / reps:.1f} us/it wall (busy share "
          f"{busy / wall_us:.3f}); {calls / reps:.0f} device ops/it",
          flush=True)
    for name, (t, n) in sorted(kern.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {t / reps:9.1f} us/it {n / reps:7.1f} calls/it  "
              f"{name[:90]}", flush=True)


if __name__ == "__main__":
    sys.exit(main())

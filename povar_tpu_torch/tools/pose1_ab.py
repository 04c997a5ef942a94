"""`prepare`, `hpp_b_structured` and `e0_term_parts` against an earlier
version of their kernels, and against controlled variants of their own,
on one card.

    python -m povar_tpu_torch.tools.pose1_ab kernels --parent DIR
    python -m povar_tpu_torch.tools.pose1_ab bench
    python -m povar_tpu_torch.tools.pose1_ab psc --parent DIR --runs N

The step-1 counterpart of tools/pose2_ab.py, with its builds, variants
and timing loop. Run from the repository root (`chip_smoke.py` lends its
timers, its operands and its bench iteration). `kernels` builds
DIR/pose1.cu with DIR/pose_common.cuh (an earlier commit's csrc/ whose
entry points take the package's arguments except `povar_prepare`, which
takes PARENT_SIG's: no sums switch, jpsq zeroed by the caller) and the
variants of the package's own csrc/, one nvcc each, all started
together, into build/pose1_ab/, and prints their SASS opcode counts. It
then times each kernel in turns (earlier, package, package, earlier;
then the variants), checking the earlier and the package kernel against
the plain version per camera, at

  (a) venice-89: O = 557,056 slot rows, N = 89, chip_smoke.kernel_inputs
      (the problem's slot layout, seeded operands); prepare with and
      without its per-camera sums (the earlier kernel has no switch: it
      always makes them);
  (b) the camera-sorted orders: prepare and hpp_b_structured on the
      1-device mesh solver's own step-1 operands (the SPMD window order,
      598,016 lanes), the fused term on (a)'s operands with each part's
      landmarks sorted by first camera;
  (c) N = 1024 seeded cameras on the venice-89 rows, and N = 2048 for
      hpp_b_structured (its global-memory route)

((b) and (c) are chip_smoke.kernels1_shapes). `bench` prints the warm
step-1 and step-2 bench iterations (as pose2_ab's `bench`) for the
package tree in the current directory; run it in each tree to compare, for
instance `(cd DIR && PYTHONPATH=. python <repo>/povar_tpu_torch/tools/
pose1_ab.py bench)`. `psc` runs N POWER_SCHUR_COMPLEMENT step-1 solves
with the package's prepare and with the earlier one.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

OUT = Path("build") / "pose1_ab"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the earlier pose1.cu's prepare: no f64 sums buffer, no sums switch
PARENT_SIG = {"povar_prepare": [_P] * 10 + [_I, _I, _F, _F, _F, _I, _F, _F,
                                            _P]}
ENTRIES = ("povar_prepare", "povar_hpp_b", "povar_e0_term")
SASS_KERNELS = {"prepare": r"pose1_cu.*prepare_kernel",
                "hpp_b": r"pose1_cu.*hpp_b_kernel",
                "e0_term": r"pose1_cu.*e0_term_"}
# variants that concern one kernel only
PREP_ONLY = {"prep_block_acc", "prep_shared512", "prep_free_regs",
             "prep256", "prep1024", "prep_no_rw", "prep_no_scatter"}
HPP_ONLY = {"table_shared", "global_moments"}
E0_ONLY = {"block_atomics", "threads256", "threads1024"}


def variants():
    """pose2_ab's common variants of pose1.cu (no_flush also leaves out
    prepare's flush), two other routes of hpp_b_structured: the camera
    table staged in shared memory beside the accumulators
    (`table_shared`, while 64 N floats fit) and every value to a global
    atomic at every N (`global_moments`), and prepare with one shared
    accumulator per block at every N (`prep_block_acc`), with other
    block sizes (`prep_shared512`, `prep256`, `prep1024`), with the
    compiler's own register count (`prep_free_regs`), and without
    its r_w / sw stores or its sums' adds (`prep_no_rw`,
    `prep_no_scatter`: diagnostics)."""
    from povar_tpu_torch.tools import pose2_ab as ab

    common = ab.common_variants("pose1.cu",
                                r"povar::flush_acc\(acc_g, acc, [^;]+;")
    edits, threads = common["no_flush"]
    common["no_flush"] = (edits + [(
        "pose1.cu", r"if \(s != 0\.0f\) atomicAdd\(acc_g \+ i, \(double\)s\);",
        "if (s == 1.2345e-38f) acc_g[i] = s;")], threads)
    return {
        **common,
        "table_shared": ([
            ("pose1.cu", r"P\[k\] = __ldg\(ct \+ k \* n_cams \+ c\);\n"
             r"      povar::a_tilde\(P, 1, 0, u, vv,",
             "P[k] = kShared ? smem[(kMomentRows + k) * n_cams + c]"
             " : __ldg(ct + k * n_cams + c);\n"
             "      povar::a_tilde(P, 1, 0, u, vv,"),
            ("pose1.cu", r"(\n    povar::smem_zero\(acc, kMomentRows \* "
             r"n_cams\);)",
             r"\n    povar::smem_copy(smem + kMomentRows * n_cams, ct, "
             r"12 * n_cams);\1"),
            ("pose1.cu", r"moments = sizeof\(float\) \* kMomentRows \*",
             "moments = sizeof(float) * (kMomentRows + 12) *"),
        ], 512),
        "global_moments": ([("pose1.cu", r"if \(moments <= \(size_t\)"
                             r"max_optin_smem\(\)\)", "if (false)")], 512),
        "prep_block_acc": ([("pose1.cu", r"if \(kPrepThreads / 32 \* block "
                             r"<= \(size_t\)max_optin_smem\(\)\)",
                             "if (false)")], 512),
        "prep_shared512": ([("pose1.cu", r"kPrepSharedThreads = 1024",
                             "kPrepSharedThreads = 512")], 512),
        # the compiler's own register count (52 for the sums, two
        # 512-thread blocks per SM, against three)
        "prep_free_regs": ([("pose1.cu", r"__launch_bounds__\(kBlock, "
                             r"kPrepSmThreads / kBlock\)",
                             "__launch_bounds__(kBlock)")], 512),
        "prep256": ([("pose1.cu", r"kPrepThreads = 512",
                      "kPrepThreads = 256")], 512),
        "prep1024": ([("pose1.cu", r"kPrepThreads = 512",
                       "kPrepThreads = 1024")], 512),
        # diagnostics: the sums without the r_w / sw stores, the stores
        # without the sums' warp_scatter
        "prep_no_rw": ([("pose1.cu", r"      if \(kSums\) \{\n        const "
                         r"float s = sqrtf\(w\);\n.*?sw_out\[o\] = s;\n"
                         r"      \}\n", "")], 512),
        "prep_no_scatter": ([("pose1.cu", r"    if \(kSums\)\n      povar::"
                              r"warp_scatter<kJpRows, !kPrivate>\(wacc, "
                              r"n_cams, c, live, sums\);", "")], 512),
    }


def _prepare(lib):
    """The package's prepare entry point of `lib` (a variant's)."""
    from povar_tpu_torch.ops import pose_kernels as pk
    from povar_tpu_torch.ops.pose_ref import pose_consts

    def run(cam, ct, x, uv, mask, *, alpha, robust, huber, sums=True):
        c = pose_consts(alpha, torch.float32)
        o, n = cam.shape[0], ct.shape[1]
        f32 = dict(dtype=torch.float32, device=x.device)
        rw, sw = torch.empty((4, o), **f32), torch.empty((1, o), **f32)
        ata, atr = torch.empty((9, o), **f32), torch.empty((3, o), **f32)
        jpsq = torch.empty((12, n), **f32)
        acc = torch.zeros(8 * n + 1, dtype=torch.float64, device=x.device)
        rc = lib.povar_prepare(*map(pk._ptr, (
            cam, ct, x, uv, mask, rw, sw, ata, atr, jpsq, acc)), o, n, c.sp,
            c.sa, c.sp2, int(robust == 1), float(huber),
            float(huber) * float(huber), int(sums), pk._stream(x))
        assert rc == 0, rc
        return (rw, sw, ata, atr, jpsq) if sums else (None, None, ata, atr,
                                                      None)
    return run


def _parent_prepare(lib):
    """The earlier prepare: every output, whatever `sums` says."""
    from povar_tpu_torch.ops import pose_kernels as pk
    from povar_tpu_torch.ops.pose_ref import pose_consts

    def run(cam, ct, x, uv, mask, *, alpha, robust, huber, sums=True):
        c = pose_consts(alpha, torch.float32)
        o, n = cam.shape[0], ct.shape[1]
        f32 = dict(dtype=torch.float32, device=x.device)
        rw, sw = torch.empty((4, o), **f32), torch.empty((1, o), **f32)
        ata, atr = torch.empty((9, o), **f32), torch.empty((3, o), **f32)
        jpsq = torch.zeros((12, n), **f32)
        rc = lib.povar_prepare(*map(pk._ptr, (
            cam, ct, x, uv, mask, rw, sw, ata, atr, jpsq)), o, n, c.sp, c.sa,
            c.sp2, int(robust == 1), float(huber),
            float(huber) * float(huber), pk._stream(x))
        assert rc == 0, rc
        return rw, sw, ata, atr, jpsq
    return run


def _hpp(lib):
    from povar_tpu_torch.ops import pose_kernels as pk
    from povar_tpu_torch.ops.pose_ref import pose_consts

    def run(cam, ct, x, uv, sw, r_w, jls, hib, n, *, alpha):
        c = pose_consts(alpha, torch.float32)
        acc = torch.zeros(52 * n + 1, dtype=torch.float64, device=x.device)
        hpp = torch.empty((144, n), device=x.device)
        b = torch.empty((12, n), device=x.device)
        rc = lib.povar_hpp_b(*map(pk._ptr, (
            cam, ct, x, uv, sw, r_w, jls, hib,
            pk.moment_expand_table(x.device), hpp, b, acc)), cam.shape[0],
            n, c.sp, c.sa, c.sp2, pk._stream(x))
        assert rc == 0, rc
        return hpp, b
    return run


def _e0(lib, threads):
    from povar_tpu_torch.ops import pose_kernels as pk

    def run(cam, x, h, z, parts, n):
        rows, tiles = pk.tile_rows(parts, threads)
        table = torch.tensor(rows, dtype=torch.int32, device=x.device)
        out = torch.zeros((12, n), device=x.device)
        rc = lib.povar_e0_term(*map(pk._ptr, (cam, x, h, z, table, out)),
                               len(parts), tiles, cam.shape[0], n, threads,
                               pk._stream(x))
        assert rc == 0, rc
        return out
    return run


def _build_all(parent: Path, variants=None, parent_variants=None):
    from povar_tpu_torch.tools import pose2_ab as ab

    return ab.build_all(parent, "pose1.cu", OUT, variants or {},
                        parent_variants or {}, ENTRIES, PARENT_SIG,
                        SASS_KERNELS)


def kernels(parent: Path, only=None) -> None:
    import chip_smoke as cs
    from povar_tpu_torch import (SolverOptions, Stage1Solver,
                                 synthetic_bal_problem_fast)
    from povar_tpu_torch.ops import pose_kernels as pk
    from povar_tpu_torch.ops import pose_ref as pr
    from povar_tpu_torch.tools import pose2_ab as ab

    var = variants()
    libs = _build_all(parent, var,
                      {"parent_no_atomics": [("pose1.cu", *ab.NO_ATOMICS)]})
    problem = synthetic_bal_problem_fast(cs.N_CAMS, cs.N_LMS, cs.OBS_PER_LM,
                                         seed=0)
    opts = SolverOptions()
    solver = cs.stage_solver(Stage1Solver, problem, opts)
    d = cs.kernel_inputs(solver, problem)
    parts = solver.e0_plan.parts
    a = dict(alpha=opts.alpha)
    shapes = [
        ("prepare", "(a) venice-89",
         tuple(d[k] for k in ("cam", "ct", "x", "uv", "mask")),
         dict(a, robust=0, huber=1.0)),
        ("hpp_b_structured", "(a) venice-89",
         tuple(d[k] for k in ("cam", "ct", "x", "uv", "sw", "r_w", "jls",
                              "hib")) + (solver.n_cams,), a),
        ("e0_term_parts", "(a) venice-89",
         tuple(d[k] for k in ("cam", "x", "h", "z")) + (parts,
                                                        solver.n_cams), {}),
    ] + [(k, label, args, kw) for k, label, args, kw, *_rest in
         cs.kernels1_shapes(problem, solver, d, opts.alpha)]
    shapes.sort(key=lambda s: s[0])
    impls = {
        "prepare": {"parent": _parent_prepare(libs["parent"]),
                    "package": pk.prepare},
        "hpp_b_structured": {"parent": _hpp(libs["parent"]),
                             "package": pk.hpp_b_structured},
        "e0_term_parts": {"parent": _e0(libs["parent"], 512),
                          "package": pk.e0_term_parts},
    }
    timed = {
        "prepare": {
            "parent_no_atomics": _parent_prepare(libs["parent_no_atomics"]),
            **{n: _prepare(libs[n]) for n in var
               if n not in HPP_ONLY | E0_ONLY}},
        "hpp_b_structured": {
            "parent_no_atomics": _hpp(libs["parent_no_atomics"]),
            **{n: _hpp(libs[n]) for n in var if n not in E0_ONLY | PREP_ONLY}},
        "e0_term_parts": {
            "parent_no_atomics": _e0(libs["parent_no_atomics"], 512),
            **{n: _e0(libs[n], t) for n, (_e, t) in var.items()
               if n not in HPP_ONLY | PREP_ONLY}},
    }
    print(f"fused-term parts {parts}", flush=True)
    ab.ab_time([x for x in shapes if only is None or x[0] in only], impls,
               timed, pr)


def psc(parent: Path, runs: int) -> None:
    """`runs` venice-89 POWER_SCHUR_COMPLEMENT step-1 solves
    (step2_spread.step1_spread) with the package's prepare and with the
    earlier one, and the solve in f64 through the plain versions once:
    per kernel the runs past PSC_BAND, the power-term counts of trials
    30-31 and the first trial's cost against f64's."""
    import chip_smoke as cs
    from collections import Counter
    from povar_tpu_torch import synthetic_bal_problem_fast
    from povar_tpu_torch.ops import pose_kernels as pk
    from povar_tpu_torch.options import SolverType
    from povar_tpu_torch.tools.step2_spread import JAX_PSC_COST, step1_spread

    libs = _build_all(parent)
    problem = synthetic_bal_problem_fast(cs.N_CAMS, cs.N_LMS, cs.OBS_PER_LM,
                                         seed=0)
    solver = SolverType.POWER_SCHUR_COMPLEMENT
    first = step1_spread(problem, 1, solver, f64=True)[0]["costs"][1]
    own = pk.prepare
    for who, fn in (("package", own),
                    ("parent", _parent_prepare(libs["parent"]))):
        try:
            pk.prepare = fn
            recs = step1_spread(problem, runs, solver)
        finally:
            pk.prepare = own
        dev = sorted(r["costs"][1] / first - 1.0 for r in recs)
        print(f"psc prepare {who}: "
              f"{sum(r['final'] > 1.001 * JAX_PSC_COST for r in recs)} "
              f"of {runs} past the band, trials 30-31 "
              f"{dict(Counter(tuple(r['terms'][29:31]) for r in recs))}, "
              f"first trial against f64 {dev[0]:+.2e} .. {dev[-1]:+.2e} "
              f"(median {dev[len(dev) // 2]:+.2e})", flush=True)


def bench() -> None:
    """pose2_ab.bench's iterations, in this file so that running it as a
    script in an earlier tree (whose pose2_ab may print less) prints
    them too."""
    import chip_smoke as cs
    from povar_tpu_torch import SolverOptions, synthetic_bal_problem_fast

    problem = synthetic_bal_problem_fast(cs.N_CAMS, cs.N_LMS, cs.OBS_PER_LM,
                                         seed=0)
    opts = SolverOptions()
    for step, label in ((cs.bench_step1, "step-1"), (cs.bench_step2,
                                                     "step-2")):
        step(problem, opts, f"{label} defaults")
        step(problem, opts, f"{label} spmd (1-device mesh)", mesh=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    k = sub.add_parser("kernels")
    k.add_argument("--parent", type=Path, required=True,
                   help="directory with the earlier pose1.cu and "
                   "pose_common.cuh")
    k.add_argument("--kernels", nargs="+", default=None,
                   help="time only these kernels (default: all)")
    sub.add_parser("bench")
    q = sub.add_parser("psc")
    q.add_argument("--parent", type=Path, required=True)
    q.add_argument("--runs", type=int, default=16)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pose1_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path.cwd()))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if args.mode == "kernels":
        kernels(args.parent, args.kernels)
    elif args.mode == "psc":
        psc(args.parent, args.runs)
    else:
        bench()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The camera-table kernels (csrc/cam.cu) against an earlier version of
their kernels and against controlled variants of their own, on one card;
the warm bench iterations with `cam_gather`'s host cost; the spreads of
the solves these kernels' rounding can move; and the launches of
`cam_scatter_add` by row count in one solve.

    python -m povar_tpu_torch.tools.cam_ab kernels --parent DIR
        [--kernels cam_scatter_add e0_scatter hpp_b]
    python -m povar_tpu_torch.tools.cam_ab kernels --parent DIR --same-sig
        --kernels cam_gather hpp_b_f64 [--variants NAME ...]
    python -m povar_tpu_torch.tools.cam_ab bench
    python -m povar_tpu_torch.tools.cam_ab spread [--chol 16] [--off 8]
    python -m povar_tpu_torch.tools.cam_ab launches

Run from the repository root (`chip_smoke.py` lends its timers and its
bench iteration). `kernels` builds DIR/cam.cu with DIR/pose_common.cuh
(an earlier commit's csrc/, whose `povar_cam_scatter_add`,
`povar_cam_e0_scatter` and `povar_cam_hpp_b` take PARENT_SIG's
arguments: no sums buffer, outputs zeroed by the caller) and the
VARIANTS of the package's own csrc/ that concern the kernels asked for,
one nvcc each, all started together, into build/cam_ab/, and prints
their registers and the SASS opcode counts of every instantiation
(atomics, shuffles, local-memory loads and stores). It then checks the
earlier and the package kernel against the plain version per camera
(1e-4) and times each in turns (earlier, package, package, earlier; then
the variants) at the Jacobi norms' and both Schur corrections' row
counts (R = 12, 144, 121) and both steps' shapes ((dl, dc) = (3, 12) /
(3, 11); (k, d) = (4, 12) / (2, 11)) on seeded operands zeroed on the
slot pad rows, at

  (a) venice-89: O = 557,056 slot rows of synthetic_bal_problem_fast(89,
      110973, 5), N = 89;
  (b) the same rows sorted by camera (every warp on one camera);
  (c) N = 1024 seeded cameras on (a)'s rows,

and prints whether each result's hpp is symmetric bit for bit. Device
time is the profiler's, every device operation of a call included (the
earlier wrapper's zeroing of its outputs too), mean of 20 calls; event
time the median of 20 (tools/pose2_ab.py's `ab_time`).

With `--same-sig` (a parent whose entry points take the package's
arguments, 4a2a9d4 and later) `kernels` first compares `cam_gather` in
f32 and f64 at R = 12 and 132 (beside `index_select`) and `hpp_b`'s f64
instantiation at both shapes (`--kernels cam_gather hpp_b_f64`), parent
and package alternating, on (a)-(c) and on (d) N = 32 seeded cameras,
each result checked (the gathers bit for bit, the sums within 1e-12 per
camera with hpp symmetric bit for bit) and timed three ways: CUDA events
around 50 back-to-back calls per call ("loop"; the gathers through their
bare C entry points into preallocated outputs, `index_select` with
`out=`, so that a call's host cost hides behind the device's), the
profiler's device time with the number of device operations it recorded
("device"; fewer than the calls: it dropped some), and events around
single calls each after a 256 MB write ("cold": nothing of the call in
L2); with the registers and spills of every instantiation.

`bench` prints, for the package tree in the current directory:
`cam_gather`'s event and device time at venice-89 ([12, 89] table) beside
`index_select`'s, and its host time per call (enqueue only, mean of 2000
calls) for the wrapper, for the bare C entry point through ctypes, for a
ctypes call that does nothing on the card (`povar_error_string`) and
for `index_select`; then chip_smoke's warm step-1 and step-2 bench
iterations with pallas_kernels="off", with SolverOptions() defaults and
in pure f64 (`mixed_precision_solves=False`) (launches, wall time,
device time and device operations per iteration).
Run it in each tree to compare, for instance `(cd DIR && PYTHONPATH=.
python <repo>/povar_tpu_torch/tools/cam_ab.py bench)`.

`launches` runs one venice-89 `bundle_adjust` with pallas_kernels="off",
PCG and RIPCG (the one path that runs the Schur corrections through
`cam_scatter_add`) and prints the launches of `cam_scatter_add` by row
count and every kernel's launches.

`spread` runs `--chol` venice-89 CHOLESKY step-1 solves
(tools/step2_spread.step1_spread) and counts those outside chip_smoke.py's
bands (the first trial within CHOL_FIRST_TOL of CHOL_FIRST, the first
CHOL_SAME trials accepted, the final cost within CHOL_BAND x JAX's), then
`--off` step-1 solves with pallas_kernels="off" (outside: a final cost
more than 1e-3 relative from JAX_FINAL_COST), then chip_smoke's
`check_layouts` once on a defaults step-1 result. It too runs in either
tree.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

OUT = Path("build") / "cam_ab"
_P, _I = ctypes.c_void_p, ctypes.c_int
# the earlier cam.cu's entry points: no sums buffer (cam_scatter_add:
# the rows a block stages, as `cam_kernels._rows_per_block` gives them)
PARENT_SIG = {"povar_cam_scatter_add": [_P] * 3 + [_I] * 4 + [_P],
              "povar_cam_e0_scatter": [_P] * 4 + [_I] * 4 + [_P],
              "povar_cam_hpp_b": [_P] * 5 + [_I] * 4 + [_P]}
ENTRIES = tuple(PARENT_SIG)
# SASS opcode counts per instantiation: route 0 / 1 / 2 is the per-warp,
# shared and global route of csrc/cam.cu (the earlier kernels: shared
# accumulators, then global ones). The package's kernels take their value
# type first (`If` f32, `Id` f64 in the mangled name; an earlier cam.cu's
# have none and are f32), so the f32 labels match both trees' f32 code
# and the f64 instantiations count apart.
SASS_KERNELS = {
    **{f"cam_scatter_add<{k}> route {r}":
       rf"cam_cu.*cam_scatter_add_kernelIf?Li{k}E.*RouteE{r}E"
       for k in (12, 11, 1) for r in range(3)},
    **{f"e0_scatter<{dc}> route {r}":
       rf"cam_cu.*e0_scatter_kernelIf?Li{dc}E.*RouteE{r}E"
       for dc in (12, 11) for r in range(3)},
    **{f"hpp_b<{k},{d}> route {r}":
       rf"cam_cu.*hpp_b_kernelIf?Li{k}ELi{d}E.*RouteE{r}E"
       for k, d in ((4, 12), (2, 11)) for r in range(3)},
    **{f"cam_gather<{v}, {k}>": rf"cam_cu.*cam_gather_kernelI{v}Li{k}E"
       for v, k in (("f", 4), ("f", 1), ("d", 2), ("d", 1))},
    "cam_gather": r"cam_cu.*cam_gather_kernel(IfEEv|E)PKi",
    "e0_u": r"cam_cu.*e0_u_kernel(IfEEv|E)PKi",
    **{f"hpp_b f64<{k},{d}> route {r}":
       rf"cam_cu.*hpp_b_kernelIdLi{k}ELi{d}E.*RouteE{r}E"
       for k, d in ((4, 12), (2, 11)) for r in range(3)},
    **{f"hpp_b f64<{k},{d}> value groups":
       rf"cam_cu.*hpp_b_groups_kernelILi{k}ELi{d}E"
       for k, d in ((4, 12), (2, 11))},
    **{f"{name} f64": rf"cam_cu.*{name}_kernelId"
       for name in ("cam_scatter_add", "e0_scatter", "cam_gather", "e0_u")},
    "cam_scatter_add (earlier)": r"cam_cu.*cam_scatter_add_kernel",
    "e0_scatter (earlier)": r"cam_cu.*e0_scatter_kernel",
    "hpp_b (earlier)": r"cam_cu.*hpp_b_kernel",
}
# warp_scatter_rows's sum as a pairwise tree over the peers' ranks: in
# step d = 1, 2, 4, ... the lane of rank r, a multiple of 2 d, adds the
# value of rank r + d (log2 of the group's size steps, not size - 1);
# p.rest then holds the whole group in every live lane
TREE_WALK = """  const int rank = __popc(p.rest & ((1u << lane) - 1u));
  const int size = __popc(p.rest);
  const unsigned above = p.rest & ~((2u << lane) - 1u);
  for (int d = 1; d < 32; d <<= 1) {
    const bool take = rank % (2 * d) == 0 && rank + d < size;
    if (!__any_sync(kFullMask, take)) break;
    unsigned m = above;
    for (int i = 1; take && i < d; ++i) m &= m - 1u;
    const int src = take ? __ffs(m) - 1 : lane;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const V t = __shfl_sync(kFullMask, v[k], src);
      if (take) v[k] += t;
    }
  }
"""
# hpp_b's launch: the fewest warps a block of private copies may have (f32)
HPP_MIN_WARPS = r"(kF64 \? kHppWarps : )4,"
# the copies the f32 hpp_b's flush sums before each f64 atomic
HPP_GROUP = r"kGroup = 2;"


def _sum_type(values: str, was: str, group: str, now: str):
    """The edits that make a kernel's blocks meet in `now` atomics, not
    `was` ones: its add_rows<`values`, R, was> calls, its block_sums_done
    (copies in groups of `group`) and its drain_sums."""
    return [("cam.cu", rf"add_rows<{values}, R, {was}>",
             f"add_rows<{values}, R, {now}>"),
            ("cam.cu", rf"block_sums_done<R, {was}, {group}>",
             f"block_sums_done<R, {now}, {group}>"),
            ("cam.cu", rf"drain_sums<{was}>\(acc_g, n_acc,(\s+)\[&\]\(int i, "
             rf"{was} s\)", rf"drain_sums<{now}>(acc_g, n_acc,\1[&](int i, "
             rf"{now} s)")]


# edits of the package's csrc/ (file, regex, replacement) and the kernels
# they concern; every variant keeps the results right unless named so
VARIANTS = {
    # hpp_b as one shared copy per 512-thread block at N = 89 (shared
    # atomics, the lanes on one camera summed first)
    "hpp_shared1": ([("cam.cu", HPP_MIN_WARPS, r"\g<1>33,"),
                     ("pose_common.cuh", r"const int k = std::min\(fit, "
                      r"shared_threads / 32\);", "const int k = 1;")],
                    "hpp_b"),
    # ... and on as many shared copies as fit (7 at (4, 12))
    "hpp_shared_copies": ([("cam.cu", HPP_MIN_WARPS, r"\g<1>33,")],
                          "hpp_b"),
    # the private route's sums in chunks of 15 / 11 values (one chunk of
    # 90 / 77 by default), and without its loads of the next row
    "hpp_chunked": ([("cam.cu", r"kChunk = R == Route::kPrivate && kF32",
                      "kChunk = false && kF32")], "hpp_b"),
    "hpp_no_prefetch": ([("cam.cu", r"constexpr bool kPrefetch = R == "
                          r"Route::kPrivate && kF32;",
                          "constexpr bool kPrefetch = false;")], "hpp_b"),
    # private copies for 4 warps per block (8 by default)
    "hpp_warps4": ([("cam.cu", r"constexpr int kHppWarps = 8;",
                     "constexpr int kHppWarps = 4;")], "hpp_b"),
    # private copies in blocks of 2 warps (3 blocks an SM: 396 blocks'
    # partials meet, not 132)
    "hpp_warps2": ([("cam.cu", r"constexpr int kHppWarps = 8;",
                     "constexpr int kHppWarps = 2;"),
                    ("cam.cu", HPP_MIN_WARPS, r"\g<1>2,")], "hpp_b"),
    # private copies in blocks of 3 warps (2 blocks an SM at (4, 12))
    "hpp_warps3": ([("cam.cu", r"constexpr int kHppWarps = 8;",
                     "constexpr int kHppWarps = 3;"),
                    ("cam.cu", HPP_MIN_WARPS, r"\g<1>3,")], "hpp_b"),
    # a hpp_b block's copies summed before its flush (one atomic an entry;
    # in pairs by default, f32), or each flushed on its own
    "flush_summed": ([("cam.cu", HPP_GROUP, "kGroup = 32;")], "hpp_b"),
    "warp_flush": ([("cam.cu", HPP_GROUP, "kGroup = 1;")], "hpp_b"),
    # every value straight to a global atomic at every N
    "hpp_global": ([("cam.cu", HPP_MIN_WARPS, r"\g<1>33,"),
                    ("pose_common.cuh", r"if \(fit >= 1\) \{",
                     "if (fit >= 1 && shared_threads != 512) {")], "hpp_b"),
    # the blocks' sums meeting in f64 (hpp_b) or f32 (e0_scatter) atomics
    "hpp_f64_sums": ([("cam.cu", r"using type = float;",
                       "using type = double;")], "hpp_b"),
    "e0_f32_sums": (_sum_type("kV", "double", "32", "float"), "e0_scatter"),
    # e0_scatter on one shared copy per 1024-thread block at N = 89
    "e0_shared1": ([("cam.cu", r"sums_plan\(dc, n_cams, kE0sWarps, "
                     r"kE0sWarps,", "sums_plan(dc, n_cams, kE0sWarps, 33,"),
                    ("pose_common.cuh", r"const int k = std::min\(fit, "
                     r"shared_threads / 32\);", "const int k = 1;")],
                   "e0_scatter"),
    # e0_scatter's private copies in 256-thread blocks
    "e0_warps8": ([("cam.cu", r"constexpr int kE0sWarps = 16;",
                    "constexpr int kE0sWarps = 8;")], "e0_scatter"),
    # the blocks' partials in fixed order: each block writes its sums
    # (f32) to its own row of the buffer and the last block adds the rows
    # in block order, in f32 (the buffer: grid x count floats, then the
    # ticket; bit-reproducible)
    "e0_fixed_order": ([("pose_common.cuh",
                         r"      if \(s != 0\.0f\) atomicAdd\("
                         r"sums \+ i, \(T\)s\);",
                         "      reinterpret_cast<float*>(acc_g)"
                         "[blockIdx.x * count + i] = s;"),
                        ("pose_common.cuh", r"return last_block\(ticket_of\("
                         r"acc_g, count\)\);",
                         "return povar::last_block(reinterpret_cast<"
                         "unsigned*>(reinterpret_cast<float*>(acc_g) + "
                         "gridDim.x * count));"),
                        ("cam.cu", r"  drain_sums<double>\(acc_g, n_acc,\s+"
                         r"\[&\]\(int i, double s\) \{ out\[i\] = "
                         r"\(V\)s; \}\);",
                         "  const float* part = reinterpret_cast<const "
                         "float*>(acc_g);\n"
                         "  for (int i = threadIdx.x; i < n_acc; i += "
                         "blockDim.x) {\n"
                         "    float s = __ldcg(part + i);\n"
                         "    for (int k = 1; k < gridDim.x; ++k) s += "
                         "__ldcg(part + k * n_acc + i);\n"
                         "    out[i] = s;\n  }\n"
                         "  if (threadIdx.x == 0) *reinterpret_cast<"
                         "unsigned*>(reinterpret_cast<float*>(acc_g) + "
                         "gridDim.x * n_acc) = 0u;")], "e0_scatter"),
    # the lanes on one camera summed as a pairwise tree (lane order by
    # default)
    "tree_walk": ([("pose_common.cuh", r"return \{lead \? peers & "
                    r"\(peers - 1u\) : 0u, lead\};",
                    "return {live ? peers : 0u, lead};"),
                   ("pose_common.cuh", r"  unsigned rest = p\.rest;\n.*?"
                    r"rest &= rest - 1u;\n  \}\n", TREE_WALK)], None),
    # diagnostics, wrong sums: the per-camera adds made dead stores, and
    # the blocks' flush left out
    "no_adds": ([("pose_common.cuh", r"atomicAdd\(&acc\[k \* n \+ c\], "
                  r"\(T\)v\[k\]\);\n      else\n        acc\[k \* n \+ c\] "
                  r"\+= v\[k\];",
                  "{ if (v[k] == 1.2345e-38f) acc[k * n + c] = v[k]; }\n"
                  "      else if (v[k] == 1.2345e-38f) acc[k * n + c] = "
                  "v[k];")], None),
    # every lane its own peer group: no walk (the private copies' plain
    # adds then race: wrong sums)
    "no_walk": ([("pose_common.cuh", r"__match_any_sync\(kFullMask, live "
                  r"\? c : -1\)", "(1u << lane)")], None),
    "no_flush": ([("pose_common.cuh",
                   r"if \(s != 0\.0f\) atomicAdd\(sums \+ i, "
                   r"\(T\)s\);", "if (s == 1.2345e-38f) sums[i] = (T)s;")],
                 None),
}
# cam_scatter_add (C2) with one design choice changed: all R rows of a
# row in one group through one match (chunks of 12 or 11 values, on the
# shared copies a [144, N] group needs), the blocks' sums meeting in f32,
# their f64 flush as returning atomics (atomicAdd, ATOMG; reductions by
# default), private copies for 4 warps where 16 do not fit (N = 1024: 4
# copies in 128-thread blocks), 8 or 32 private copies a block (256- or
# 1024-thread blocks), the private route's registers bounded for one or
# three blocks an SM (two by default), 16 L2 reads in flight per
# thread in the last block's drain (8 by default), the lane-order walk
# also where a warp sits on one camera (no reduce-scatter tree), global
# atomics at every N; and, wrong sums by design (timed only), the loads
# alone, the peers matched but not walked (each lead adds its own
# values), no flush of the copies, the flush without the last block, and
# the pass without its tail
_C2_SUM = ("cam.cu", r"using C2Sum = double;", "using C2Sum = float;")


def _c2_min_blocks(blocks: int):
    return ("cam.cu", r"constexpr int kC2MinBlocks = \d;",
            f"constexpr int kC2MinBlocks = {blocks};")


C2_VARIANTS = {
    "c2_rows_whole": [("cam.cu", r"n_rows, 1[12], stream\)",
                       "n_rows, n_rows, stream)")],
    "c2_f32_sums": [_C2_SUM],
    "c2_atomic_flush": [("cam.cu", r"const size_t g = __cvta_generic_to_"
                         r"global\(p\);\n  asm volatile\(.*?\);",
                         "atomicAdd(p, v);")],
    "c2_private4": [("cam.cu", r"kC2MinWarps = 16;", "kC2MinWarps = 4;")],
    "c2_warps8": [("cam.cu", r"kC2Warps = 16;", "kC2Warps = 8;"),
                  ("cam.cu", r"kC2MinWarps = 16;", "kC2MinWarps = 8;")],
    "c2_warps32": [("cam.cu", r"kC2Warps = 16;", "kC2Warps = 32;"),
                   ("cam.cu", r"kC2MinWarps = 16;", "kC2MinWarps = 32;"),
                   _c2_min_blocks(1)],
    "c2_lb1": [_c2_min_blocks(1)],
    "c2_lb3": [_c2_min_blocks(3)],
    "c2_drain16": [("cam.cu", r"constexpr int kC2Drain = 8;",
                    "constexpr int kC2Drain = 16;")],
    "c2_walk_only": [("cam.cu", r"const bool tree = __popc",
                      "const bool tree = false && __popc")],
    "c2_global": [("cam.cu", r"(kC2StaticSmem, sizeof\(V\)\);)",
                   "\\1\n  p = {Route::kGlobal, kC2SharedThreads, 1, 0};"),
                  ("cam.cu", r"const SumsPlan p =(\s+sums_plan\(group)",
                   r"SumsPlan p =\1")],
    "c2_loads_only": [("cam.cu", r"(\n    load\(0\);)",
                       "\\1\n    {\n      float q_ = 0.0f;\n"
                       "      for (int k = 0; k < K; ++k) q_ += x[k];\n"
                       "      if (q_ == 1.2345e-38f) acc_g[0] = 1.0;\n"
                       "      continue;\n    }")],
    "c2_match_only": [("pose_common.cuh", r"return \{lead \? peers & "
                       r"\(peers - 1u\) : 0u, lead\};",
                       "return {0u, lead};")],
    "c2_no_flush": [("cam.cu", r"if \(s != 0\.0f\) c2_red\(",
                     "if (s == 1.2345e-38f) c2_red(")],
    "c2_no_last": [("cam.cu", r"(\n  V\* rows = out \+ \(size_t\)r0 "
                    r"\* n_cams;)", "\n  return;\\1")],
    "c2_no_tail": [("cam.cu", r"(\n  if \(R != Route::kGlobal\) \{\n    "
                    r"// the block's copies)", "\n  return;\\1")],
}
VARIANTS.update({name: (edits, "cam_scatter_add")
                 for name, edits in C2_VARIANTS.items()})
# cam_gather (both types) with one design choice changed: 512-thread
# blocks (1024 by default), one observation a thread in f32 (four by
# default: 16-byte stores), one in f64 (two), the row loop not unrolled
# (4 rows by default); the f64 hpp_b's value groups with registers
# bounded for three blocks an SM at (4, 12) too (two by default); and,
# wrong sums by design (timed only), its tiles staged but not summed, and
# its pass without the flush of its copy
VARIANTS.update({
    "gather_threads512": ([("cam.cu", r"kGatherThreads = 1024;",
                            "kGatherThreads = 512;")], "cam_gather"),
    "gather_f32_scalar": ([("cam.cu", r"sizeof\(float\) \? 4 : 2;",
                            "sizeof(float) ? 1 : 2;")], "cam_gather"),
    "gather_f64_scalar": ([("cam.cu", r"sizeof\(float\) \? 4 : 2;",
                            "sizeof(float) ? 4 : 1;")], "cam_gather"),
    "gather_unroll1": ([("cam.cu", r"#pragma unroll 4(\n    for \(int r = 0)",
                         r"#pragma unroll 1\1")], "cam_gather"),
    "hpp64_blocks3": ([("cam.cu", r"return K \* D > 24 \? 2 : 3;",
                        "return 3;")], "hpp_b_f64"),
    "hpp64_stage_only": ([("cam.cu", r"    hpp_group_warp<K, D>\(warp, tile, "
                           r"acc, n_cams\);",
                           "    if (tile.rows[lane] == 1.2345e-300) acc[lane] "
                           "= tile.rows[32 + lane];")], "hpp_b_f64"),
    "hpp64_no_flush": ([("cam.cu", r"(    )(c2_red\(acc_g \+ hpp_group_row)",
                         r"\1if (s == 1.2345e-300) \2")], "hpp_b_f64"),
})
# the variants that give wrong sums by design (timed only)
DIAGNOSTIC = {"no_adds", "no_walk", "no_flush", "c2_loads_only",
              "c2_match_only", "c2_no_flush", "c2_no_last", "c2_no_tail",
              "hpp64_stage_only", "hpp64_no_flush"}
# floats per block row of the fixed-order variant's buffer: the most
# blocks any route launches (132 SMs x 3 blocks) times dc N at N = 1024
FIXED_ORDER_FLOATS = 132 * 3 * 12 * 1024 + 2


def _parent_c2(lib):
    from povar_tpu_torch.ops.cam_kernels import _rows_per_block
    from povar_tpu_torch.ops.pose_kernels import _ptr, _stream

    def run(v, cam, n):
        r, o = v.shape
        out = torch.zeros((r, n), device=v.device)
        rc = lib.povar_cam_scatter_add(_ptr(cam), _ptr(v), _ptr(out), o, n,
                                       r, _rows_per_block(r, n), _stream(v))
        assert rc == 0, rc
        return out
    return run


def _variant_c2(lib):
    """The package's cam_scatter_add entry point of `lib` with a sums
    buffer of its own (pose2_ab.own_scratch)."""
    from povar_tpu_torch.ops.pose_kernels import _ptr, _stream
    from povar_tpu_torch.tools.pose2_ab import own_scratch

    sums = own_scratch()

    def run(v, cam, n):
        r, o = v.shape
        out = torch.empty((r, n), device=v.device)
        rc = lib.povar_cam_scatter_add(_ptr(cam), _ptr(v), _ptr(out),
                                       _ptr(sums(r * (n + 1), v.device)), o,
                                       n, r, _stream(v))
        assert rc == 0, rc
        return out
    return run


def _parent_e0(lib):
    from povar_tpu_torch.ops.pose_kernels import _ptr, _stream

    def run(W, cam, sb, n):
        dl, o = sb.shape[0], cam.shape[0]
        dc = W.shape[0] // dl
        out = torch.zeros((dc, n), device=W.device)
        rc = lib.povar_cam_e0_scatter(_ptr(cam), _ptr(W), _ptr(sb),
                                      _ptr(out), o, n, dl, dc, _stream(W))
        assert rc == 0, rc
        return out
    return run


def _parent_hpp(lib):
    from povar_tpu_torch.ops.pose_kernels import _ptr, _stream

    def run(Jp, rt, cam, n):
        k, o = rt.shape
        d = Jp.shape[0] // k
        hpp = torch.zeros((d * d, n), device=Jp.device)
        b = torch.zeros((d, n), device=Jp.device)
        rc = lib.povar_cam_hpp_b(_ptr(cam), _ptr(Jp), _ptr(rt), _ptr(hpp),
                                 _ptr(b), o, n, k, d, _stream(Jp))
        assert rc == 0, rc
        return hpp, b
    return run


def _variant_e0(lib, floats=None):
    """The package's e0_scatter entry point of `lib` with a sums buffer
    of its own per shape (zeroed once: every call leaves it zeroed, or,
    in a variant that gives wrong sums, as that variant leaves it);
    `floats`: the buffer's size in floats (default: the package's)."""
    from povar_tpu_torch.ops.pose_kernels import _ptr, _stream

    scratch = {}

    def run(W, cam, sb, n):
        dl, o = sb.shape[0], cam.shape[0]
        dc = W.shape[0] // dl
        size = floats // 2 + 1 if floats else dc * n + 1
        if (dc, n) not in scratch:
            scratch[dc, n] = torch.zeros(size, dtype=torch.float64,
                                         device=W.device)
        out = torch.empty((dc, n), device=W.device)
        rc = lib.povar_cam_e0_scatter(_ptr(cam), _ptr(W), _ptr(sb),
                                      _ptr(out), _ptr(scratch[dc, n]), o, n,
                                      dl, dc, _stream(W))
        assert rc == 0, rc
        return out
    return run


def _variant_hpp(lib):
    from povar_tpu_torch.ops.pose_kernels import _ptr, _stream

    scratch = {}

    def run(Jp, rt, cam, n):
        k, o = rt.shape
        d = Jp.shape[0] // k
        size = (d + d * (d + 1) // 2) * n + 1
        if scratch.get("n", 0) < size:
            scratch.update(n=size, buf=torch.zeros(size, dtype=torch.float64,
                                                   device=Jp.device))
        hpp = torch.empty((d * d, n), device=Jp.device)
        b = torch.empty((d, n), device=Jp.device)
        rc = lib.povar_cam_hpp_b(_ptr(cam), _ptr(Jp), _ptr(rt), _ptr(hpp),
                                 _ptr(b), _ptr(scratch["buf"]), o, n, k, d,
                                 _stream(Jp))
        assert rc == 0, rc
        return hpp, b
    return run


def _same_sig(lib, name):
    """The package's wrapper `name` (ops/cam_kernels.py) launching `lib`'s
    entry point instead of the package's: an earlier cam.cu whose entry
    points take the package's arguments (`kernels --same-sig`)."""
    from povar_tpu_torch.ops import _build
    from povar_tpu_torch.ops import cam_kernels as ck

    for k, argtypes in _build.SIGNATURES.items():
        if k.startswith("povar_cam_") and hasattr(lib, k):
            getattr(lib, k).argtypes = argtypes
            getattr(lib, k).restype = ctypes.c_int

    def run(*args):
        package = _build.library
        _build.library = lambda: lib
        try:
            return getattr(ck, name)(*args)
        finally:
            _build.library = package
    return run


def _operands():
    """cam and the live-row mask of the venice-89 slot layout
    (chip_smoke.py's problem and Stage1Solver)."""
    import chip_smoke as cs
    from povar_tpu_torch import (SolverOptions, Stage1Solver,
                                 synthetic_bal_problem_fast)

    problem = synthetic_bal_problem_fast(cs.N_CAMS, cs.N_LMS, cs.OBS_PER_LM,
                                         seed=0)
    s = Stage1Solver(problem.obs_cam, problem.obs_lm, problem.obs_uv,
                     problem.num_cameras, problem.num_landmarks,
                     SolverOptions(), device="cuda")
    return s.obs.cam, s._mask1, s.n_cams


def _shapes(cam, mask, n):
    """(kernel, label, args, {}) at (a)-(c) and both steps' shapes."""
    rng = np.random.default_rng(2)
    o = cam.shape[0]

    def f32(rows):
        return torch.as_tensor(rng.standard_normal((rows, o)),
                               dtype=torch.float32, device="cuda") * mask

    ops = {"cam_gather": [(None, None, "R = 12")],
           "e0_u": [(f32(3 * dc), None, f"(dl, dc) = (3, {dc})")
                    for dc in (12, 11)],
           "cam_scatter_add": [(f32(r), None, f"R = {r}")
                               for r in (12, 144, 121)],
           "e0_scatter": [(f32(3 * dc), f32(3), f"(dl, dc) = (3, {dc})")
                          for dc in (12, 11)],
           "hpp_b": [(f32(k * d), f32(k), f"(k, d) = ({k}, {d})")
                     for k, d in ((4, 12), (2, 11))]}
    by_cam = torch.argsort(cam.long(), stable=True)
    cam_big = torch.as_tensor(rng.integers(0, 1024, o).astype(np.int32),
                              device="cuda")
    shapes = []
    for kernel, cases in ops.items():
        for x, y, tag in cases:
            for label, c, rows, nc in (
                    ("(a) venice-89", cam, None, n),
                    ("(b) sorted by camera", cam[by_cam], by_cam, n),
                    ("(c) N = 1024", cam_big, None, 1024)):
                xs, ys = ((x, y) if rows is None else tuple(
                    None if t is None else t[:, rows].contiguous()
                    for t in (x, y)))
                table = torch.as_tensor(rng.standard_normal(
                    (12 if xs is None else xs.shape[0] // 3, nc)),
                    dtype=torch.float32, device="cuda")
                args = {"cam_gather": (table, c),
                        "e0_u": (xs, c, table),
                        "cam_scatter_add": (xs, c, nc),
                        "e0_scatter": (xs, c, ys, nc)}.get(kernel,
                                                           (xs, ys, c, nc))
                shapes.append((kernel, f"{label}, {tag}", args, {}))
    return shapes


def registers(logs, kernel="cam_scatter_add_kernel") -> None:
    """Registers and spill bytes of every instantiation of `kernel` in
    each of `logs` ({name: nvcc output with -Xptxas -v})."""
    for name, log in logs.items():
        fn, out = None, []
        for ln in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                fn = m.group(1)
                continue
            if not fn or kernel not in fn:
                continue
            tag = fn.split(kernel, 1)[1][:40]  # its template arguments
            sp = re.search(r"(\d+) bytes spill stores", ln)
            if sp:
                out.append(f"{tag} spills {sp.group(1)} B")
            rg = re.search(r"Used (\d+) registers", ln)
            if rg:
                out.append(f"{tag} {rg.group(1)} registers")
                fn = None
        print(f"registers {kernel} {name}: {'; '.join(out)}", flush=True)


# bytes written between the calls of the cold-L2 timer: past the card's
# 50 MB L2, so that neither the operands nor the last call's output stay
# in it, and long enough (~80 us) to hide the next call's host cost
FLUSH_BYTES = 256 << 20
TIMED_CALLS = 20


def loop_us(fn, calls: int = 50, loops: int = 5) -> float:
    """Time a call as CUDA events around `calls` back-to-back calls
    (the host's cost of a call hidden where it is below the device's),
    per call, median of `loops` loops, in microseconds."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(loops):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / calls)
    return statistics.median(times)


def profiled(fn, reps: int = TIMED_CALLS):
    """(device time a call: the profiler's summed durations of every
    device operation over `reps` calls, over `reps`; the number of device
    operations it recorded) in microseconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ops = [e.time_range.elapsed_us() for e in prof.events()
           if e.device_type == DeviceType.CUDA]
    return sum(ops) / reps, len(ops)


def cold_us(fn, reps: int = TIMED_CALLS) -> float:
    """CUDA events around each of `reps` calls, each after a write of
    FLUSH_BYTES (a cold L2), median, in microseconds."""
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    fn()
    torch.cuda.synchronize()
    pairs = []
    for i in range(reps):
        flush.fill_(float(i))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) * 1e3 for s, e in pairs)


def timers(fn) -> str:
    """The three timers of one call of `fn` (a call of one device
    operation: the profiler should record TIMED_CALLS)."""
    dev, ops = profiled(fn)
    return (f"loop {loop_us(fn):.1f} us, device {dev:.1f} us ({ops} of "
            f"{TIMED_CALLS} operations recorded), cold {cold_us(fn):.1f} us")


def _layouts(cam, n):
    """(label, cam, the rows' order or None, N): (a) venice-89, (b) its
    rows sorted by camera, (c) N = 1024 and (d) N = 32 seeded cameras on
    (a)'s rows."""
    rng = np.random.default_rng(4)
    o = cam.shape[0]
    by_cam = torch.argsort(cam.long(), stable=True)

    def seeded(nc):
        return torch.as_tensor(rng.integers(0, nc, o).astype(np.int32),
                               device="cuda")
    return [("(a) venice-89", cam, None, n),
            ("(b) sorted by camera", cam[by_cam].contiguous(), by_cam, n),
            ("(c) N = 1024", seeded(1024), None, 1024),
            ("(d) N = 32", seeded(32), None, 32)]


def _rows_48k(r: int, n: int, elem: int) -> int:
    """The gather's table rows a block in the earlier plan (4a2a9d4 and
    before): as many as fit 48 KB."""
    return max(1, min(r, 48 * 1024 // (elem * n)))


def _gather_entry(lib, table, cam, out, rows):
    """A call of `lib`'s cam_gather entry point of table's type into
    `out` with `rows` table rows a block (no allocation, no checks)."""
    from povar_tpu_torch.ops import _build
    from povar_tpu_torch.ops.pose_kernels import _ptr, _stream

    name = ("povar_cam_gather_f64" if table.dtype == torch.float64
            else "povar_cam_gather")
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = _build.SIGNATURES[name], ctypes.c_int
    r, n = table.shape
    args = (_ptr(cam), _ptr(table), _ptr(out), cam.shape[0], n, r, rows,
            _stream(table))

    def run():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA error {rc}")
        return out
    return run


def _bound_us(moved: float) -> float:
    import chip_smoke as cs
    return moved / cs.HBM_BYTES_PER_S * 1e6


def gather_ab(parent, variants, layouts, _mask) -> None:
    """cam_gather in f32 and f64 at R = 12 and 132 on each layout: the
    parent's kernel (with its 48 KB row blocks), the package's, each
    variant's, the package's with 48 KB row blocks at N = 1024, and
    `index_select` into a preallocated output, each bit for bit against
    table[:, cam], then timed by the three timers (parent, package,
    package, parent, then the others). The kernels are called through
    their bare C entry points into preallocated outputs, so that the
    loop timer sees the device."""
    from povar_tpu_torch.ops import _build
    from povar_tpu_torch.ops.cam_kernels import _rows_per_block

    package = _build.library()
    rng = np.random.default_rng(5)
    for dtype in (torch.float32, torch.float64):
        elem = torch.tensor([], dtype=dtype).element_size()
        for r in (12, 132):
            for label, c, _rows, n in layouts:
                o = c.shape[0]
                table = torch.as_tensor(rng.standard_normal((r, n)),
                                        dtype=dtype, device="cuda")
                c64 = c.long()
                want = table.index_select(1, c64)

                def entry(lib, rows):
                    out = torch.empty((r, o), dtype=dtype, device="cuda")
                    return _gather_entry(lib, table, c, out, rows)
                new = _rows_per_block(r, n, elem)
                old = _rows_48k(r, n, elem)
                impls = {"parent": entry(parent, old),
                         "package": entry(package, new),
                         **{v: entry(lib, new) for v, lib in variants.items()}}
                if old != new:
                    impls["package, 48 KB rows"] = entry(package, old)
                buf = torch.empty((r, o), dtype=dtype, device="cuda")
                impls["index_select"] = (
                    lambda: torch.index_select(table, 1, c64, out=buf))
                tag = (f"cam_gather {str(dtype)[6:]} R = {r} {label}, rows a "
                       f"block {old} -> {new}")
                for who, fn in impls.items():
                    if not torch.equal(fn(), want):
                        raise AssertionError(f"{tag} {who}: not bit for bit")
                print(f"{tag}: every result bit for bit; bound "
                      f"{_bound_us(4 * o + elem * r * (o + n)):.1f} us",
                      flush=True)
                for who in ["parent", "package", "package", "parent",
                            *(k for k in impls if k not in ("parent",
                                                            "package"))]:
                    print(f"{tag} {who}: {timers(impls[who])}", flush=True)
                del impls, buf, want
                torch.cuda.empty_cache()


def hpp_f64_ab(parent, variants, layouts, mask) -> None:
    """hpp_b's f64 instantiation at (k, d) = (4, 12) and (2, 11) on each
    layout, on seeded f64 operands zeroed on the pad rows: the parent's
    kernel, the package's and each variant's, through the package's
    wrapper, each within 1e-12 per camera of the plain version with hpp
    symmetric bit for bit, then timed by the three timers (parent,
    package, package, parent, then the variants)."""
    from povar_tpu_torch.ops import cam_kernels as ck
    from povar_tpu_torch.ops import cam_ref
    from povar_tpu_torch.tools.parity import scaled_error

    rng = np.random.default_rng(6)
    impls = {"parent": _same_sig(parent, "hpp_b"), "package": ck.hpp_b,
             **{v: _same_sig(lib, "hpp_b") for v, lib in variants.items()}}
    for k, d in ((4, 12), (2, 11)):
        for label, c, rows, n in layouts:
            m = (mask if rows is None else mask[:, rows]).double()
            o = c.shape[0]
            jp, rt = (torch.as_tensor(rng.standard_normal((x, o)),
                                      device="cuda") * m for x in (k * d, k))
            want = cam_ref.hpp_b(jp, rt, c, n)
            tag = f"hpp_b f64 (k, d) = ({k}, {d}) {label}"
            for who, fn in impls.items():
                got = fn(jp, rt, c, n)
                if who in DIAGNOSTIC:
                    continue
                errs = [scaled_error(g, w, "cam") for g, w in zip(got, want)]
                h = got[0].view(d, d, n)
                sym = bool(torch.equal(h, h.transpose(0, 1)))
                if not (max(errs) <= 1e-12 and sym):
                    raise AssertionError(f"{tag} {who}: errors {errs}, hpp "
                                         f"symmetric {sym}")
            moved = 4 * o + 8 * (k * d + k) * o + 8 * (d * d + d) * n
            print(f"{tag}: every result within 1e-12 per camera, hpp "
                  f"symmetric bit for bit; bound {_bound_us(moved):.1f} us",
                  flush=True)
            for who in ["parent", "package", "package", "parent",
                        *variants]:
                print(f"{tag} {who}: "
                      f"{timers(lambda f=impls[who]: f(jp, rt, c, n))}",
                      flush=True)


def kernels(parent: Path, only=None, names=None, same_sig=False) -> None:
    from povar_tpu_torch.ops import cam_kernels as ck
    from povar_tpu_torch.ops import cam_ref
    from povar_tpu_torch.tools import pose2_ab as ab
    from povar_tpu_torch.tools.parity import scaled_error

    variants = {n: (e, k) for n, (e, k) in VARIANTS.items()
                if (only is None or k is None or k in only)
                and (names is None or n in names)}
    libs = ab.build_all(parent, "cam.cu", OUT,
                        {n: (e, 512) for n, (e, _k) in variants.items()},
                        {}, ENTRIES, None if same_sig else PARENT_SIG,
                        SASS_KERNELS)
    from povar_tpu_torch.ops import _build
    logs = {"package": _build.build_log(),
            **{n: (OUT / n / "build.log").read_text()
               for n in ["parent", *variants]}}
    for kernel in ("cam_scatter_add_kernel", "cam_gather_kernel",
                   "hpp_b_kernelId", "hpp_b_groups_kernel"):
        registers(logs, kernel)
    cam, mask, n = _operands()
    if same_sig:
        layouts = _layouts(cam, n)
        for name, run in (("cam_gather", gather_ab),
                          ("hpp_b_f64", hpp_f64_ab)):
            if only is None or name in only:
                # the generic variants (no_walk, no_adds, ...) time
                # hpp_b's f64 sums too
                run(libs["parent"], {v: libs[v] for v, (_e, k) in
                                     variants.items()
                                     if k == name or k is None
                                     and name == "hpp_b_f64"},
                    layouts, mask)
    own_sig = ("cam_gather", "e0_u")  # no earlier signature of their own
    shapes = [s for s in _shapes(cam, mask, n)
              if (only is None or s[0] in only)
              and (same_sig or s[0] not in own_sig)]
    parents = {"cam_scatter_add": _parent_c2, "e0_scatter": _parent_e0,
               "hpp_b": _parent_hpp}
    impls = {name: {"parent": (_same_sig(libs["parent"], name) if same_sig
                               else parents[name](libs["parent"])),
                    "package": getattr(ck, name)}
             for name in (*own_sig, *parents)
             if same_sig or name not in own_sig}
    timed = {
        **{name: {} for name in own_sig},
        "cam_scatter_add": {name: _variant_c2(libs[name])
                            for name, (_e, k) in variants.items()
                            if k in (None, "cam_scatter_add")},
        "e0_scatter": {
            name: _variant_e0(libs[name], FIXED_ORDER_FLOATS
                              if name == "e0_fixed_order" else None)
            for name, (_e, k) in variants.items() if k in (None,
                                                           "e0_scatter")},
        "hpp_b": {name: _variant_hpp(libs[name])
                  for name, (_e, k) in variants.items()
                  if k in (None, "hpp_b")},
    }
    for kernel, label, args, _kw in shapes:
        want = getattr(cam_ref, kernel)(*args)
        for who, fn in [*impls[kernel].items(), *timed[kernel].items()]:
            if who in DIAGNOSTIC:
                continue
            outs = [fn(*args) for _ in range(3)]
            got = outs[0] if kernel == "hpp_b" else (outs[0],)
            same = all(all(torch.equal(a, b) for a, b in
                           zip(got, x if kernel == "hpp_b" else (x,)))
                       for x in outs[1:])
            err = " ".join(f"{scaled_error(g, w, 'cam'):.1e}" for g, w in
                           zip(got, want if kernel == "hpp_b" else (want,)))
            sym = ""
            if kernel == "hpp_b":
                d = got[1].shape[0]
                h = got[0].view(d, d, -1)
                sym = (", hpp symmetric bit for bit "
                       f"{bool(torch.equal(h, h.transpose(0, 1)))}")
            print(f"{kernel} {label} {who}: scaled error per camera {err}, "
                  f"three calls bit-identical {same}{sym}", flush=True)
    ab.ab_time(shapes, impls, timed, cam_ref)


def _sass_functions(lib: Path):
    """{key: SASS text} of every kernel of `lib` (cuobjdump -sass, the
    addresses and encodings dropped). The key is the mangled name without
    its translation unit's hash; a csrc/*.cu kernel's is its source, its
    name, its value type (f where an earlier source had none) and its
    other template arguments, so that an earlier tree's f32 kernels meet
    the package's f32 instantiations."""
    from povar_tpu_torch.ops import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out, key = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "",
                          m.group(1))
            c = re.match(r"\d+(\w+?_kernel)(?:I([fd])?(.*?)EEv|E)P", name)
            src = re.search(r"_GLOBAL__N__[0-9a-f]+_\d+_(\w+?)_cu_",
                            m.group(1))
            if c and src:
                name = (f"{src.group(1)}: {c.group(1)}<{c.group(2) or 'f'}>"
                        f"{c.group(3) or ''}")
            key = name
            out[key] = []
            continue
        ins = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", ln)
        if key and ins:
            out[key].append(ins.group(1).strip())
    return {k: "\n".join(v) for k, v in out.items()}


def sass_diff(parent: Path, lines: int = 0) -> None:
    """Every kernel of the earlier tree `parent` (a checkout with
    povar_tpu_torch/, built with its own ops/_build.py) against the
    package's build, SASS text instruction for instruction: which are
    identical, which differ (with their instruction counts), and which
    the package alone has (the f64 instantiations); with `lines`, the
    first `lines` lines of each differing kernel's diff."""
    import difflib

    from povar_tpu_torch.ops import _build

    lib = subprocess.run(
        [sys.executable, "-c", "from povar_tpu_torch.ops import _build; "
         "print(_build.build())"], cwd=parent, capture_output=True,
        text=True, check=True).stdout.strip().splitlines()[-1]
    old, new = _sass_functions(Path(parent) / lib), _sass_functions(
        _build.build())
    same = sorted(k for k in old if new.get(k) == old[k])
    differ = sorted(k for k in old if k in new and new[k] != old[k])
    gone = sorted(k for k in old if k not in new)
    added = sorted(k for k in new if k not in old)
    print(f"sass: {len(old)} kernels in the parent, {len(new)} in the "
          f"package; {len(same)} identical instruction for instruction, "
          f"{len(differ)} differ, {len(gone)} only in the parent, "
          f"{len(added)} only in the package", flush=True)
    for k in differ:
        print(f"sass differs: {k[:100]} ({old[k].count(chr(10)) + 1} / "
              f"{new[k].count(chr(10)) + 1} instructions)", flush=True)
        diff = list(difflib.unified_diff(old[k].splitlines(),
                                         new[k].splitlines(), lineterm="",
                                         n=1))
        for ln in diff[2:2 + lines]:
            print(f"  {ln}", flush=True)
    for k in gone:
        print(f"sass only in the parent: {k[:100]}", flush=True)
    for k in added:
        print(f"sass only in the package: {k[:100]}", flush=True)


def _host_us(fn, reps: int = 2000) -> float:
    """Host time per call of `fn` in microseconds (the enqueue alone:
    no synchronisation inside the loop), mean of `reps` after a warm-up."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def gather() -> None:
    """cam_gather at venice-89 ([12, 89] table, O = 557,056) beside
    index_select: event and device times, and host time per call."""
    import chip_smoke as cs
    from povar_tpu_torch.ops import _build
    from povar_tpu_torch.ops import cam_kernels as ck
    from povar_tpu_torch.ops.pose_kernels import _ptr, _stream

    cam, _mask, n = _operands()
    table = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (12, n)), dtype=torch.float32, device="cuda")
    cam64 = cam.long()
    lib = _build.library()
    out = torch.empty((12, cam.shape[0]), device="cuda")
    args = (_ptr(cam), _ptr(table), _ptr(out), cam.shape[0], n, 12,
            ck._rows_per_block(12, n), _stream(table))
    fns = {"cam_gather": lambda: ck.cam_gather(table, cam),
           "index_select": lambda: table.index_select(1, cam64),
           "C entry point": lambda: lib.povar_cam_gather(*args),
           "ctypes call alone": lambda: lib.povar_error_string(0)}
    for name, fn in fns.items():
        card = ("" if name == "ctypes call alone" else
                f"events {cs.cuda_ms(fn):.4f} ms, device "
                f"{cs.device_us(fn):.1f} us, ")
        print(f"gather venice-89 {name}: {card}host {_host_us(fn):.2f} us "
              "per call", flush=True)


def bench() -> None:
    import chip_smoke as cs
    from povar_tpu_torch import SolverOptions, synthetic_bal_problem_fast

    gather()
    problem = synthetic_bal_problem_fast(cs.N_CAMS, cs.N_LMS, cs.OBS_PER_LM,
                                         seed=0)
    for label, opts in (("off", SolverOptions(pallas_kernels="off")),
                        ("defaults", SolverOptions()),
                        ("f64", SolverOptions(mixed_precision_solves=False))):
        cs.bench_step1(problem, opts, f"step-1 {label}")
        cs.bench_step2(problem, opts, f"step-2 {label}")


def launches() -> None:
    """The launches of cam_scatter_add by row count, and every kernel's,
    in one venice-89 bundle_adjust with pallas_kernels="off", PCG and
    RIPCG."""
    import chip_smoke as cs
    from povar_tpu_torch import (SolverOptions, bundle_adjust,
                                 synthetic_bal_problem_fast)
    from povar_tpu_torch.ops import cam_kernels as ck
    from povar_tpu_torch.ops import launches as lc
    from povar_tpu_torch.options import SolverType, SolverTypeRiemannian

    problem = synthetic_bal_problem_fast(cs.N_CAMS, cs.N_LMS, cs.OBS_PER_LM,
                                         seed=0)
    opts = SolverOptions(pallas_kernels="off",
                         solver_type_step_1=SolverType.PCG,
                         solver_type_step_2=SolverTypeRiemannian.RIPCG)
    by_rows = {}
    scatter = ck.cam_scatter_add

    def counted(v, cam, n_cams):
        by_rows[v.shape[0]] = by_rows.get(v.shape[0], 0) + 1
        return scatter(v, cam, n_cams)
    ck.cam_scatter_add = counted
    try:
        lc.reset_launch_counts()
        _p, s1, s2 = bundle_adjust(problem, opts, log=lambda x: None)
        torch.cuda.synchronize()
    finally:
        ck.cam_scatter_add = scatter
    print(f"launches off PCG + RIPCG: cam_scatter_add by R "
          f"{dict(sorted(by_rows.items()))}; step 1 "
          f"{s1.final_cost.all.error:.6f}, step 2 "
          f"{s2.final_cost.all.error:.6g}; all "
          f"{ {k: c for k, c in lc.launch_counts().items() if c} }",
          flush=True)


def spread(chol: int, off: int) -> None:
    import chip_smoke as cs
    from povar_tpu_torch import (SolverOptions, SolverSummary, Stage1Solver,
                                 Timer, create_homogeneous, from_numpy,
                                 optimize_step1, synthetic_bal_problem_fast)
    from povar_tpu_torch.options import SolverType
    from povar_tpu_torch.tools.step2_spread import JAX_CHOL_COST, step1_spread

    problem = synthetic_bal_problem_fast(cs.N_CAMS, cs.N_LMS, cs.OBS_PER_LM,
                                         seed=0)
    recs = step1_spread(problem, chol, SolverType.CHOLESKY)
    firsts = [r["costs"][1] for r in recs]
    out = [r for r in recs
           if not abs(r["costs"][1] - cs.CHOL_FIRST)
           <= cs.CHOL_FIRST_TOL * cs.CHOL_FIRST
           or r["decisions"][:cs.CHOL_SAME] != "A" * cs.CHOL_SAME
           or not (cs.CHOL_BAND[0] * JAX_CHOL_COST <= r["final"]
                   <= cs.CHOL_BAND[1] * JAX_CHOL_COST)]
    if chol:
        dev = sorted(f / cs.CHOL_FIRST - 1.0 for f in firsts)
        print(f"spread chol: {len(out)} of {chol} outside the bands; first "
              f"trial against CHOL_FIRST {dev[0]:+.2e} .. {dev[-1]:+.2e}; "
              f"finals {sorted(r['final'] / JAX_CHOL_COST for r in recs)} x "
              "JAX", flush=True)
    opts = SolverOptions(pallas_kernels="off")
    stage1 = Stage1Solver(problem.obs_cam, problem.obs_lm, problem.obs_uv,
                          problem.num_cameras, problem.num_landmarks, opts,
                          device="cuda")
    finals = []
    for _ in range(off):
        _p, c0, l0 = from_numpy(problem.obs_cam, problem.obs_lm,
                                problem.obs_uv, problem.cam_space,
                                problem.lm_p, device="cuda")
        s = SolverSummary()
        optimize_step1(stage1, c0, l0, opts, s, Timer(), log=lambda x: None)
        finals.append(s.final_cost.all.error)
    if off:
        bad = [f for f in finals if not abs(f - cs.JAX_FINAL_COST)
               <= 1e-3 * cs.JAX_FINAL_COST]
        print(f"spread off: {len(bad)} of {off} step-1 finals more than 1e-3 "
              f"from {cs.JAX_FINAL_COST}; finals {sorted(finals)}",
              flush=True)
    _s, (cams, lms), _t, _u = cs.solve(problem, SolverOptions(), "cuda")
    try:
        cs.check_layouts(problem, *create_homogeneous(cams, lms))
        print("spread layouts: within LAYOUT_TOLS", flush=True)
    except AssertionError as e:
        print(f"spread layouts: outside LAYOUT_TOLS: {e}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    k = sub.add_parser("kernels")
    k.add_argument("--parent", type=Path, required=True,
                   help="directory with the earlier cam.cu and "
                   "pose_common.cuh")
    k.add_argument("--kernels", nargs="+", default=None,
                   choices=("cam_gather", "e0_u", "cam_scatter_add",
                            "e0_scatter", "hpp_b", "hpp_b_f64"),
                   help="time only these kernels (default: all; "
                   "cam_gather, e0_u and hpp_b_f64 only with --same-sig)")
    k.add_argument("--variants", nargs="*", default=None,
                   help="build and time only these VARIANTS (default: all "
                   "that concern the kernels; none without names)")
    k.add_argument("--same-sig", action="store_true",
                   help="the parent's entry points take the package's "
                   "arguments (84c289b's cam.cu and later), not PARENT_SIG's: "
                   "its five kernels run through the package's wrappers")
    d = sub.add_parser("sass")
    d.add_argument("--parent", type=Path, required=True,
                   help="an earlier tree (with povar_tpu_torch/) whose "
                   "build to compare")
    d.add_argument("--diff", type=int, default=0,
                   help="print this many lines of each differing kernel's "
                   "diff")
    sub.add_parser("bench")
    sub.add_parser("launches")
    s = sub.add_parser("spread")
    s.add_argument("--chol", type=int, default=16)
    s.add_argument("--off", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("cam_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path.cwd()))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if args.mode == "kernels":
        kernels(args.parent, args.kernels, args.variants, args.same_sig)
    elif args.mode == "sass":
        sass_diff(args.parent, args.diff)
    elif args.mode == "spread":
        spread(args.chol, args.off)
    elif args.mode == "launches":
        launches()
    else:
        bench()
    return 0


if __name__ == "__main__":
    sys.exit(main())

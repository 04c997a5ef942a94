"""`prepare2`, `hppb2`, `e0_term2_parts`, `pose_error2`, `schur_diag2`
and `scatter2` against an earlier version of their kernels, and against
controlled variants of their own, on one card.

    python -m povar_tpu_torch.tools.pose2_ab kernels --parent DIR
        [--kernels NAME ...] [--final]
    python -m povar_tpu_torch.tools.pose2_ab bench

Run from the repository root (`chip_smoke.py` lends its timers, its
step-1 solve and its bench iteration). `kernels` builds DIR/pose2.cu
(with DIR/pose_common.cuh: an earlier commit's csrc/, for instance
`git archive <commit> povar_tpu_torch/csrc` unpacked into a git-ignored
directory; its entry points take the package's arguments except
`povar_schur_diag2`, `povar_scatter2` and `povar_prepare2`, which take
PARENT_SIG's) and the VARIANTS of the
package's own csrc/ that concern the kernels asked for (`--kernels`;
default all), one nvcc each, all started together, into
build/pose2_ab/, and prints the SASS opcode counts (cuobjdump -sass) of
the earlier and the package kernels. It then takes the venice-89 step-2
state of the card's step-1 result (chip_smoke.check_kernels2's operands)
and times each kernel in turns (earlier, package, package, earlier; then
the variants that concern it) at

  (a) venice-89: O = 557,056 slot rows, N = 89 (pose_error2 under NONE,
      HUBER and CAUCHY);
  (b) the camera-sorted orders: hppb2, pose_error2, schur_diag2 and
      scatter2 on the 1-device mesh solver's own step-2 operands (the
      SPMD window order, 598,016 lanes; mat6 and sb seeded), the fused
      term on the
      venice-89 operands with each part's landmarks sorted by first
      camera (the window plan's order, the same parts);
  (c) N = 1024 seeded cameras on the venice-89 rows (pose_error2 and
      prepare2: the 89 cameras repeated; schur_diag2's global route,
      scatter2's and prepare2's shared copies), and N = 2048 for hppb2
      (its global-memory route);
  prepare2 also in f64 on (b)'s operands (the mesh's pure f64), and on
  the homogenized VarProj start of synthetic_bal_problem_fast(N,
  209,716, 5, locality=64) at (d) N = 5000 and (e) N = 13,682 (~2^20
  slot rows, chip_smoke.py's large_n (a) problem: the global route),
  and with `--final` (f) of the whole final-13682 (22.9M observations),

checking the earlier and the package kernel against the plain version
per camera (tools/parity.py, 1e-4) and printing each result's error,
the plain version's too, against the plain version in f64 on the same
values. A variant gives wrong sums by design and is only timed. Device
time is the profiler's, every device operation of a call included (the
zeroing of the outputs too, listed by name for the earlier and the
package kernel), mean of 20 calls; event time the median of 20. `bench`
prints the warm step-1 and step-2 bench iterations (chip_smoke.
bench_step1 / bench_step2: launches, wall time, device time and device
operations per iteration, device time by kernel) with SolverOptions()
defaults on one device and on a 1-device mesh, for the package tree in
the current directory; run it in each tree to compare. tools/pose1_ab.py
does the same for step 1's kernels with this module's builds, variants
and timing loop (`build_all`, `common_variants`, `ab_time`).
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

# edits of csrc/ (file, regex, replacement) that make the per-camera adds
# dead stores: the shared-memory and global atomics, and warp_scatter's
# plain adds into a warp's own accumulator
NO_ATOMICS = (r"atomicAdd\(&(acc\w*)\[([^\]]+)\], ([^;]+)\);",
              r"{ const float a_ = \3; if (a_ == 1.2345e-38f) \1[\2] = a_; }")
NO_ADDS = (r"acc\[k \* n \+ c\] \+= v\[k\];",
           "if (v[k] == 1.2345e-38f) acc[k * n + c] = v[k];")
# the Schur-Jacobi pass's adds after its reduce-scatter tree
NO_TREE_ADDS = (r"acc\[k \* n_cams \+ cu\] \+= sum\[j\];",
                "if (sum[j] == 1.2345e-38f) acc[k * n_cams + cu] = sum[j];")
# warp_scatter's sums of the lanes on one camera as a pairwise butterfly
# (5 shuffle steps) where every live lane is on one camera (one lead, with
# peers), the walk over the peers in lane order otherwise
BUTTERFLY = (
    r"(  unsigned rest = p\.rest;\n"
    r"  while .*?\n    rest &= rest - 1u;\n  \}\n)",
    "  if (__popc(__ballot_sync(kFullMask, p.lead)) == 1 &&\n"
    "      __any_sync(kFullMask, p.rest != 0u)) {\n"
    "#pragma unroll\n"
    "    for (int k = 0; k < K; ++k)\n"
    "#pragma unroll\n"
    "      for (int off = 16; off > 0; off >>= 1)\n"
    "        v[k] += __shfl_xor_sync(kFullMask, v[k], off);\n"
    "  } else {\n"
    r"\1"
    "  }\n")
# the fused terms' flush (pose_common.cuh flush_tiles) left out
NO_TILE_FLUSH = [
    ("pose_common.cuh", r"if \(s != 0\.0f\) atomicAdd\(out \+ i, s\);",
     "if (s == 1.2345e-38f) out[i] = s;"),
    ("pose_common.cuh", r"\n    flush_acc\(out, acc, n_acc\);", "\n"),
]


def common_variants(source: str, moment_flush: str,
                    source_atomics: bool = True):
    """The variants both steps' tools build (name: ([edits], threads per
    block their fused-term table is cut for)); `source` is the step's
    .cu file, `moment_flush` the regex of its moment kernel's block
    flush, `source_atomics` whether `source` has per-camera atomics of
    its own (outside pose_common.cuh's passes)."""
    return {
        # the per-camera adds made dead stores: loads, arithmetic, warp sums
        "no_adds": ([(source, *NO_ATOMICS)] * source_atomics +
                    [("pose_common.cuh", *NO_ATOMICS),
                     ("pose_common.cuh", *NO_ADDS),
                     ("pose_common.cuh", *NO_TREE_ADDS)], 512),
        # every live lane adds its own values (no sum over a camera's
        # lanes; the fused terms' per-warp adds then race: timing only)
        "no_group_sum": ([("pose_common.cuh",
                           r"__match_any_sync\(kFullMask, live \? c : -1\)",
                           "(1u << lane)")], 512),
        # the blocks' flush to global memory left out
        "no_flush": ([(source, moment_flush, ""), *NO_TILE_FLUSH], 512),
        # a shuffle butterfly where every live lane is on one camera
        "butterfly": ([("pose_common.cuh", *BUTTERFLY)], 512),
        # the fused term on one shared-atomic accumulator per block
        "block_atomics": ([("pose_common.cuh",
                            r"if \(base \+ kE0Warps \* acc <= \(size_t\)"
                            r"max_optin_smem\(\)\)", "if (false)")], 512),
        "threads256": ([("pose_common.cuh", r"kE0Threads = 512",
                         "kE0Threads = 256")], 256),
        "threads1024": ([("pose_common.cuh", r"kE0Threads = 512",
                          "kE0Threads = 1024")], 1024),
    }


# the step-2 cost with one of its design choices undone or changed:
# the camera table staged in shared memory (not read through __ldg), the
# seven block sums one after another (povar::block_sum, two barriers
# each), the counts in f64, 512- or 1024-thread blocks, no last-block
# total (timing only), and one reciprocal of p2 for two divisions
ERR_VARIANTS = {
    "err_table_shared": [
        ("pose2.cu", r"P\[k\] = __ldg\(ct \+ k \* n_cams \+ c\);",
         "P[k] = tbl[k * n_cams + c];"),
        ("pose2.cu", r"(\n  const int O = n_obs;\n  double s\[kErrSums\])",
         "\n  extern __shared__ double tbl[];\n"
         "  povar::smem_copy(tbl, ct, 12 * n_cams);\n  __syncthreads();\\1"),
        ("pose2.cu", r"launch\(pose_error2_kernel, n_obs, 0,",
         "launch(pose_error2_kernel, n_obs, sizeof(double) * 12 * "
         "(size_t)n_cams,"),
    ],
    "err_serial_sums": [
        ("pose2.cu", r"\n  block_reduce\(s, n\);",
         "\n  { __shared__ double rs[32]; __shared__ Count rn[32];\n"
         "    for (int k = 0; k < kErrSums; ++k) s[k] = "
         "povar::block_sum(s[k], rs);\n"
         "    for (int k = 0; k < kErrCounts; ++k) n[k] = "
         "povar::block_sum(n[k], rn); }"),
    ],
    "err_f64_counts": [("pose2.cu", r"using Count = unsigned;",
                        "using Count = double;")],
    # larger blocks: fewer partials for the last block to add
    **{f"err_threads{t}": [
        ("pose2.cu", r"constexpr int kWarps = kThreads / 32;",
         f"constexpr int kWarps = {t} / 32;"),
        ("pose2.cu", r"__launch_bounds__\(kThreads\)\n    pose_error2_kernel",
         f"__launch_bounds__({t})\n    pose_error2_kernel"),
        ("pose2.cu", r"launch\(pose_error2_kernel,",
         f"launch<{t}>(pose_error2_kernel,")] for t in (512, 1024)},
    # diagnostic: every block returns after writing its partials
    "err_no_tail": [("pose2.cu", r"if \(!povar::last_block\(ticket, true\)\) "
                     r"return;", "return;")],
    "err_reciprocal": [
        ("pose2.cu", r"const double r0 = p\[0\] / p\[2\] - uv\[o\];\n"
         r"    const double r1 = p\[1\] / p\[2\] - uv\[O \+ o\];",
         "const double inv = 1.0 / p[2];\n"
         "    const double r0 = p[0] * inv - uv[o];\n"
         "    const double r1 = p[1] * inv - uv[O + o];"),
    ],
}

# the Schur-Jacobi kernels (pose_common.cuh schur_pass, launch_schur)
# with one design choice changed: one shared copy per 512-thread block
# (shared atomics after the warp's sums, as hpp_b_structured's), as
# many shared copies as fit, f64 global atomics at every N, 4 or 8
# private copies a block (10 by default), no loads of the next row
# ahead, the lane-order walk also where a warp sits on one camera (no
# reduce-scatter tree); and, wrong sums by design (timed only), the
# arithmetic and loads alone (no sums over a camera's lanes, the adds
# made dead stores), the loads and H alone, and no tail
_RED_ADD = ("pose_common.cuh", r"(\nstruct WarpPeers \{)",
            "\n__device__ __forceinline__ void red_add(float* p, float v) {\n"
            "  atomicAdd(p, v);\n}\n"
            "__device__ __forceinline__ void red_add(double* p, double v) {\n"
            "  asm volatile(\"red.add.f64 [%0], %1;\" :: \"l\"(p), \"d\"(v)"
            " : \"memory\");\n}\n\\1")
_SCHUR_PLAN = (r"sums_plan\(kSchurMoments, n_cams, kSchurWarps, "
               r"kSchurMinWarps,", "sums_plan(kSchurMoments, n_cams, "
               "kSchurWarps, 33,")
_ONE_COPY = (r"const int k = std::min\(fit, shared_threads / 32\);",
             "const int k = 1;")
SCHUR_VARIANTS = {
    "schur_shared1": [("pose_common.cuh", *_SCHUR_PLAN),
                      ("pose_common.cuh", *_ONE_COPY)],
    "schur_shared_copies": [("pose_common.cuh", *_SCHUR_PLAN)],
    "schur_global": [("pose_common.cuh", *_SCHUR_PLAN),
                     ("pose_common.cuh", r"if \(fit >= 1\) \{",
                      "if (fit >= 1 && rows != kSchurMoments) {")],
    "schur_warps4": [("pose_common.cuh", r"kSchurWarps = 10;",
                      "kSchurWarps = 4;")],
    "schur_warps8": [("pose_common.cuh", r"kSchurWarps = 10;",
                      "kSchurWarps = 8;")],
    "schur_walk_only": [("pose_common.cuh", r"if \(__popc\(leads\) == 1 &&",
                         "if (false &&")],
    "schur_no_prefetch": [("pose_common.cuh",
                           r"(void schur_pass\(.*?)constexpr bool "
                           r"kPrefetch = R == Route::kPrivate;",
                           r"\1constexpr bool kPrefetch = false;")],
    "schur_arith_only": [
        ("pose_common.cuh", r"__match_any_sync\(kFullMask, live \? c : -1\)",
         "(1u << lane)"),
        ("pose_common.cuh", *NO_ATOMICS), ("pose_common.cuh", *NO_ADDS)],
    # ... the loads and H alone (no moments, sums or adds), and the pass
    # without its tail (no flush of the copies, no last block)
    "schur_loads_only": [("pose_common.cuh",
                          r"    if \(!__any_sync\(kFullMask, live\)\) "
                          r"continue;\n    float v\[kSchurMoments\];",
                          "    if (live && H[0] + H[5] + xh[0] + xh[3] == "
                          "1.2345e-38f) acc_g[0] = 1.0;\n    continue;\n"
                          "    float v[kSchurMoments];")],
    "schur_no_tail": [("pose_common.cuh",
                       r"  flush_copies<R, double, 32>\(acc_g, smem, copies, "
                       r"n_acc, n_acc\);", "  return;")],
    # the copies' flush left out (the last block's expansion kept)
    "schur_no_flush": [("pose_common.cuh",
                        r"  flush_copies<R, double, 32>\(acc_g, smem, copies, "
                        r"n_acc, n_acc\);", "")],
    # the f64 global atomics as reductions (PTX red.add.f64, no value
    # returned): the copies' flush, and also the global route's adds
    "schur_red_flush": [_RED_ADD, ("pose_common.cuh",
                                   r"if \(s != 0\.0f\) atomicAdd\(sums \+ i, "
                                   r"\(T\)s\);",
                                   "if (s != 0.0f) red_add(sums + i, (T)s);")],
    # the blocks' flush starting at entry blockIdx count / gridDim (not
    # all at entry 0): at any moment the blocks' atomics hit different
    # addresses
    "schur_flush_rotated": [("pose_common.cuh",
                             r"  __syncthreads\(\);\n  for \(int i = threadIdx\.x; "
                             r"i < count; i \+= blockDim\.x\) \{\n",
                             "  __syncthreads();\n"
                             "  const int shift = (int)((long)blockIdx.x * "
                             "count / gridDim.x);\n"
                             "  for (int t = threadIdx.x; t < count; t += "
                             "blockDim.x) {\n"
                             "    const int i = t + shift < count ? t + shift "
                             ": t + shift - count;\n")],
    # the last block's staging a warp per moment row (hpp_b_structured's)
    "schur_expand_rows": [("pose_common.cuh",
                           r"if \(kReset && nc == n_cams\) \{",
                           "if (false) {")],
    "schur_red_all": [_RED_ADD, ("pose_common.cuh",
                                 r"if \(s != 0\.0f\) atomicAdd\(sums \+ i, "
                                 r"\(T\)s\);",
                                 "if (s != 0.0f) red_add(sums + i, (T)s);"),
                      ("pose_common.cuh",
                       r"atomicAdd\(&acc\[k \* n \+ c\], \(T\)v\[k\]\);",
                       "red_add(&acc[k * n + c], (T)v[k]);"),
                      ("pose_common.cuh",
                       r"atomicAdd\(acc_g \+ k \* n_cams \+ cu, "
                       r"\(double\)sum\[j\]\);",
                       "red_add(acc_g + k * n_cams + cu, (double)sum[j]);")],
}
# the variants of every other kernel that the Schur kernels are timed
# with too (their per-camera adds: warp_scatter_rows's)
SCHUR_COMMON = ("no_adds", "no_group_sum")

# the composed terms' scatters (pose_common.cuh scatter_pass,
# launch_scatter; both steps') with one design choice changed: the
# lane-order walk also where a warp sits on one camera (no reduce-scatter
# tree), no loads of the next row ahead, no skip of a warp whose lanes
# are all dead, 32 or 8 private copies a block (1024- or 256-thread
# blocks; 16 and 512 by default), shared copies in 1024-thread blocks at
# every N (as many as fit, or one), f64 global atomics at every N, other
# flushes and grids (below); and,
# wrong sums by design (timed only), the loads and the row's arithmetic
# alone, the pass without its copies' flush, and without its tail
_SCATTER_PLAN = (r"sums_plan\(kScatterValues, n_cams, kScatterWarps,\s+"
                 r"kScatterWarps,", "sums_plan(kScatterValues, n_cams, "
                 "kScatterWarps, 33,")
_SHARED512 = ("pose_common.cuh", r"kScatterSharedThreads = 1024;",
              "kScatterSharedThreads = 512;")
_SHARED_PREFETCH = ("pose_common.cuh",
                    r"(void scatter_pass\(.*?)constexpr bool kPrefetch = "
                    r"R == Route::kPrivate;",
                    r"\1constexpr bool kPrefetch = R != Route::kGlobal;")
SCATTER_VARIANTS = {
    "scatter_walk_only": [("pose_common.cuh",
                           r"if \(__popc\(leads\) == 1 &&(\s+__popc\("
                           r"__ballot_sync\(kFullMask, live\)\) >= 4\) \{"
                           r"\s+float sum\[2\];\s+warp_reduce_scatter16)",
                           r"if (false &&\1")],
    "scatter_no_prefetch": [("pose_common.cuh",
                             r"(void scatter_pass\(.*?)constexpr bool "
                             r"kPrefetch = R == Route::kPrivate;",
                             r"\1constexpr bool kPrefetch = false;")],
    "scatter_no_dead_skip": [("pose_common.cuh",
                              r"if \(!__any_sync\(kFullMask, live\)\) "
                              r"continue;\n(    if \(!live\) \{)", r"\1")],
    "scatter_warps32": [("pose_common.cuh", r"kScatterWarps = 16;",
                         "kScatterWarps = 32;")],
    "scatter_warps8": [("pose_common.cuh", r"kScatterWarps = 16;",
                        "kScatterWarps = 8;")],
    "scatter_shared_copies": [("pose_common.cuh", *_SCATTER_PLAN)],
    "scatter_shared1": [("pose_common.cuh", *_SCATTER_PLAN),
                        ("pose_common.cuh", *_ONE_COPY)],
    "scatter_global": [("pose_common.cuh", *_SCATTER_PLAN),
                       ("pose_common.cuh", r"if \(fit >= 1\) \{",
                        "if (fit >= 1 && rows != kScatterValues) {")],
    "scatter_loads_arith": [("pose_common.cuh",
                             r"if \(!__any_sync\(kFullMask, live\)\) "
                             r"continue;\n(    if \(!live\) \{)",
                             "{ float q_ = 0.0f;\n"
                             "      for (int k = 0; k < K; ++k) q_ += v[k];\n"
                             "      if (live && q_ == 1.2345e-38f) "
                             "acc_g[0] = 1.0; }\n    continue;\n\\1")],
    "scatter_no_flush": [("pose_common.cuh",
                          r"if \(!block_sums_done<R, double, 32>\(acc_g, "
                          r"smem, copies, n_acc, n_acc\)\)",
                          "if (!last_block(ticket_of(acc_g, n_acc)))")],
    "scatter_no_tail": [("pose_common.cuh",
                         r"  if \(!block_sums_done<R, double, 32>\(acc_g, "
                         r"smem, copies, n_acc, n_acc\)\)\n    return;\n",
                         "  return;\n")],
    # the copies' flush as reductions (red.add.f64), or starting at entry
    # blockIdx count / gridDim (the Schur kernels' variants of the shared
    # flush)
    "scatter_red_flush": SCHUR_VARIANTS["schur_red_flush"],
    "scatter_flush_rotated": SCHUR_VARIANTS["schur_flush_rotated"],
    # shared copies in 512-thread blocks (one block an SM still: the
    # copies fill its shared memory), with and without the next row's
    # loads ahead there too, and 1024-thread blocks with them
    "scatter_shared512": [_SHARED512],
    "scatter_shared512_prefetch": [_SHARED512, _SHARED_PREFETCH],
    "scatter_shared_prefetch": [_SHARED_PREFETCH],
}
# the variants of every other kernel that the scatters are timed with too
SCATTER_COMMON = ("no_adds", "no_group_sum")

# prepare2 (pose2.cu S1) with one design choice changed: its camera table
# staged in shared memory beside the copies (not read through __ldg), the
# lane-order walk also where a warp sits on one camera (no reduce-scatter
# tree), other register caps (1536 or 2048 resident threads an SM, 1024
# by default), no loads of the next row ahead, the next row's table
# column loaded ahead too, 8 private copies a block (256-thread blocks;
# 16 by default), 2 or as many shared copies as fit (1 by default),
# shared copies (in 1024-thread blocks) at every N, f64 global atomics at
# every N; and, wrong sums by design (timed only), the pass without its
# per-camera sums (loads, arithmetic, stores and the tail)
PREP2_VARIANTS = {
    "prep2_table_shared": [
        ("pose2.cu", r"(      V P\[12\];\n#pragma unroll\n      for \(int k = 0; "
         r"k < 12; \+\+k\) P\[k\] = )__ldg\(ct \+ k \* n_cams \+ c\);",
         "\\1tbl_s[k * n_cams + c];"),
        ("pose2.cu", r"(  V\* acc = povar::warp_copy<R>\(smem, copies, "
         r"n_acc\);\n)",
         "\\1  V* tbl_s = smem + (R == Route::kGlobal ? 0 : copies * n_acc);\n"
         "  povar::smem_copy(tbl_s, ct, 12 * n_cams);\n  __syncthreads();\n"),
        ("pose2.cu", r"kPrep2StaticSmem,(\s+)sizeof\(V\)\);",
         "kPrep2StaticSmem + sizeof(V) * 12 * n_cams,\\1sizeof(V));"),
        ("pose2.cu", r"(    plan\.copies = copies;\n  \}\n)",
         "\\1  plan.smem += sizeof(V) * 12 * n_cams;\n"),
    ],
    "prep2_walk_only": [("pose2.cu", r"if \(__popc\(leads\) == 1 &&\n"
                         r"        __popc\(__ballot_sync\(povar::kFullMask, "
                         r"live\)\) >= 4\)", "if (false)")],
    "prep2_sm1536": [("pose2.cu", r"kPrep2SmThreads = 1024;",
                      "kPrep2SmThreads = 1536;")],
    "prep2_sm2048": [("pose2.cu", r"kPrep2SmThreads = 1024;",
                      "kPrep2SmThreads = 2048;")],
    "prep2_no_prefetch": [("pose2.cu", r"kPrep2Prefetch = true;",
                           "kPrep2Prefetch = false;")],
    "prep2_prefetch_table": [
        ("pose2.cu", r"  V u, v, x4\[4\];\n  float m;",
         "  V u, v, x4[4], P[12];\n  float m;"),
        ("pose2.cu", r"(    Prep2Row<V> r;\n    const bool in = o < O;\n"
         r"    r\.c = in \? cam\[o\] : 0;\n)",
         "\\1#pragma unroll\n    for (int k = 0; k < 12; ++k) "
         "r.P[k] = __ldg(ct + k * n_cams + r.c);\n"),
        ("pose2.cu", r"(      V P\[12\];\n#pragma unroll\n      for \(int k = 0; "
         r"k < 12; \+\+k\) P\[k\] = )__ldg\(ct \+ k \* n_cams \+ c\);",
         "\\1row.P[k];"),
    ],
    "prep2_warps8": [("pose2.cu", r"kPrep2Warps = 16;", "kPrep2Warps = 8;")],
    "prep2_shared2": [("pose2.cu", r"kPrep2SharedCopies = 1;",
                       "kPrep2SharedCopies = 2;")],
    "prep2_shared_fit": [("pose2.cu", r"kPrep2SharedCopies = 1;",
                          "kPrep2SharedCopies = 32;")],
    "prep2_shared": [("pose2.cu", r"kPrep2Warps, kPrep2Warps,",
                      "kPrep2Warps, 33,")],
    "prep2_global": [("pose2.cu", r"kPrep2StaticSmem,(\s+)sizeof\(V\)\);",
                      "(size_t)1 << 40,\\1sizeof(V));")],
    "prep2_no_sums": [("pose2.cu", r"      live = w != V\(0\);\n",
                       "      live = false;\n")],
}

VARIANTS = {
    **common_variants("pose2.cu", r"povar::flush_acc\(acc_g, acc, [^;]+;",
                      source_atomics=False),
    # every in-range row's operands loaded, not only the live rows'
    "eager_loads": ([("pose2.cu",
                      r"if \(live\) \{\n      c = cam\[o\];\n      const",
                      "if (o < O) {\n      c = cam[o];\n      const"),
                     ("pose2.cu", r"if \(live\) \{\n      c = cam\[o\];\n#pragma",
                      "if (row.in) {\n      c = cam[o];\n#pragma")], 512),
    **{name: (edits, 512) for name, edits in ERR_VARIANTS.items()},
    **{name: (edits, 512) for name, edits in SCHUR_VARIANTS.items()},
    **{name: (edits, 512) for name, edits in SCATTER_VARIANTS.items()},
    **{name: (edits, 512) for name, edits in PREP2_VARIANTS.items()},
    # scatter2 loading every in-range row's operands, not only the rows
    # with sw != 0 (no load waiting on sw's)
    "scatter2_eager_loads": ([("pose2.cu", r"const bool live = r\.sw != "
                               r"0\.0f;\n", "const bool live = o < O;\n")],
                             512),
}
# the earlier kernels with their per-camera atomics made dead stores
PARENT_VARIANTS = {"parent_no_atomics": [("pose2.cu", *NO_ATOMICS),
                                         ("pose_common.cuh", *NO_ATOMICS)]}
# the entry points timed and the kernels whose SASS opcodes are counted
ENTRIES = ("povar_hppb2", "povar_e0_term2", "povar_pose_error2",
           "povar_schur_diag2", "povar_scatter2", "povar_prepare2",
           "povar_prepare2_f64")
SASS_KERNELS = {**{f"prepare2 route {r}":
                   rf"prepare2_kernelIfLN5povar5RouteE{r}E"
                   for r in range(3)},
                **{f"prepare2_f64 route {r}":
                   rf"prepare2_kernelIdLN5povar5RouteE{r}E"
                   for r in range(3)},
                "prepare2": "prepare2_kernel",
                "hppb2": "hppb2_kernel", "e0_term2": "e0_term2_kernel",
                "pose_error2": "pose_error2_kernel",
                # the earlier kernel (one name), else route 0 / 1 / 2:
                # per-warp, shared and global (pose_common.cuh Route)
                **{f"schur_diag2 route {r}":
                   rf"schur_diag2_kernelILN5povar5RouteE{r}E"
                   for r in range(3)},
                "schur_diag2": "schur_diag2_kernel",
                **{f"scatter2 route {r}":
                   rf"scatter2_kernelILN5povar5RouteE{r}E"
                   for r in range(3)},
                "scatter2": "scatter2_kernel"}
OUT = Path("build") / "pose2_ab"
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_F = ctypes.c_float
# the earlier pose2.cu's Schur-Jacobi, scatter and prepare2 entry points:
# no expansion table, no sums buffer, the output zeroed by the caller
PARENT_SIG = {"povar_schur_diag2": [_P] * 6 + [_I, _I, _P],
              "povar_scatter2": [_P] * 7 + [_I, _I, _P],
              "povar_prepare2": [_P] * 11 + [_I] * 4 + [_F, _F, _P],
              "povar_prepare2_f64": [_P] * 11 + [_I] * 4 + [_D, _D, _P]}
# the opcodes counted in SASS: atomics, f64 arithmetic, the multi-
# function unit, barriers, shuffles and local-memory (spill) traffic
SASS_OPS = (r"\b(ATOMS\.[\w.]+|ATOM\.[\w.]+|RED\.[\w.]+|REDG\.[\w.]+|"
            r"ATOMG\.[\w.]+|"
            r"DFMA|DMUL|DADD|MUFU\.[\w.]+|BAR\.[\w.]+|SHFL\.[\w.]+|"
            r"STL(?:\.[\w.]+)?|LDL(?:\.[\w.]+)?)\b")


def _variant_dir(out: Path, src: Path, name: str, source: str,
                 edits) -> Path:
    """A copy of `src`'s `source` and pose_common.cuh in out/name with
    `edits` applied (each must match)."""
    d = out / name
    d.mkdir(parents=True, exist_ok=True)
    for f in (source, "pose_common.cuh"):
        shutil.copy(src / f, d / f)
    for f, pat, rep in edits:
        text = (d / f).read_text()
        new, n = re.subn(pat, rep, text, flags=re.S)
        if n == 0:
            raise RuntimeError(f"{name}: {pat!r} matches nothing in {f}")
        (d / f).write_text(new)
    return d


def build_all(parent: Path, source: str = "pose2.cu", out: Path = OUT,
              variants=None, parent_variants=None, entries=ENTRIES,
              parent_sig=None, sass_kernels=None):
    """Build the earlier `source` (from `parent`, with its own
    pose_common.cuh) and every variant of the package's, one nvcc each,
    in parallel, into `out`. The parent builds take `parent_sig` for
    their entry points (default: the package's), the variants the
    package's. Returns {name: ctypes library}."""
    from povar_tpu_torch.ops import _build

    variants = VARIANTS if variants is None else variants
    parent_variants = (PARENT_VARIANTS if parent_variants is None
                       else parent_variants)
    own = _build.CSRC
    dirs = {"parent": _variant_dir(out, parent, "parent", source, [])}
    dirs.update({n: _variant_dir(out, parent, n, source, e)
                 for n, e in parent_variants.items()})
    dirs.update({n: _variant_dir(out, own, n, source, e) for n, (e, _t) in
                 variants.items()})
    nvcc = _build._nvcc()
    procs = {n: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
         str(d / source)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for n, d in dirs.items()}
    libs = {}
    for n, p in procs.items():
        log = p.communicate(timeout=600)[0]
        (dirs[n] / "build.log").write_text(log)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc {n}:\n{log}")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"built {n}: {' | '.join(regs)}", flush=True)
        libs[n] = ctypes.CDLL(str(dirs[n] / "lib.so"))
    own_sig = {k: _build.SIGNATURES[k] for k in entries}
    for n, lib in libs.items():
        sig = ({**own_sig, **(parent_sig or {})} if n.startswith("parent")
               else own_sig)
        for k, argtypes in sig.items():
            getattr(lib, k).argtypes = argtypes
            getattr(lib, k).restype = ctypes.c_int
    sass_counts(dirs, SASS_KERNELS if sass_kernels is None else sass_kernels)
    return libs


def sass_counts(dirs, kernels) -> None:
    """The static counts of the SASS_OPS instructions the parent's and
    the package's kernels `kernels` ({label: regex of the mangled name})
    compile to (cuobjdump -sass: the loop body once, so per row where it
    is unrolled), or a note where cuobjdump is missing."""
    from povar_tpu_torch.ops import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        print("sass: no cuobjdump", flush=True)
        return
    for n, lib in (("parent", dirs["parent"] / "lib.so"),
                   ("package", _build.build())):
        sass = subprocess.run([str(tool), "-sass", str(lib)],
                              capture_output=True, text=True).stdout
        fn = None
        counts = {}
        for ln in sass.splitlines():
            m = re.search(r"Function : (\S+)", ln)
            if m:
                fn = next((k for k, sub in kernels.items()
                           if re.search(sub, m.group(1))), None)
                continue
            op = re.search(SASS_OPS, ln)
            if fn and op:
                counts.setdefault(fn, {})
                counts[fn][op.group(1)] = counts[fn].get(op.group(1), 0) + 1
        for fn, ops in sorted(counts.items()):
            print(f"sass ({n}) {fn}: {dict(sorted(ops.items()))}", flush=True)


def _variant_hppb2(lib):
    from povar_tpu_torch.ops import pose_kernels as pk
    from povar_tpu_torch.ops.pose_kernels import _ptr, _stream

    def run(cam, x4, mm, sw, r_w, jlns, hib, n):
        acc = torch.zeros(52 * n + 1, device=x4.device)
        hpp = torch.empty((144, n), device=x4.device)
        rc = lib.povar_hppb2(*map(_ptr, (
            cam, x4, mm, sw, r_w, jlns, hib,
            pk.moment_expand_table(x4.device), hpp, acc)), cam.shape[0], n,
            _stream(x4))
        assert rc == 0, rc
        return hpp, acc[:12 * n].view(12, n)
    return run


def _variant_e0(lib, threads):
    from povar_tpu_torch.ops.pose_kernels import _ptr, _stream, tile_rows

    def run(cam, x4, mm, sw, mat6, zt, parts, n):
        rows, tiles = tile_rows(parts, threads)
        table = torch.tensor(rows, dtype=torch.int32, device=x4.device)
        out = torch.zeros((12, n), device=x4.device)
        rc = lib.povar_e0_term2(*map(_ptr, (cam, x4, mm, sw, mat6, zt, table,
                                            out)), len(parts), tiles,
                                cam.shape[0], n, threads, _stream(x4))
        assert rc == 0, rc
        return out
    return run


def _error2(lib):
    """The package's pose_error2 entry point of `lib` (a variant's),
    with a ticket of its own; returns the plain version's dict."""
    from povar_tpu_torch.ops.pose_kernels import _ptr, _stream

    ticket = torch.zeros(1, dtype=torch.int32, device="cuda")

    def run(cam, ct, x4, uv, mask, *, robust, huber):
        o = cam.shape[0]
        n_part = -(-o // 256)
        part = torch.empty((7, n_part), dtype=torch.float64, device="cuda")
        sums = torch.empty(4, dtype=torch.float64, device="cuda")
        counts = torch.empty(2, dtype=torch.int64, device="cuda")
        ok = torch.empty((), dtype=torch.bool, device="cuda")
        rc = lib.povar_pose_error2(*map(_ptr, (
            cam, ct, x4, uv, mask, part, ticket, sums, counts, ok)), n_part,
            o, ct.shape[1], int(robust), float(huber), _stream(x4))
        assert rc == 0, rc
        return {"num_obs_all": counts[0], "error_all": sums[0],
                "residual_sum_all": sums[1], "num_obs_valid": counts[1],
                "error_valid": sums[2], "residual_sum_valid": sums[3],
                "is_numerically_valid": ok}
    return run


def own_scratch():
    """get(size, device): a zero f64 sums buffer of at least `size`
    entries, kept across calls (every call of a per-camera sums kernel
    leaves it zeroed, or, in a variant that gives wrong sums, as that
    variant leaves it)."""
    scratch = {}

    def get(size, device):
        if scratch.get("n", 0) < size:
            scratch.update(n=size, buf=torch.zeros(size, dtype=torch.float64,
                                                   device=device))
        return scratch["buf"]
    return get


def _schur2(lib):
    """The package's schur_diag2 entry point of `lib` (a variant's), with
    a sums buffer of its own (own_scratch)."""
    from povar_tpu_torch.ops import pose_kernels as pk

    sums = own_scratch()

    def run(cam, x4, mm, sw, mat6, n):
        out = torch.empty((144, n), device=x4.device)
        rc = lib.povar_schur_diag2(*map(pk._ptr, (
            cam, x4, mm, sw, mat6, pk.schur_expand_table(x4.device), out,
            sums(pk.SCHUR_MOMENTS * n + 1, x4.device))), cam.shape[0], n,
            pk._stream(x4))
        assert rc == 0, rc
        return out
    return run


def _parent_schur2(lib):
    """The earlier schur_diag2: the caller's zeroed output."""
    from povar_tpu_torch.ops.pose_kernels import _ptr, _stream

    def run(cam, x4, mm, sw, mat6, n):
        out = torch.zeros((144, n), device=x4.device)
        rc = lib.povar_schur_diag2(*map(_ptr, (cam, x4, mm, sw, mat6, out)),
                                   cam.shape[0], n, _stream(x4))
        assert rc == 0, rc
        return out
    return run


def _scatter2(lib):
    """The package's scatter2 entry point of `lib` (a variant's): out
    unzeroed, a sums buffer of its own."""
    from povar_tpu_torch.ops import pose_kernels as pk

    sums = own_scratch()

    def run(cam, x4, mm, sw, mat6, sb, n):
        out = torch.empty((12, n), device=x4.device)
        rc = lib.povar_scatter2(*map(pk._ptr, (
            cam, x4, mm, sw, mat6, sb, out,
            sums(pk.SCATTER_VALUES * n + 1, x4.device))), cam.shape[0], n,
            pk._stream(x4))
        assert rc == 0, rc
        return out
    return run


def _parent_scatter2(lib):
    """The earlier scatter2: the caller's zeroed output."""
    from povar_tpu_torch.ops.pose_kernels import _ptr, _stream

    def run(cam, x4, mm, sw, mat6, sb, n):
        out = torch.zeros((12, n), device=x4.device)
        rc = lib.povar_scatter2(*map(_ptr, (cam, x4, mm, sw, mat6, sb, out)),
                                cam.shape[0], n, _stream(x4))
        assert rc == 0, rc
        return out
    return run


def _prepare2(lib, parent=False):
    """The prepare2 entry point of `lib` (a variant's, or with `parent`
    the earlier one: jpsq zeroed by the caller, no sums buffer), f32 or
    f64 by the operands' dtype, with a sums buffer of its own."""
    from povar_tpu_torch.ops import pose_kernels as pk
    from povar_tpu_torch.ops.pose_math import ROBUST_HUBER

    sums = own_scratch()

    def run(cam, ct, x4, uv, mask, *, use_valid, robust, huber):
        o, n = cam.shape[0], ct.shape[1]
        outs = [torch.empty((r, c), dtype=x4.dtype, device=x4.device)
                for r, c in ((2, o), (1, o), (3, o), (8, o), (4, o))]
        outs.append((torch.zeros if parent else torch.empty)(
            (12, n), dtype=x4.dtype, device=x4.device))
        acc = () if parent else (pk._ptr(sums(8 * n + 1, x4.device)),)
        fn = (lib.povar_prepare2_f64 if x4.dtype == torch.float64
              else lib.povar_prepare2)
        rc = fn(*map(pk._ptr, (cam, ct, x4, uv, mask, *outs)), *acc, o, n,
                int(bool(use_valid)), int(robust == ROBUST_HUBER),
                float(huber), pk._huber2(huber, x4.dtype), pk._stream(x4))
        assert rc == 0, rc
        return tuple(outs)
    return run


def _prep2_state(problem):
    """prepare2's operands (cam, ct, x4, uv, mask) and use_valid on the
    homogenized VarProj initialization of `problem`'s cameras (the warm
    step-2 iteration's start; Stage2Solver._lin_core_s's)."""
    from povar_tpu_torch import (SolverOptions, Stage1Solver, Stage2Solver,
                                 create_homogeneous)

    opts = SolverOptions()
    args = (problem.obs_cam, problem.obs_lm, problem.obs_uv,
            problem.num_cameras, problem.num_landmarks)
    s1 = Stage1Solver(*args, opts, device="cuda")
    c = torch.as_tensor(problem.cam_space, device="cuda")
    cams_h, lms_h = create_homogeneous(c, s1.initialize_varproj(c))
    del s1
    s2 = Stage2Solver(*args, opts, device="cuda")
    sd = s2.solve_dtype
    x4 = s2._expand_L(s2._lm_rows(s2.lm_pack(lms_h)).to(sd))
    d = dict(cam=s2.obs.cam, ct=s2._cam_table(cams_h, sd), x4=x4,
             uv=s2._uv_s, mask=s2._mask1)
    return d, s2.use_valid_only


def _error2_operands(problem, cams_h, lms_h):
    """pose_error2's operands (cam, ct, x4, uv, mask) in f64 at (a) the
    venice-89 step-2 state, (b) the same state on the 1-device mesh
    solver's lanes, (c) N = 1024 cameras (the 89 repeated) drawn per row
    on (a)'s rows."""
    import chip_smoke as cs
    from povar_tpu_torch import SolverOptions, Stage2Solver

    def ops(s, lm):
        return (s.obs.cam, s._cam_table(cams_h, torch.float64),
                s._expand_L(s._lm_rows(s.lm_pack(lm)).to(torch.float64)),
                s.obs.uv, s._mask1)

    opts = SolverOptions()
    a = ops(cs.stage_solver(Stage2Solver, problem, opts), lms_h)
    sm = cs.stage_solver(Stage2Solver, problem, opts, mesh=True)
    b = ops(sm, sm.pad_landmarks(lms_h.cpu().numpy()))
    rng = np.random.default_rng(5)
    n = 1024
    cam = torch.as_tensor(rng.integers(0, n, a[0].shape[0]).astype(np.int32),
                          device="cuda")
    ct = a[1][:, torch.arange(n, device="cuda") % a[1].shape[1]].contiguous()
    return a, b, (cam, ct) + a[2:]


def _operands(problem):
    """The venice-89 step-2 operands of chip_smoke.check_kernels2 (the
    card's step-1 result, homogenized; seeded zt, mat6, hib), the fused
    term's parts, the 1-device mesh solver's step-2 operands (hib its
    landmark solve's at lambda 1e-4, mat6 seeded), and pose_error2's
    operands at (a)-(c) (_error2_operands)."""
    import chip_smoke as cs
    from povar_tpu_torch import SolverOptions, Stage2Solver, create_homogeneous

    opts = SolverOptions()
    _summary, (cams, lms), _s, _t = cs.solve(problem, opts, "cuda")
    cams_h, lms_h = create_homogeneous(cams, lms)
    s2 = cs.stage_solver(Stage2Solver, problem, opts)
    lin = s2.linearize(cams_h, s2.lm_pack(lms_h))
    rng = np.random.default_rng(1)
    o, n = int(s2.obs.cam.shape[0]), s2.n_cams

    def f32(*shape):
        return torch.as_tensor(rng.standard_normal(shape),
                               dtype=torch.float32, device="cuda")

    # prepare2's operands beside the others: its camera table, uv and mask
    d = dict(cam=s2.obs.cam, x4=lin.x4, mm=lin.mm, sw=lin.sw, r_w=lin.r_w,
             jlns=lin.jlns, hib=f32(3, o), mat6=f32(6, o), zt=f32(12, n),
             n=n, ct=lin.ct, uv=s2._uv_s, mask=s2._mask1)
    sm = cs.stage_solver(Stage2Solver, problem, opts, mesh=True)
    lm = sm.lm_pack(sm.pad_landmarks(lms_h.cpu().numpy()))
    ml = sm.linearize(cams_h, lm)
    mesh = dict(cam=sm.obs.cam, x4=ml.x4, mm=ml.mm, sw=ml.sw, r_w=ml.r_w,
                jlns=ml.jlns, hib=sm._prep_hll_s(ml, 1e-4)[1],
                mat6=f32(6, int(sm.obs.cam.shape[0])), n=n, ct=ml.ct,
                uv=sm._uv_s, mask=sm._mask1)
    # scatter2's re-expanded landmark sums, seeded (drawn last: the
    # operands above stay those of earlier trees' runs)
    d["sb"] = f32(3, o)
    mesh["sb"] = f32(3, int(sm.obs.cam.shape[0]))
    return (d, tuple(s2.e0_plan.parts), mesh,
            _error2_operands(problem, cams_h, lms_h))


def first_camera_rows(cam, parts) -> torch.Tensor:
    """The row order that sorts each slot part's landmarks by the camera
    of their first slot row (stable), all w rows of a landmark moving
    together, as the SPMD window plan packs landmarks: index rows [O]
    for operand[..., rows]; rows outside the parts stay in place."""
    rows = torch.arange(cam.shape[0], device=cam.device)
    for ofs, g, w in parts:
        perm = torch.argsort(cam[ofs:ofs + g].long(), stable=True)
        base = ofs + g * torch.arange(w, device=cam.device)[:, None]
        rows[(base + torch.arange(g, device=cam.device)).reshape(-1)] = (
            base + perm).reshape(-1)
    return rows


def _by_first_camera(d, parts):
    rows = first_camera_rows(d["cam"], parts)
    keys = ("cam", "x4", "mm", "sw", "r_w", "jlns", "hib", "mat6", "sb")
    return dict(d, **{k: d[k][..., rows].contiguous() for k in keys})


def _with_cameras(d, n, seed):
    """d on n seeded cameras (uniform over the rows) with a seeded zt."""
    rng = np.random.default_rng(seed)
    o = d["cam"].shape[0]
    return dict(d, n=n, cam=torch.as_tensor(
        rng.integers(0, n, o).astype(np.int32), device="cuda"),
        zt=torch.as_tensor(rng.standard_normal((12, n)), dtype=torch.float32,
                           device="cuda"))


def _tuple(out):
    if isinstance(out, dict):
        return tuple(out.values())
    return out if isinstance(out, tuple) else (out,)


def variant_kernels(name: str):
    """The kernels of this module a variant of VARIANTS is timed with."""
    if name in ERR_VARIANTS:
        return ("pose_error2",)
    if name in SCHUR_VARIANTS:
        return ("schur_diag2",)
    if name in SCATTER_VARIANTS or name.startswith("scatter2"):
        return ("scatter2",)
    if name in PREP2_VARIANTS:
        return ("prepare2",)
    if name.startswith("threads") or name == "block_atomics":
        return ("e0_term2_parts",)
    return ("hppb2", "e0_term2_parts") + (
        ("schur_diag2",) if name in SCHUR_COMMON else ()) + (
        ("scatter2",) if name in SCATTER_COMMON else ())


def kernels(parent: Path, only=None, final=False) -> None:
    import chip_smoke as cs
    from povar_tpu_torch import synthetic_bal_problem_fast
    from povar_tpu_torch.tools.large_scale import make_problem
    from povar_tpu_torch.ops import pose2_kernels as pk2
    from povar_tpu_torch.ops import pose2_ref as pr2

    wanted = {n: v for n, v in VARIANTS.items()
              if only is None or set(variant_kernels(n)) & set(only)}
    libs = build_all(parent, variants=wanted, parent_sig=PARENT_SIG)
    problem = synthetic_bal_problem_fast(cs.N_CAMS, cs.N_LMS, cs.OBS_PER_LM,
                                         seed=0)
    d, parts, mesh, err = _operands(problem)
    impls = {
        "hppb2": {"parent": _variant_hppb2(libs["parent"]),
                  "package": pk2.hppb2},
        "e0_term2_parts": {"parent": _variant_e0(libs["parent"], 512),
                           "package": pk2.e0_term2_parts},
        "pose_error2": {"parent": _error2(libs["parent"]),
                        "package": pk2.pose_error2},
        "schur_diag2": {"parent": _parent_schur2(libs["parent"]),
                        "package": pk2.schur_diag2},
        "scatter2": {"parent": _parent_scatter2(libs["parent"]),
                     "package": pk2.scatter2},
        "prepare2": {"parent": _prepare2(libs["parent"], parent=True),
                     "package": pk2.prepare2},
    }
    pna = libs["parent_no_atomics"]
    variants = {"hppb2": {"parent_no_atomics": _variant_hppb2(pna)},
                "e0_term2_parts": {"parent_no_atomics": _variant_e0(pna,
                                                                    512)},
                "pose_error2": {},
                "schur_diag2": {"parent_no_atomics": _parent_schur2(pna)},
                "scatter2": {"parent_no_atomics": _parent_scatter2(pna)},
                "prepare2": {"parent_no_atomics": _prepare2(pna, True)}}
    make = {"hppb2": lambda lib, _t: _variant_hppb2(lib),
            "e0_term2_parts": _variant_e0,
            "pose_error2": lambda lib, _t: _error2(lib),
            "schur_diag2": lambda lib, _t: _schur2(lib),
            "scatter2": lambda lib, _t: _scatter2(lib),
            "prepare2": lambda lib, _t: _prepare2(lib)}
    for name, (_e, threads) in wanted.items():
        for k in variant_kernels(name):
            variants[k][name] = make[k](libs[name], threads)

    def hpp_args(x):
        return tuple(x[k] for k in ("cam", "x4", "mm", "sw", "r_w", "jlns",
                                    "hib")) + (x["n"],)

    def e0_args(x):
        return tuple(x[k] for k in ("cam", "x4", "mm", "sw", "mat6",
                                    "zt")) + (parts, x["n"])

    def schur_args(x):
        return tuple(x[k] for k in ("cam", "x4", "mm", "sw", "mat6")) + (
            x["n"],)

    def scatter_args(x):
        return tuple(x[k] for k in ("cam", "x4", "mm", "sw", "mat6",
                                    "sb")) + (x["n"],)

    shapes = [
        ("hppb2", "(a) venice-89", hpp_args(d)),
        ("hppb2", "(b) mesh window order", hpp_args(mesh)),
        ("hppb2", "(c) N = 1024", hpp_args(_with_cameras(d, 1024, 1))),
        ("hppb2", "(c) N = 2048", hpp_args(_with_cameras(d, 2048, 2))),
        ("e0_term2_parts", "(a) venice-89", e0_args(d)),
        ("e0_term2_parts", "(b) by first camera",
         e0_args(_by_first_camera(d, parts))),
        ("e0_term2_parts", "(c) N = 1024", e0_args(_with_cameras(d, 1024, 3))),
        ("schur_diag2", "(a) venice-89", schur_args(d)),
        ("schur_diag2", "(b) mesh window order", schur_args(mesh)),
        ("schur_diag2", "(c) N = 1024, global route",
         schur_args(_with_cameras(d, 1024, 4))),
        ("scatter2", "(a) venice-89", scatter_args(d)),
        ("scatter2", "(b) mesh window order", scatter_args(mesh)),
        ("scatter2", "(c) N = 1024, shared copies",
         scatter_args(_with_cameras(d, 1024, 5))),
    ]
    def prep_args(x):
        return tuple(x[k] for k in ("cam", "ct", "x4", "uv", "mask"))

    def prep_cameras(x, n, seed):
        """x on n seeded cameras per row, the table's 89 repeated (as
        pose_error2's (c))."""
        rng = np.random.default_rng(seed)
        cam = torch.as_tensor(rng.integers(0, n, x["cam"].shape[0]).astype(
            np.int32), device="cuda")
        idx = torch.arange(n, device="cuda") % x["ct"].shape[1]
        return dict(x, cam=cam, ct=x["ct"][:, idx].contiguous())

    def f64(x):
        return dict(x, **{k: x[k].double() for k in ("ct", "x4", "uv")})

    prep_kw = dict(use_valid=True, robust=0, huber=1.0)
    prep = [("(a) venice-89", d), ("(b) mesh window order", mesh),
            ("(b) mesh window order, f64", f64(mesh)),
            ("(c) N = 1024, shared copies", prep_cameras(d, 1024, 6))]
    if only is None or "prepare2" in only:
        for n in (5000, cs.LARGE_N):
            x, _valid = _prep2_state(synthetic_bal_problem_fast(
                n, cs.LARGE_N_LMS, cs.OBS_PER_LM, seed=0, locality=64))
            prep.append((f"({'d' if n == 5000 else 'e'}) N = {n}, "
                         f"{x['cam'].shape[0]} slot rows", x))
        if final:
            x, _valid = _prep2_state(make_problem("final-13682"))
            prep.append((f"(f) final-13682, {x['cam'].shape[0]} slot rows",
                         x))
    shapes = [(k, label, args, {}) for k, label, args in shapes] + [
        ("prepare2", label, prep_args(x), prep_kw) for label, x in prep] + [
        ("pose_error2", f"{label}, {norm}", args,
         dict(robust=robust, huber=1.0))
        for label, args, norms in (
            ("(a) venice-89", err[0], ("NONE", "HUBER", "CAUCHY")),
            ("(b) mesh window order", err[1], ("NONE",)),
            ("(c) N = 1024", err[2], ("NONE",)))
        for robust, norm in enumerate(("NONE", "HUBER", "CAUCHY"))
        if norm in norms]
    print(f"fused-term parts {parts}; mesh lanes {mesh['cam'].shape[0]}",
          flush=True)
    ab_time([x for x in shapes if only is None or x[0] in only], impls,
            variants, pr2)


def ab_time(shapes, impls, variants, plain_mod) -> None:
    """For each (kernel, label, args, kwargs) of `shapes`: the parent's
    and the package's kernel (impls[kernel]) against the plain version
    (plain_mod.<kernel>) per camera (tools/parity.py, 1e-4), each result's
    error against the plain version in f64 on the same values printed
    (the plain version's own too); then device and event times of parent,
    package, package, parent and of each of variants[kernel]."""
    import chip_smoke as cs
    from povar_tpu_torch.tools.parity import scaled_error

    for kernel, label, args, kw in shapes:
        ref = getattr(plain_mod, kernel)
        plain = _tuple(ref(*args, **kw))
        # the plain version in f64 on the same values: each f32 result's
        # own error, the plain version's included
        exact = _tuple(ref(*(
            a.double() if torch.is_tensor(a) and a.is_floating_point() else a
            for a in args), **kw))
        for who, fn in [*impls[kernel].items(), ("plain", None)]:
            got = plain if fn is None else _tuple(fn(*args, **kw))
            torch.cuda.synchronize()
            # the outputs the plain version gives (a call without sums
            # skips some; an earlier kernel may still make them)
            pairs = [(g, w, x) for g, w, x in zip(got, plain, exact)
                     if w is not None]
            errs = [scaled_error(g, w, "cam") for g, w, _x in pairs]
            if not all(e <= 1e-4 for e in errs):
                raise AssertionError(f"{kernel} {label} {who}: {errs}")
            errs64 = [scaled_error(g, x, "cam") for g, _w, x in pairs]
            print(f"{kernel} {label} {who}: scaled error per camera "
                  f"{' '.join(f'{e:.1e}' for e in errs)}, against f64 "
                  f"{' '.join(f'{e:.1e}' for e in errs64)}", flush=True)
        times = {}

        def timed(fn):
            return (cs.device_us(lambda: fn(*args, **kw)),
                    cs.cuda_ms(lambda: fn(*args, **kw)))
        for who in ("parent", "package", "package", "parent"):
            times.setdefault(who, []).append(timed(impls[kernel][who]))
        for who, fn in variants[kernel].items():
            try:
                times[who] = [timed(fn)]
            except AssertionError as e:  # a launch the shape does not fit
                print(f"{kernel} {label} {who}: no launch ({e})", flush=True)
        for who, ts in times.items():
            dev = " / ".join(f"{t[0]:.1f}" for t in ts)
            ev = " / ".join(f"{t[1] * 1e3:.1f}" for t in ts)
            print(f"{kernel} {label} {who}: device {dev} us, events {ev} us",
                  flush=True)
        for who in ("parent", "package"):
            ops = device_ops(lambda: impls[kernel][who](*args, **kw))
            print(f"{kernel} {label} {who} device operations: " + ", ".join(
                f"{name[:48]} {us:.1f} us" for name, us in ops), flush=True)


def device_ops(fn, reps: int = 20):
    """[(name, device us per call)] of every device operation of one call
    of `fn` (torch.profiler over `reps` calls), the longest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by[e.name] = by.get(e.name, 0.0) + e.time_range.elapsed_us() / reps
    return sorted(by.items(), key=lambda kv: -kv[1])


def bench() -> None:
    """The warm step-1 and step-2 bench iterations with SolverOptions()
    defaults, on one device and on a 1-device mesh."""
    import chip_smoke as cs
    from povar_tpu_torch import SolverOptions, synthetic_bal_problem_fast

    problem = synthetic_bal_problem_fast(cs.N_CAMS, cs.N_LMS, cs.OBS_PER_LM,
                                         seed=0)
    opts = SolverOptions()
    cs.bench_step1(problem, opts, "step-1 defaults")
    cs.bench_step1(problem, opts, "step-1 spmd (1-device mesh)", mesh=True)
    cs.bench_step2(problem, opts, "step-2 defaults")
    cs.bench_step2(problem, opts, "step-2 spmd (1-device mesh)", mesh=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    k = sub.add_parser("kernels")
    k.add_argument("--parent", type=Path, required=True,
                   help="directory with the earlier pose2.cu and "
                   "pose_common.cuh")
    k.add_argument("--kernels", nargs="+", default=None,
                   help="time only these kernels (default: all)")
    k.add_argument("--final", action="store_true",
                   help="also prepare2 on the whole final-13682's step-2 "
                   "start (f)")
    sub.add_parser("bench")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pose2_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path.cwd()))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if args.mode == "kernels":
        kernels(args.parent, args.kernels, args.final)
    else:
        bench()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""`prepare`, `hpp_b_structured`, `e0_term_parts`,
`schur_diag_structured` and `e0_scatter_structured` against an earlier
version of their kernels, and against controlled variants of their own,
on one card; the spreads of the solves the Schur-Jacobi kernels' and
the composed-term scatters' rounding can move.

    python -m povar_tpu_torch.tools.pose1_ab kernels --parent DIR
        [--kernels NAME ...]
    python -m povar_tpu_torch.tools.pose1_ab bench
    python -m povar_tpu_torch.tools.pose1_ab psc --parent DIR --runs N
    python -m povar_tpu_torch.tools.pose1_ab pcg --parent DIR --runs N
        [--witness M] [--psc K]
    python -m povar_tpu_torch.tools.pose1_ab spread --parent DIR --runs N

The step-1 counterpart of tools/pose2_ab.py, with its builds, variants
and timing loop. Run from the repository root (`chip_smoke.py` lends its
timers, its operands and its bench iteration). `kernels` builds
DIR/pose1.cu with DIR/pose_common.cuh (an earlier commit's csrc/ whose
entry points take the package's arguments except `povar_schur_diag`
and `povar_e0_scatter`, which take PARENT_SIG's: no expansion table or
sums buffer, the output zeroed by the caller) and the variants of the package's own csrc/ that
concern the kernels asked for, one nvcc each, all started together, into
build/pose1_ab/, and prints their SASS opcode counts. It then times each
kernel in turns (earlier, package, package, earlier; then the
variants), checking the earlier and the package kernel against the plain
version per camera, at

  (a) venice-89: O = 557,056 slot rows, N = 89, chip_smoke.kernel_inputs
      (the problem's slot layout, seeded operands); prepare with and
      without its per-camera sums;
  (b) the camera-sorted orders: prepare, hpp_b_structured,
      schur_diag_structured and e0_scatter_structured on the 1-device
      mesh solver's own step-1 operands (the SPMD window order, 598,016
      lanes), the fused term on (a)'s operands with each part's
      landmarks sorted by first camera;
  (c) N = 1024 seeded cameras on the venice-89 rows (schur_diag_
      structured's global route, e0_scatter_structured's shared copies),
      and N = 2048 for hpp_b_structured (its global-memory route)

((b) and (c) are chip_smoke.kernels1_shapes). `bench` prints the warm
step-1 and step-2 bench iterations (as pose2_ab's `bench`, and with the
composed term) for the
package tree in the current directory; run it in each tree to compare, for
instance `(cd DIR && PYTHONPATH=. python <repo>/povar_tpu_torch/tools/
pose1_ab.py bench)`. `psc` runs N POWER_SCHUR_COMPLEMENT step-1 solves
with the package's prepare and with the earlier one. `pcg` runs, with
the package's Schur-Jacobi kernels (both steps') and with the earlier
ones in turns, the solves whose bands they can move: N PCG step-1 solves
(chip_smoke.py's PCG_BAND and first PCG_SAME CG counts), K PSC + RIPCG
`bundle_adjust` runs on one device and K on a 1-device mesh (step 2
below PSC_STEP2_MAX) and M card runs of the
RIPCG step-2 witness against one CPU run from one step-1 state
(tools/step2_spread.py: decisions and counts as the CPU's, costs within
WITNESS_TOLS). `spread` runs, with the package's composed-term scatters
(both steps') and with the earlier ones in turns, N of each step-1 solve
they carry: the composed term on one device, the defaults and PSC on a
1-device mesh (~1 s each).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

import torch

OUT = Path("build") / "pose1_ab"
_P, _I = ctypes.c_void_p, ctypes.c_int
# the earlier pose1.cu's Schur-Jacobi and scatter entry points: no
# expansion table, no sums buffer
PARENT_SIG = {"povar_schur_diag": [_P] * 4 + [_I, _I, _P],
              "povar_e0_scatter": [_P] * 5 + [_I, _I, _P]}
ENTRIES = ("povar_prepare", "povar_hpp_b", "povar_e0_term",
           "povar_schur_diag", "povar_e0_scatter")
SASS_KERNELS = {"prepare": r"pose1_cu.*prepare_kernel",
                "hpp_b": r"pose1_cu.*hpp_b_kernel",
                "e0_term": r"pose1_cu.*e0_term_",
                # the earlier kernel (one name), else route 0 / 1 / 2:
                # per-warp, shared and global (pose_common.cuh Route)
                **{f"schur_diag route {r}":
                   rf"pose1_cu.*schur_diag_kernelILN5povar5RouteE{r}E"
                   for r in range(3)},
                "schur_diag": r"pose1_cu.*schur_diag_kernel",
                **{f"e0_scatter route {r}":
                   rf"pose1_cu.*e0_scatter_kernelILN5povar5RouteE{r}E"
                   for r in range(3)},
                "e0_scatter": r"pose1_cu.*e0_scatter_kernel"}
# variants that concern one kernel only
PREP_ONLY = {"prep_block_acc", "prep_shared512", "prep_free_regs",
             "prep256", "prep1024", "prep_no_rw", "prep_no_scatter"}
HPP_ONLY = {"table_shared", "global_moments"}
E0_ONLY = {"block_atomics", "threads256", "threads1024"}


def variants():
    """pose2_ab's common variants of pose1.cu (no_flush also leaves out
    prepare's flush) and its SCHUR_VARIANTS (pose_common.cuh's
    Schur-Jacobi pass), two other routes of hpp_b_structured: the camera
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
    # pose1.cu's per-camera adds are all pose_common.cuh's now
    edits, threads = common["no_adds"]
    common["no_adds"] = ([e for e in edits if e[0] != "pose1.cu"], threads)
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
        **{n: (e, 512) for n, e in ab.SCHUR_VARIANTS.items()},
        **{n: (e, 512) for n, e in ab.SCATTER_VARIANTS.items()},
    }


def variant_kernels(name: str):
    """The kernels of this module a variant of variants() is timed with."""
    from povar_tpu_torch.tools import pose2_ab as ab

    if name in PREP_ONLY:
        return ("prepare",)
    if name in HPP_ONLY:
        return ("hpp_b_structured",)
    if name in E0_ONLY:
        return ("e0_term_parts",)
    if name in ab.SCHUR_VARIANTS:
        return ("schur_diag_structured",)
    if name in ab.SCATTER_VARIANTS:
        return ("e0_scatter_structured",)
    return ("prepare", "hpp_b_structured", "e0_term_parts") + (
        ("schur_diag_structured",) if name in ab.SCHUR_COMMON else ()) + (
        ("e0_scatter_structured",) if name in ab.SCATTER_COMMON else ())


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


def _schur(lib):
    """The package's schur_diag_structured entry point of `lib` (a
    variant's), with a sums buffer of its own (pose2_ab.own_scratch)."""
    from povar_tpu_torch.ops import pose_kernels as pk
    from povar_tpu_torch.tools import pose2_ab as ab

    sums = ab.own_scratch()

    def run(cam, x, h, n):
        out = torch.empty((144, n), device=x.device)
        rc = lib.povar_schur_diag(*map(pk._ptr, (
            cam, x, h, pk.schur_expand_table(x.device), out,
            sums(pk.SCHUR_MOMENTS * n + 1, x.device))), cam.shape[0], n,
            pk._stream(x))
        assert rc == 0, rc
        return out
    return run


def _parent_schur(lib):
    """The earlier schur_diag_structured: the caller's zeroed output."""
    from povar_tpu_torch.ops import pose_kernels as pk

    def run(cam, x, h, n):
        out = torch.zeros((144, n), device=x.device)
        rc = lib.povar_schur_diag(*map(pk._ptr, (cam, x, h, out)),
                                  cam.shape[0], n, pk._stream(x))
        assert rc == 0, rc
        return out
    return run


def _scatter(lib):
    """The package's e0_scatter_structured entry point of `lib` (a
    variant's): out unzeroed, a sums buffer of its own."""
    from povar_tpu_torch.ops import pose_kernels as pk
    from povar_tpu_torch.tools import pose2_ab as ab

    sums = ab.own_scratch()

    def run(cam, x, h, sb, n):
        out = torch.empty((12, n), device=x.device)
        rc = lib.povar_e0_scatter(*map(pk._ptr, (
            cam, x, h, sb, out, sums(pk.SCATTER_VALUES * n + 1, x.device))),
            cam.shape[0], n, pk._stream(x))
        assert rc == 0, rc
        return out
    return run


def _parent_scatter(lib):
    """The earlier e0_scatter_structured: the caller's zeroed output."""
    from povar_tpu_torch.ops import pose_kernels as pk

    def run(cam, x, h, sb, n):
        out = torch.zeros((12, n), device=x.device)
        rc = lib.povar_e0_scatter(*map(pk._ptr, (cam, x, h, sb, out)),
                                  cam.shape[0], n, pk._stream(x))
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

    var = {n: v for n, v in variants().items()
           if only is None or set(variant_kernels(n)) & set(only)}
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
        ("schur_diag_structured", "(a) venice-89",
         tuple(d[k] for k in ("cam", "x", "h")) + (solver.n_cams,), {}),
        ("e0_scatter_structured", "(a) venice-89",
         tuple(d[k] for k in ("cam", "x", "h", "sb")) + (solver.n_cams,),
         {}),
    ] + [(k, label, args, kw) for k, label, args, kw, *_rest in
         cs.kernels1_shapes(problem, solver, d, opts.alpha)]
    shapes.sort(key=lambda s: s[0])
    pna = libs["parent_no_atomics"]
    impls = {
        "prepare": {"parent": _prepare(libs["parent"]),
                    "package": pk.prepare},
        "hpp_b_structured": {"parent": _hpp(libs["parent"]),
                             "package": pk.hpp_b_structured},
        "e0_term_parts": {"parent": _e0(libs["parent"], 512),
                          "package": pk.e0_term_parts},
        "schur_diag_structured": {"parent": _parent_schur(libs["parent"]),
                                  "package": pk.schur_diag_structured},
        "e0_scatter_structured": {"parent": _parent_scatter(libs["parent"]),
                                  "package": pk.e0_scatter_structured},
    }
    make = {"prepare": lambda lib, _t: _prepare(lib),
            "hpp_b_structured": lambda lib, _t: _hpp(lib),
            "e0_term_parts": _e0,
            "schur_diag_structured": lambda lib, _t: _schur(lib),
            "e0_scatter_structured": lambda lib, _t: _scatter(lib)}
    timed = {"prepare": {"parent_no_atomics": _prepare(pna)},
             "hpp_b_structured": {"parent_no_atomics": _hpp(pna)},
             "e0_term_parts": {"parent_no_atomics": _e0(pna, 512)},
             "schur_diag_structured": {
                 "parent_no_atomics": _parent_schur(pna)},
             "e0_scatter_structured": {
                 "parent_no_atomics": _parent_scatter(pna)}}
    for n, (_e, t) in var.items():
        for k in variant_kernels(n):
            timed[k][n] = make[k](libs[n], t)
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
    for who, fn in (("package", own), ("parent", _prepare(libs["parent"]))):
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


def _on_card(plain, card):
    """`card` for CUDA tensors, the plain version `plain` for CPU ones (as
    the package's wrappers dispatch)."""
    def run(cam, *args):
        return (plain if cam.device.type == "cpu" else card)(cam, *args)
    return run


def pcg(parent: Path, runs: int, witness: int, psc_runs: int) -> None:
    """`runs` rounds, the earlier Schur-Jacobi kernels (DIR's pose1.cu and
    pose2.cu) and the package's in turns (the earlier first in even
    rounds), each tree running in a round one venice-89 PCG step-1 solve
    (SolverOptions() defaults otherwise: chip_smoke.py's PCG_BAND x
    JAX_PCG_COST and the first PCG_SAME CG counts), in the first
    `psc_runs` rounds one PSC + RIPCG `bundle_adjust` on one device and
    one on a 1-device mesh (whose window order puts a warp on one camera:
    schur_diag2's reduce-scatter tree; step 2 below PSC_STEP2_MAX, 100x
    below its start) and, in the first `witness`
    rounds, one card run of the RIPCG step-2
    witness (tools/step2_spread.step2_witness) from one composed-term
    step-1 state, held against one CPU run from that state (decisions and
    accepted trials' CG counts equal, initial cost within 1e-12, accepted
    costs within WITNESS_TOLS). Prints each run and, per tree, the runs
    outside each band."""
    import chip_smoke as cs
    from povar_tpu_torch import (SolverOptions, SolverSummary, Stage1Solver,
                                 Timer, create_homogeneous, from_numpy,
                                 optimize_step1, synthetic_bal_problem_fast)
    from povar_tpu_torch.ops import pose2_kernels as pk2
    from povar_tpu_torch.ops import pose2_ref as pr2
    from povar_tpu_torch.ops import pose_kernels as pk
    from povar_tpu_torch.ops import pose_ref as pr
    from povar_tpu_torch.options import SolverType, SolverTypeRiemannian
    from povar_tpu_torch.tools import pose2_ab as ab
    from povar_tpu_torch.tools.step2_spread import (
        WITNESS_TOLS, _record, step2_witness, witness_gaps)

    lib1 = _build_all(parent)["parent"]
    lib2 = ab.build_all(parent, "pose2.cu", ab.OUT, {}, {},
                        ("povar_schur_diag2",), ab.PARENT_SIG, {})["parent"]
    kernels = {
        "package": (pk.schur_diag_structured, pk2.schur_diag2),
        "parent": (_on_card(pr.schur_diag_structured, _parent_schur(lib1)),
                   _on_card(pr2.schur_diag2, ab._parent_schur2(lib2))),
    }
    problem = synthetic_bal_problem_fast(cs.N_CAMS, cs.N_LMS, cs.OBS_PER_LM,
                                         seed=0)
    args = (problem.obs_cam, problem.obs_lm, problem.obs_uv,
            problem.num_cameras, problem.num_landmarks)
    popts = SolverOptions(solver_type_step_1=SolverType.PCG)
    stage1 = Stage1Solver(*args, popts, device="cuda")
    psc = SolverOptions(solver_type_step_1=SolverType.POWER_SCHUR_COMPLEMENT,
                        solver_type_step_2=SolverTypeRiemannian.RIPCG)
    ripcg = SolverOptions(solver_type_step_2=SolverTypeRiemannian.RIPCG)
    cams_h = lms_h = None
    if witness:
        # the witness's start: a composed-term step-1 solve (no Schur
        # kernel), and the CPU's run from it, shared by both trees
        _s, (c1, l1), _t0, _t1 = cs.solve(
            problem, SolverOptions(fused_power_term=False), "cuda")
        cams_h, lms_h = create_homogeneous(c1, l1)
        _a, cpu = step2_witness(problem, ripcg, cams_h, lms_h,
                                runs_on=(("cpu", "cpu"),))
    lo, hi = (b * cs.JAX_PCG_COST for b in cs.PCG_BAND)
    want_cg = cs.JAX_PCG_CG[1:cs.PCG_SAME + 1]
    out = {who: dict(band=0, cg=0, psc=0, mesh=0, witness=0)
           for who in kernels}
    own = kernels["package"]
    try:
        for k in range(runs):
            for who in (("parent", "package") if k % 2 == 0
                        else ("package", "parent")):
                pk.schur_diag_structured, pk2.schur_diag2 = kernels[who]
                _p, c0, l0 = from_numpy(problem.obs_cam, problem.obs_lm,
                                        problem.obs_uv, problem.cam_space,
                                        problem.lm_p, device="cuda")
                s = SolverSummary()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                optimize_step1(stage1, c0, l0, popts, s, Timer(),
                               log=lambda _s: None)
                torch.cuda.synchronize()
                rec = _record(f"pcg {who} {k}", s, time.perf_counter() - t0)
                out[who]["band"] += not lo <= rec["final"] <= hi
                out[who]["cg"] += rec["terms"][:cs.PCG_SAME] != want_cg
                ratio = rec["final"] / cs.JAX_PCG_COST
                print(f"pcg {who} {k}: final {ratio:.4f}x JAX, CG counts "
                      f"{rec['terms']}", flush=True)
                for mesh in ((False, True) if k < psc_runs else ()):
                    _o, q1, q2, _t = cs.pipeline(problem, psc, "cuda",
                                                 mesh=mesh)
                    e1, e2 = q1.final_cost.all.error, q2.final_cost.all.error
                    start2 = q2.initial_cost.all.error
                    out[who]["mesh" if mesh else "psc"] += not (
                        e2 < cs.PSC_STEP2_MAX
                        and e2 <= cs.STEP2_DROP * start2)
                    print(f"psc+ripcg{' mesh' if mesh else ''} {who} {k}: "
                          f"step 1 {e1!r}, step 2 {start2:.6e} -> {e2!r}",
                          flush=True)
                if k < witness:
                    _a, card = step2_witness(problem, ripcg, cams_h, lms_h,
                                             runs_on=((who, "cuda"),))
                    same, init, gaps = witness_gaps(
                        {**cpu, **card}, counts_when_rejected=False)[who]
                    out[who]["witness"] += not (
                        same and init <= 1e-12
                        and all(x <= t for x, t in zip(gaps, WITNESS_TOLS)))
                    traj = card[who][0]
                    seq = "".join("A" if ok else "R" for ok, _n, _c in traj[1:])
                    print(f"witness {who} {k}: {seq} terms "
                          f"{[n for _ok, n, _c in traj[1:]]}, same decisions "
                          f"{same}, initial gap {init:.2e}, accepted gaps "
                          f"{[f'{x:.2e}' for x in gaps]}", flush=True)
    finally:
        pk.schur_diag_structured, pk2.schur_diag2 = own
    for who, n in out.items():
        print(f"pcg spread {who}: {runs} PCG step-1 solves, {n['band']} "
              f"past PCG_BAND {cs.PCG_BAND}, {n['cg']} with other first "
              f"{cs.PCG_SAME} CG counts than {want_cg}; {min(runs, psc_runs)} "
              f"PSC + RIPCG runs on one device and on a 1-device mesh, "
              f"{n['psc']} / {n['mesh']} with step 2 not below "
              f"{cs.PSC_STEP2_MAX}; "
              f"{min(runs, witness)} RIPCG witnesses, {n['witness']} off "
              f"the CPU's", flush=True)


def spread(parent: Path, runs: int) -> None:
    """`runs` rounds, the earlier composed-term scatters (DIR's pose1.cu
    and pose2.cu: e0_scatter_structured, scatter2) and the package's in
    turns (the earlier first in even rounds), each tree running in a
    round one venice-89 step-1 solve of each solve those scatters carry:
    the composed term on one device and SolverOptions() defaults on a
    1-device mesh (no fused plan there: the composed term), each held to
    1e-3 of JAX_FINAL_COST, and POWER_SCHUR_COMPLEMENT on a 1-device mesh
    (chip_smoke.py's PSC_BAND x JAX_PSC_COST). Prints each run and, per
    tree and solve, the runs outside its band and the finals' range."""
    import chip_smoke as cs
    from povar_tpu_torch import (SolverOptions, SolverSummary, Stage1Solver,
                                 Timer, from_numpy, optimize_step1,
                                 synthetic_bal_problem_fast)
    from povar_tpu_torch.ops import pose2_kernels as pk2
    from povar_tpu_torch.ops import pose2_ref as pr2
    from povar_tpu_torch.ops import pose_kernels as pk
    from povar_tpu_torch.ops import pose_ref as pr
    from povar_tpu_torch.options import SolverType
    from povar_tpu_torch.tools import pose2_ab as ab
    from povar_tpu_torch.tools.step2_spread import JAX_PSC_COST, _record

    lib1 = _build_all(parent)["parent"]
    lib2 = ab.build_all(parent, "pose2.cu", ab.OUT, {}, {},
                        ("povar_scatter2",), ab.PARENT_SIG, {})["parent"]
    kernels = {
        "package": (pk.e0_scatter_structured, pk2.scatter2),
        "parent": (_on_card(pr.e0_scatter_structured, _parent_scatter(lib1)),
                   _on_card(pr2.scatter2, ab._parent_scatter2(lib2))),
    }
    problem = synthetic_bal_problem_fast(cs.N_CAMS, cs.N_LMS, cs.OBS_PER_LM,
                                         seed=0)
    vp = (1.0 - 1e-3, 1.0 + 1e-3)
    solves = []
    for label, opts, mesh, band, cost in (
            ("composed", SolverOptions(fused_power_term=False), False, vp,
             cs.JAX_FINAL_COST),
            ("mesh defaults", SolverOptions(), True, vp, cs.JAX_FINAL_COST),
            ("mesh psc", SolverOptions(
                solver_type_step_1=SolverType.POWER_SCHUR_COMPLEMENT), True,
             cs.PSC_BAND, JAX_PSC_COST)):
        solves.append((label, cs.stage_solver(Stage1Solver, problem, opts,
                                              mesh), opts, mesh, band, cost))
    finals = {(who, label): [] for who in kernels for label, *_r in solves}
    own = kernels["package"]
    try:
        for k in range(runs):
            for who in (("parent", "package") if k % 2 == 0
                        else ("package", "parent")):
                pk.e0_scatter_structured, pk2.scatter2 = kernels[who]
                for label, stage1, opts, mesh, band, cost in solves:
                    _p, c0, l0 = from_numpy(
                        problem.obs_cam, problem.obs_lm, problem.obs_uv,
                        problem.cam_space, problem.lm_p, device="cuda")
                    if mesh:
                        l0 = stage1.pad_landmarks(problem.lm_p)
                    s = SolverSummary()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    optimize_step1(stage1, c0, l0, opts, s, Timer(),
                                   log=lambda _s: None)
                    torch.cuda.synchronize()
                    rec = _record(f"{label} {who} {k}", s,
                                  time.perf_counter() - t0)
                    finals[(who, label)].append(rec["final"] / cost)
    finally:
        pk.e0_scatter_structured, pk2.scatter2 = own
    for label, _s, _o, _m, (lo, hi), cost in solves:
        for who in kernels:
            r = sorted(finals[(who, label)])
            out = sum(not lo <= x <= hi for x in r)
            print(f"spread {label} {who}: {out} of {len(r)} outside "
                  f"[{lo}, {hi}] x {cost}, finals {r[0]:.6f}x .. "
                  f"{r[-1]:.6f}x (median {r[len(r) // 2]:.6f}x)",
                  flush=True)


def bench() -> None:
    """pose2_ab.bench's iterations, in this file so that running it as a
    script in an earlier tree (whose pose2_ab may print less) prints
    them too."""
    import chip_smoke as cs
    from povar_tpu_torch import SolverOptions, synthetic_bal_problem_fast

    problem = synthetic_bal_problem_fast(cs.N_CAMS, cs.N_LMS, cs.OBS_PER_LM,
                                         seed=0)
    opts = SolverOptions()
    composed = SolverOptions(fused_power_term=False)
    for step, label in ((cs.bench_step1, "step-1"), (cs.bench_step2,
                                                     "step-2")):
        step(problem, opts, f"{label} defaults")
        step(problem, composed, f"{label} composed")
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
    g = sub.add_parser("pcg")
    g.add_argument("--parent", type=Path, required=True,
                   help="directory with the earlier pose1.cu, pose2.cu and "
                   "pose_common.cuh")
    g.add_argument("--runs", type=int, default=12)
    g.add_argument("--witness", type=int, default=4,
                   help="rounds that also run the RIPCG step-2 witness")
    g.add_argument("--psc", type=int, default=12,
                   help="rounds that also run PSC + RIPCG bundle_adjust, on "
                   "one device and on a 1-device mesh")
    r = sub.add_parser("spread")
    r.add_argument("--parent", type=Path, required=True,
                   help="directory with the earlier pose1.cu, pose2.cu and "
                   "pose_common.cuh")
    r.add_argument("--runs", type=int, default=48)
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
    elif args.mode == "pcg":
        pcg(args.parent, args.runs, args.witness, args.psc)
    elif args.mode == "spread":
        spread(args.parent, args.runs)
    else:
        bench()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""`hpp_b_structured` and `e0_term_parts` against an earlier version of
their kernels, and against controlled variants of their own, on one card.

    python -m povar_tpu_torch.tools.pose1_ab kernels --parent DIR
    python -m povar_tpu_torch.tools.pose1_ab bench

The step-1 counterpart of tools/pose2_ab.py, with its builds, variants
and timing loop. Run from the repository root (`chip_smoke.py` lends its
timers, its operands and its bench iteration). `kernels` builds
DIR/pose1.cu with DIR/pose_common.cuh (an earlier commit's csrc/ whose
two entry points take PARENT_SIG: the per-row atomics and the part table
of one thread per landmark) and the variants of the package's own
csrc/, one nvcc each, all started together, into build/pose1_ab/. It
then times each kernel in turns (earlier, package, package, earlier;
then the variants), checking the earlier and the package kernel against
the plain version per camera, at

  (a) venice-89: O = 557,056 slot rows, N = 89, chip_smoke.kernel_inputs
      (the problem's slot layout, seeded operands);
  (b) the camera-sorted orders: hpp_b_structured on the 1-device mesh
      solver's own step-1 operands (the SPMD window order, 598,016
      lanes), the fused term on (a)'s operands with each part's
      landmarks sorted by first camera;
  (c) N = 1024 seeded cameras on the venice-89 rows, and N = 2048 for
      hpp_b_structured (its global-memory route)

((b) and (c) are chip_smoke.kernels1_shapes). `bench` prints the warm
step-1 bench iteration (chip_smoke.bench_step1: launches, wall time,
device time by kernel) with SolverOptions() defaults on one device and
on a 1-device mesh, for the package tree in the current directory; run
it in each tree to compare, for instance `(cd DIR && PYTHONPATH=.
python <repo>/povar_tpu_torch/tools/pose1_ab.py bench)`.
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
# the earlier pose1.cu's entry points: hpp_b without the moment buffer
# and its expansion table, the fused term over (ofs, g, w, first
# landmark) parts with a landmark count
PARENT_SIG = {"povar_hpp_b": [_P] * 10 + [_I, _I, _F, _F, _F, _P],
              "povar_e0_term": [_P] * 6 + [_I] * 4 + [_P]}
# variants that concern one kernel only
HPP_ONLY = {"table_shared", "global_moments"}
E0_ONLY = {"block_atomics", "threads256", "threads1024"}


def variants():
    """pose2_ab's common variants of pose1.cu, and two other routes of
    hpp_b_structured: the camera table staged in shared memory beside the
    accumulators (`table_shared`, while 64 N floats fit) and every value
    to a global atomic at every N (`global_moments`)."""
    from povar_tpu_torch.tools import pose2_ab as ab

    return {
        **ab.common_variants("pose1.cu",
                             r"povar::flush_acc\(acc_g, acc, [^;]+;"),
        "table_shared": ([
            ("pose1.cu", r"P\[k\] = __ldg\(ct \+ k \* n_cams \+ c\);",
             "P[k] = kShared ? smem[(kMomentRows + k) * n_cams + c]"
             " : __ldg(ct + k * n_cams + c);"),
            ("pose1.cu", r"(\n    povar::smem_zero\(acc, kMomentRows \* "
             r"n_cams\);)",
             r"\n    povar::smem_copy(smem + kMomentRows * n_cams, ct, "
             r"12 * n_cams);\1"),
            ("pose1.cu", r"moments = sizeof\(float\) \* kMomentRows \*",
             "moments = sizeof(float) * (kMomentRows + 12) *"),
        ], 512),
        "global_moments": ([("pose1.cu", r"if \(moments <= \(size_t\)"
                             r"max_optin_smem\(\)\)", "if (false)")], 512),
    }


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


def _parent_hpp(lib):
    from povar_tpu_torch.ops import pose_kernels as pk
    from povar_tpu_torch.ops.pose_ref import pose_consts

    def run(cam, ct, x, uv, sw, r_w, jls, hib, n, *, alpha):
        c = pose_consts(alpha, torch.float32)
        hpp = torch.zeros((144, n), device=x.device)
        b = torch.zeros((12, n), device=x.device)
        rc = lib.povar_hpp_b(*map(pk._ptr, (cam, ct, x, uv, sw, r_w, jls,
                                            hib, hpp, b)), cam.shape[0], n,
                             c.sp, c.sa, c.sp2, pk._stream(x))
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


def _parent_e0(lib):
    from povar_tpu_torch.ops import pose_kernels as pk

    def run(cam, x, h, z, parts, n):
        rows, first = [], 0
        for ofs, g, w in parts:
            rows += [ofs, g, w, first]
            first += g
        table = torch.tensor(rows, dtype=torch.int32, device=x.device)
        out = torch.zeros((12, n), device=x.device)
        rc = lib.povar_e0_term(*map(pk._ptr, (cam, x, h, z, table, out)),
                               len(parts), first, cam.shape[0], n,
                               pk._stream(x))
        assert rc == 0, rc
        return out
    return run


def kernels(parent: Path) -> None:
    import chip_smoke as cs
    from povar_tpu_torch import (SolverOptions, Stage1Solver,
                                 synthetic_bal_problem_fast)
    from povar_tpu_torch.ops import pose_kernels as pk
    from povar_tpu_torch.ops import pose_ref as pr
    from povar_tpu_torch.tools import pose2_ab as ab

    var = variants()
    libs = ab.build_all(
        parent, "pose1.cu", OUT, var,
        {"parent_no_atomics": [("pose1.cu", *ab.NO_ATOMICS)]},
        ("povar_hpp_b", "povar_e0_term"), PARENT_SIG,
        {"hpp_b": r"pose1_cu.*hpp_b_kernel", "e0_term": r"pose1_cu.*e0_term_"})
    problem = synthetic_bal_problem_fast(cs.N_CAMS, cs.N_LMS, cs.OBS_PER_LM,
                                         seed=0)
    opts = SolverOptions()
    solver = cs.stage_solver(Stage1Solver, problem, opts)
    d = cs.kernel_inputs(solver, problem)
    parts = solver.e0_plan.parts
    a = dict(alpha=opts.alpha)
    shapes = [
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
        "hpp_b_structured": {"parent": _parent_hpp(libs["parent"]),
                             "package": pk.hpp_b_structured},
        "e0_term_parts": {"parent": _parent_e0(libs["parent"]),
                          "package": pk.e0_term_parts},
    }
    timed = {
        "hpp_b_structured": {
            "parent_no_atomics": _parent_hpp(libs["parent_no_atomics"]),
            **{n: _hpp(libs[n]) for n in var if n not in E0_ONLY}},
        "e0_term_parts": {
            "parent_no_atomics": _parent_e0(libs["parent_no_atomics"]),
            **{n: _e0(libs[n], t) for n, (_e, t) in var.items()
               if n not in HPP_ONLY}},
    }
    print(f"fused-term parts {parts}", flush=True)
    ab.ab_time(shapes, impls, timed, pr)


def psc(parent: Path, runs: int) -> None:
    """`runs` venice-89 POWER_SCHUR_COMPLEMENT step-1 solves
    (step2_spread.step1_spread) with each of the two wrappers routed to
    the package's kernel or to the earlier one, all four combinations, and
    the solve in f64 through the plain versions once: per combination the
    runs past PSC_BAND, the power-term counts of trials 30-31 and the
    first trial's cost against f64's."""
    import chip_smoke as cs
    from collections import Counter
    from povar_tpu_torch import synthetic_bal_problem_fast
    from povar_tpu_torch.ops import pose_kernels as pk
    from povar_tpu_torch.options import SolverType
    from povar_tpu_torch.tools import pose2_ab as ab
    from povar_tpu_torch.tools.step2_spread import JAX_PSC_COST, step1_spread

    libs = ab.build_all(parent, "pose1.cu", OUT, {}, {},
                        ("povar_hpp_b", "povar_e0_term"), PARENT_SIG,
                        {"hpp_b": r"pose1_cu.*hpp_b_kernel"})
    problem = synthetic_bal_problem_fast(cs.N_CAMS, cs.N_LMS, cs.OBS_PER_LM,
                                         seed=0)
    solver = SolverType.POWER_SCHUR_COMPLEMENT
    first = step1_spread(problem, 1, solver, f64=True)[0]["costs"][1]
    own = {"hpp_b_structured": pk.hpp_b_structured,
           "e0_term_parts": pk.e0_term_parts}
    earlier = {"hpp_b_structured": _parent_hpp(libs["parent"]),
               "e0_term_parts": _parent_e0(libs["parent"])}
    for hpp_who in ("package", "parent"):
        for e0_who in ("package", "parent"):
            pick = {"hpp_b_structured": hpp_who, "e0_term_parts": e0_who}
            try:
                for name, who in pick.items():
                    setattr(pk, name, (own if who == "package"
                                       else earlier)[name])
                recs = step1_spread(problem, runs, solver)
            finally:
                for name, fn in own.items():
                    setattr(pk, name, fn)
            dev = sorted(r["costs"][1] / first - 1.0 for r in recs)
            print(f"psc hpp_b {hpp_who} e0_term {e0_who}: "
                  f"{sum(r['final'] > 1.001 * JAX_PSC_COST for r in recs)} "
                  f"of {runs} past the band, trials 30-31 "
                  f"{dict(Counter(tuple(r['terms'][29:31]) for r in recs))}, "
                  f"first trial against f64 {dev[0]:+.2e} .. {dev[-1]:+.2e} "
                  f"(median {dev[len(dev) // 2]:+.2e})", flush=True)


def rows(parent: Path) -> None:
    """hpp_b_structured on the venice-89 PSC solver's first-trial
    operands (the VarProj start, landmark damping at lambda 1e-4): per
    output row (144 of hpp, 12 of b) the error of the earlier kernel, the
    package's and the plain version in f32 against the plain version in
    f64, each row scaled by its largest |f64| entry, the worst rows by
    the package's error."""
    import chip_smoke as cs
    from povar_tpu_torch import (SolverOptions, Stage1Solver,
                                 synthetic_bal_problem_fast)
    from povar_tpu_torch.ops import pose_kernels as pk
    from povar_tpu_torch.ops import pose_ref as pr
    from povar_tpu_torch.options import SolverType
    from povar_tpu_torch.tools import pose2_ab as ab

    libs = ab.build_all(parent, "pose1.cu", OUT, {}, {},
                        ("povar_hpp_b", "povar_e0_term"), PARENT_SIG,
                        {"hpp_b": r"pose1_cu.*hpp_b_kernel"})
    problem = synthetic_bal_problem_fast(cs.N_CAMS, cs.N_LMS, cs.OBS_PER_LM,
                                         seed=0)
    opts = SolverOptions(solver_type_step_1=SolverType.POWER_SCHUR_COMPLEMENT)
    s = cs.stage_solver(Stage1Solver, problem, opts)
    c = torch.as_tensor(problem.cam_space, device="cuda")
    lin = s.linearize(c, s.lm_pack(s.initialize_varproj(c)))
    _inv, hib, jls, _lh = s._hll_pieces_s(lin, s._solve_scalar(1e-4))
    args = (s.obs.cam, lin.ct, lin.x, s._uv_s, lin.sw, lin.r_w, jls, hib,
            s.n_cams)
    exact = torch.cat(pr.hpp_b_structured(*(
        a.double() if torch.is_tensor(a) and a.is_floating_point() else a
        for a in args), alpha=s.alpha))
    scale = exact.abs().amax(dim=1).clamp_min(1e-300)
    errs = {}
    for who, fn in (("parent", _parent_hpp(libs["parent"])),
                    ("package", pk.hpp_b_structured),
                    ("plain", pr.hpp_b_structured)):
        got = torch.cat(fn(*args, alpha=s.alpha)).double()
        errs[who] = ((got - exact).abs().amax(dim=1) / scale,
                     (got - exact).sum(dim=1) / (scale * s.n_cams))
    order = torch.argsort(errs["package"][0], descending=True)
    for name, (worst, _bias) in errs.items():
        print(f"rows {name}: median row error {worst.median():.2e}, "
              f"largest {worst.max():.2e}", flush=True)
    for r in order[:12].tolist():
        what = f"hpp {r}" if r < 144 else f"b {r - 144}"
        print(f"rows {what}: " + ", ".join(
            f"{n} {e[0][r]:.2e} (mean signed {e[1][r]:+.1e})"
            for n, e in errs.items()), flush=True)


def bench() -> None:
    import chip_smoke as cs
    from povar_tpu_torch import SolverOptions, synthetic_bal_problem_fast

    problem = synthetic_bal_problem_fast(cs.N_CAMS, cs.N_LMS, cs.OBS_PER_LM,
                                         seed=0)
    opts = SolverOptions()
    cs.bench_step1(problem, opts, "step-1 defaults")
    cs.bench_step1(problem, opts, "step-1 spmd (1-device mesh)", mesh=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    k = sub.add_parser("kernels")
    k.add_argument("--parent", type=Path, required=True,
                   help="directory with the earlier pose1.cu and "
                   "pose_common.cuh")
    sub.add_parser("bench")
    sub.add_parser("rows").add_argument("--parent", type=Path,
                                        required=True)
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
        kernels(args.parent)
    elif args.mode == "psc":
        psc(args.parent, args.runs)
    elif args.mode == "rows":
        rows(args.parent)
    else:
        bench()
    return 0


if __name__ == "__main__":
    sys.exit(main())

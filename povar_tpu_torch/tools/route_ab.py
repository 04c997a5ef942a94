"""The camera-table kernels' routes against each other on one card.

    python -m povar_tpu_torch.tools.route_ab [--parent DIR] [--rounds 3]
        [--variants NAME ...] [--n N ...]

Most table kernels (e0_factor, e0_u_structured, apply_ldiff, poba_t3,
apply_ldiff_stored, pose_error, mat_dot2, ldiff2, e0_u in f32 and f64)
read their [12 or 24, N] camera tables in place at every N; the fused
terms (csrc/pose_common.cuh launch_tiles) stage theirs in shared memory
where it fits beside their accumulator, then read it in place beside one
shared accumulator while that fits (to N ~ 4,800), then add to global
memory; prepare2 (pose2.cu) reads its table in place and sums per camera
into per-warp private copies, else shared copies, else f64 global
atomics (sums_plan). This tool builds, one nvcc per source, all started
together, into build/route_ab/<variant>/:

  parent               DIR, an earlier commit's csrc/ whose entry points
                       take the package's arguments (55b8cee: every
                       table kernel staged its table in shared memory),
                       as it is
  no_intermediate      the package's csrc/ with the fused terms going
                       from their staged routes straight to the global
                       one (regex edits of a copy)
  prep2_shared         prepare2 on its shared copy where the package's
                       takes private ones
  prep2_global         prepare2 on f64 global atomics at every N

and times each kernel a variant changes against the package's, with
chip_smoke.py's loop timer (CUDA events around 50 back-to-back calls)
in turns (package, variant, variant, package; `--rounds` times), at the
shapes where the two differ: parent at venice-89 (N = 89, 557,056 slot
rows) and N = 1024; no_intermediate at N = 3000 and 4500; prepare2 and
its f64 instantiation (`prepare2_f64`, the operands in f64) at each side
of the private and shared routes' ceilings (PREP2_SHAPES) (all but
venice-89 synthetic_bal_problem_fast(N, 209,716, 5, locality=64): ~2^20
slot rows, chip_smoke.py's large_n (a) rows). Every variant's output is
held to the plain version with chip_smoke.py's tolerances. Prints one
line per kernel and shape (median us of each, variant / package) and a
JSON line at the end. `--variants` runs only the named variants
(`--parent` is needed for the parent one), `--n` only the named camera
counts of theirs. Unpack DIR before the call
(`git archive 55b8cee povar_tpu_torch | tar -x -C build/parent`; DIR =
build/parent/povar_tpu_torch/csrc). Run from the repository root; needs
a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

OUT = Path("build") / "route_ab"
# the package's csrc/ edited: (file, pattern, replacement), each pattern
# must match
VARIANTS = {
    "no_intermediate": [
        ("pose_common.cuh", r"  if \(base \+ acc <= room\)\n",
         "  if (false)\n"),
    ],
    "prep2_shared": [("pose2.cu", r"kPrep2Warps, kPrep2Warps,",
                      "kPrep2Warps, 33,")],
    "prep2_global": [("pose2.cu", r"kPrep2StaticSmem,(\s+)sizeof\(V\)\);",
                      "(size_t)1 << 40,\\1sizeof(V));")],
}
KERNELS = {
    "parent": ("e0_factor", "e0_u_structured", "apply_ldiff", "pose_error",
               "poba_t3", "apply_ldiff_stored", "mat_dot2", "ldiff2", "e0_u",
               "e0_u_f64"),
    "no_intermediate": ("e0_term_parts", "e0_term2_parts"),
    "prep2_shared": ("prepare2", "prepare2_f64"),
    "prep2_global": ("prepare2", "prepare2_f64"),
}
# prepare2's route ceilings (csrc/pose2.cu prepare2_launch, sums_plan):
# private copies to N = 453 in f32 (226 in f64), a shared one to 7,260
# (3,630); each variant timed on either side of them
PREP2_SHAPES = {"prep2_shared": (150, 226, 300, 453),
                "prep2_global": (1024, 2000, 3000, 3630, 4500, 5500, 6000,
                                 6500, 7000, 7200)}
SHAPES = {"parent": (89, 1024), "no_intermediate": (3000, 4500),
          **PREP2_SHAPES}
LMS = 209_716


def build_variants(parent, names) -> dict:
    """Each of the variants `names`' library (ops/_build.load; the
    parent's with the entry points it has), built in parallel."""
    from povar_tpu_torch.ops import _build

    procs, libs = [], {}
    trees = {"parent": (parent, [])} if "parent" in names else {}
    trees.update((n, (_build.CSRC, e)) for n, e in VARIANTS.items()
                 if n in names)
    for name, (tree, edits) in trees.items():
        src = OUT / name / "csrc"
        shutil.rmtree(OUT / name, ignore_errors=True)
        shutil.copytree(tree, src)
        for fname, pattern, repl in edits:
            f = src / fname
            text, n = re.subn(pattern, repl, f.read_text())
            if n == 0:
                raise RuntimeError(f"{name}: {pattern!r} matches nothing in "
                                   f"{fname}")
            f.write_text(text)
        objs = [OUT / name / f"{s.stem}.o" for s in sorted(src.glob("*.cu"))]
        for s, o in zip(sorted(src.glob("*.cu")), objs):
            procs.append((name, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o", str(o),
                 str(s)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        libs[name] = (OUT / name / _build.LIB_NAME, objs)
    for name, proc in procs:
        log = proc.communicate(timeout=900)[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    out = {}
    for name, (lib, objs) in libs.items():
        subprocess.run([_build._nvcc(), "-shared", "-o", str(lib),
                        *map(str, objs)], check=True, timeout=300)
        out[name] = _build.load(lib) if name != "parent" else _load_some(lib)
    return out


def _load_some(path: Path):
    """An earlier tree's library with the argument types of the entry
    points of ops/_build.SIGNATURES it has (55b8cee predates the f64
    instantiations of the structured kernels)."""
    import ctypes

    from povar_tpu_torch.ops import _build

    lib = ctypes.CDLL(str(path))
    for name, argtypes in _build.SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    lib.povar_error_string.argtypes = [ctypes.c_int]
    lib.povar_error_string.restype = ctypes.c_char_p
    return lib


@contextlib.contextmanager
def using(lib):
    """The kernel wrappers launch `lib`'s kernels while the block runs."""
    from povar_tpu_torch.ops import _build

    saved = _build.library
    _build.library = lambda: lib
    try:
        yield
    finally:
        _build.library = saved


def cases(n: int):
    """chip_smoke.py's cases (name, variant, call, inputs, specs,
    n_read[, library]) of the table kernels at N = n (venice-89 at
    n = 89): step 1's, step 2's on the homogenized VarProj start, and
    the camera-table kernels' in f32 and f64."""
    import chip_smoke as cs
    from povar_tpu_torch import (
        SolverOptions, Stage1Solver, Stage2Solver, create_homogeneous,
        synthetic_bal_problem_fast,
    )

    problem = (synthetic_bal_problem_fast(cs.N_CAMS, cs.N_LMS, cs.OBS_PER_LM,
                                          seed=0) if n == cs.N_CAMS else
               synthetic_bal_problem_fast(n, LMS, cs.OBS_PER_LM, seed=0,
                                          locality=64))
    opts = SolverOptions()
    args = (problem.obs_cam, problem.obs_lm, problem.obs_uv,
            problem.num_cameras, problem.num_landmarks)
    s1 = Stage1Solver(*args, opts, device="cuda")
    d = cs.kernel_inputs(s1, problem)
    out = cs.step1_cases(s1, d, opts.alpha)
    out += cs.large_cam_cases(d["cam"], n, d["mask"])

    s2 = Stage2Solver(*args, opts, device="cuda")
    c = torch.as_tensor(problem.cam_space, device="cuda")
    cams_h, lms_h = create_homogeneous(c, s1.initialize_varproj(c))
    lin = s2.linearize(cams_h, s2.lm_pack(lms_h))
    rng = np.random.default_rng(1)
    o = int(s2.obs.cam.shape[0])

    def f32(*shape):
        return torch.as_tensor(rng.standard_normal(shape),
                               dtype=torch.float32, device="cuda")

    zt, mat6, ilm4 = f32(12, n), f32(6, o), f32(4, o)
    cam, parts = s2.obs.cam, s2.e0_plan.parts
    obs = (cam, lin.x4, lin.mm, lin.sw)
    ct64, x4_64, uv64 = (t.double() for t in (lin.ct, lin.x4, s2._uv_s))
    out += [
        ("prepare2", None,
         lambda m: m.prepare2(cam, lin.ct, lin.x4, s2._uv_s, s2._mask1,
                              use_valid=s2.use_valid_only, robust=0,
                              huber=1.0), [], [cs.ELEM] * 5 + [cs.CAM], None),
        ("prepare2_f64", None,
         lambda m: m.prepare2(cam, ct64, x4_64, uv64, s2._mask1,
                              use_valid=s2.use_valid_only, robust=0,
                              huber=1.0), [], [cs.ELEM] * 5 + [cs.CAM], None),
        ("mat_dot2", None,
         lambda m: m.mat_dot2(*obs, mat6, None, zt, add_r=False), [],
         [cs.ELEM], None),
        ("ldiff2", None,
         lambda m: m.ldiff2(*obs, lin.r_w, lin.jls8, ilm4, zt), [],
         [cs.SUM], None),
        ("e0_term2_parts", None,
         lambda m: m.e0_term2_parts(*obs, mat6, zt, parts, n), [], [cs.CAM],
         None),
    ]
    return out, o


def module_of(name: str):
    """The wrapper module and plain-version module of kernel `name`."""
    from povar_tpu_torch.ops import cam_kernels, cam_ref, pose2_kernels
    from povar_tpu_torch.ops import pose2_ref, pose_kernels, pose_ref

    if name in ("e0_u", "e0_u_f64"):
        return cam_kernels, cam_ref
    if name in ("prepare2", "prepare2_f64", "mat_dot2", "ldiff2",
                "e0_term2_parts"):
        return pose2_kernels, pose2_ref
    return pose_kernels, pose_ref


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="an earlier commit's csrc/ (the module docstring; "
                    "needed for the parent variant)")
    ap.add_argument("--rounds", type=int, default=3,
                    help="turns of package, variant, variant, package")
    ap.add_argument("--variants", nargs="+", default=None,
                    choices=tuple(SHAPES),
                    help="run only these variants (default: all)")
    ap.add_argument("--n", nargs="+", type=int, default=None,
                    help="only these of the variants' camera counts")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("route_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from povar_tpu_torch.ops import _build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    names = tuple(SHAPES) if a.variants is None else tuple(a.variants)
    if "parent" in names and a.parent is None:
        ap.error("--parent DIR is needed for the parent variant")
    package = _build.library()
    libs = build_variants(a.parent, names)
    rows = []
    for variant, shapes in SHAPES.items():
        if a.variants is not None and variant not in a.variants:
            continue
        for n in shapes:
            if a.n is not None and n not in a.n:
                continue
            all_cases, o = cases(n)
            print(f"== {variant} at N = {n}: O = {o} slot rows", flush=True)
            for name, label, run, _inputs, specs, *_rest in all_cases:
                if label is not None or name not in KERNELS[variant]:
                    continue
                kern, plain = module_of(name)
                want = run(plain)
                with using(libs[variant]):
                    cs.compare(f"{name} ({variant}, N = {n})", run(kern),
                               want, specs)
                times = {"package": [], variant: []}
                for _ in range(a.rounds):
                    for side in ("package", variant, variant, "package"):
                        with using(package if side == "package"
                                   else libs[variant]):
                            times[side].append(
                                cs.loop_ms(lambda: run(kern)) * 1e3)
                pkg = statistics.median(times["package"])
                var = statistics.median(times[variant])
                print(f"{name:<20} N = {n:<5} package {pkg:9.2f} us  "
                      f"{variant} {var:9.2f} us  ratio {var / pkg:.3f}  "
                      f"(package {min(times['package']):.2f}-"
                      f"{max(times['package']):.2f}, {variant} "
                      f"{min(times[variant]):.2f}-{max(times[variant]):.2f})",
                      flush=True)
                rows.append(dict(kernel=name, variant=variant, n_cams=n,
                                 slot_rows=o, package_us=pkg,
                                 variant_us=var, ratio=var / pkg,
                                 package_all=times["package"],
                                 variant_all=times[variant]))
            del all_cases
            torch.cuda.empty_cache()
    print(json.dumps(dict(route_ab=rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

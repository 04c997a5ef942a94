"""The camera-table kernels' routes against each other on one card.

    python -m povar_tpu_torch.tools.route_ab --parent DIR [--rounds 3]

Most table kernels (e0_factor, e0_u_structured, apply_ldiff, poba_t3,
apply_ldiff_stored, pose_error, mat_dot2, ldiff2, e0_u in f32 and f64)
read their [12 or 24, N] camera tables in place at every N; the fused
terms (csrc/pose_common.cuh launch_tiles) and prepare2 (pose2.cu) stage
theirs in shared memory where it fits beside their accumulator, then
read it in place beside one shared accumulator while that fits (to
N ~ 4,800), then add to global memory. This tool builds, one nvcc per
source, all started together, into build/route_ab/<variant>/:

  parent           DIR, an earlier commit's csrc/ whose entry points take
                   the package's arguments (55b8cee: every table kernel
                   staged its table in shared memory), as it is
  no_intermediate  the package's csrc/ with the fused terms going from
                   their staged routes straight to the global one, and
                   prepare2 from its staged route straight to global
                   atomics (regex edits of a copy)

and times each kernel a variant changes against the package's, with
chip_smoke.py's loop timer (CUDA events around 50 back-to-back calls)
in turns (package, variant, variant, package; `--rounds` times), at the
shapes where the two differ: parent at venice-89 (N = 89, 557,056 slot
rows) and N = 1024; no_intermediate at N = 3000 and 4500 (both
synthetic_bal_problem_fast(N, 209,716, 5, locality=64): ~2^20 slot
rows, chip_smoke.py's large_n (a) rows). Every variant's output is held
to the plain version with chip_smoke.py's tolerances. Prints one line
per kernel and shape (median us of each, variant / package) and a JSON
line at the end. Unpack DIR before the call (`git archive 55b8cee
povar_tpu_torch | tar -x -C build/parent`; DIR =
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
        ("pose2.cu", r": table <= room   \? prepare2_kernel<false, true>",
         ": false ? prepare2_kernel<false, true>"),
        ("pose2.cu", r": table <= room   \? table", ": false ? table"),
    ],
}
KERNELS = {
    "parent": ("e0_factor", "e0_u_structured", "apply_ldiff", "pose_error",
               "poba_t3", "apply_ldiff_stored", "mat_dot2", "ldiff2", "e0_u",
               "e0_u_f64"),
    "no_intermediate": ("e0_term_parts", "e0_term2_parts", "prepare2"),
}
SHAPES = {"parent": (89, 1024), "no_intermediate": (3000, 4500)}
LMS = 209_716


def build_variants(parent: Path) -> dict:
    """Each variant's library (ops/_build.load), built in parallel."""
    from povar_tpu_torch.ops import _build

    procs, libs = [], {}
    trees = {"parent": (parent, [])}
    trees.update((n, (_build.CSRC, e)) for n, e in VARIANTS.items())
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
        out[name] = _build.load(lib)
    return out


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
    out += [
        ("prepare2", None,
         lambda m: m.prepare2(cam, lin.ct, lin.x4, s2._uv_s, s2._mask1,
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
    if name in ("prepare2", "mat_dot2", "ldiff2", "e0_term2_parts"):
        return pose2_kernels, pose2_ref
    return pose_kernels, pose_ref


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="an earlier commit's csrc/ (the module docstring)")
    ap.add_argument("--rounds", type=int, default=3,
                    help="turns of package, variant, variant, package")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("route_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from povar_tpu_torch.ops import _build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    package = _build.library()
    libs = build_variants(a.parent)
    rows = []
    for variant, shapes in SHAPES.items():
        for n in shapes:
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

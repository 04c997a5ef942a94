"""Build and load the package's CUDA kernels (csrc/*.cu).

`nvcc` compiles each csrc/*.cu (pose1.cu, pose2.cu, cam.cu, spmd.cu,
lm.cu)
into an object file, one compiler per source, all started together, and
links them into one shared library with a plain C interface for Hopper
(sm_90a), which `ctypes` loads: no PyTorch headers are compiled, so a
cold build takes seconds. The library
lands in build/povar_tpu_torch/<key>/ beside the package directory,
where <key> hashes the sources and the compiler flags: editing a kernel
rebuilds it, an unchanged tree reuses the last build. Importing this
module builds nothing; the first call to `library()` does.

There is no fallback: a missing `nvcc` or a failed compile raises with
the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "povar_tpu_torch"
LIB_NAME = "libpovar_pose.so"
# no FMA contraction: every product and sum is rounded on its own, as
# the kernels' plain PyTorch versions round them
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
_U64 = ctypes.c_ulonglong

# argument types of every exported entry point (csrc/pose1.cu, pose2.cu,
# cam.cu, spmd.cu, lm.cu)
SIGNATURES = {
    "povar_prepare": [_P] * 11 + [_I, _I, _F, _F, _F, _I, _F, _F, _I, _P],
    "povar_e0_factor": [_P] * 7 + [_I, _I, _F, _P],
    "povar_hpp_b": [_P] * 12 + [_I, _I, _F, _F, _F, _P],
    "povar_e0_u": [_P] * 5 + [_I, _I, _P],
    "povar_e0_scatter": [_P] * 6 + [_I, _I, _P],
    "povar_apply_ldiff": [_P] * 10 + [_I, _I, _F, _F, _P],
    "povar_poba_t3": [_P] * 9 + [_I, _I, _F, _F, _P],
    "povar_apply_ldiff_stored": [_P] * 10 + [_I, _I, _F, _F, _P],
    "povar_cam_gather": [_P] * 3 + [_I] * 4 + [_P],
    "povar_cam_scatter_add": [_P] * 4 + [_I] * 3 + [_P],
    "povar_cam_e0_u": [_P] * 4 + [_I] * 4 + [_P],
    "povar_cam_e0_scatter": [_P] * 5 + [_I] * 4 + [_P],
    "povar_cam_hpp_b": [_P] * 6 + [_I] * 4 + [_P],
    "povar_cam_gather_f64": [_P] * 3 + [_I] * 4 + [_P],
    "povar_cam_scatter_add_f64": [_P] * 4 + [_I] * 3 + [_P],
    "povar_cam_e0_u_f64": [_P] * 4 + [_I] * 4 + [_P],
    "povar_cam_e0_scatter_f64": [_P] * 5 + [_I] * 4 + [_P],
    "povar_cam_hpp_b_f64": [_P] * 6 + [_I] * 4 + [_P],
    "povar_pose_error": [_P] * 6 + [_I, _I, _I, _D, _D, _I, _D, _P],
    "povar_e0_term": [_P] * 6 + [_I] * 5 + [_P],
    "povar_schur_diag": [_P] * 6 + [_I, _I, _P],
    "povar_e0_term2": [_P] * 8 + [_I] * 5 + [_P],
    "povar_schur_diag2": [_P] * 8 + [_I, _I, _P],
    "povar_prepare2": [_P] * 12 + [_I, _I, _I, _I, _F, _F, _P],
    "povar_hppb2": [_P] * 10 + [_I, _I, _P],
    "povar_mat_dot2": [_P] * 8 + [_I, _I, _I, _P],
    "povar_scatter2": [_P] * 8 + [_I, _I, _P],
    "povar_ldiff2": [_P] * 9 + [_I, _I, _P],
    "povar_pose_error2": [_P] * 10 + [_I, _I, _I, _I, _D, _P],
    "povar_spmd_part_sums": [_P] * 3 + [_I] * 5 + [_P],
    "povar_spmd_expand_rows": [_P] * 3 + [_I] * 5 + [_P],
    "povar_spmd_reduce_reexpand": [_P] * 3 + [_I] * 5 + [_P],
    # the f64 instantiations of the structured and slot kernels
    "povar_prepare_f64": [_P] * 11 + [_I, _I, _D, _D, _D, _I, _D, _D, _I, _P],
    "povar_e0_factor_f64": [_P] * 7 + [_I, _I, _D, _P],
    "povar_hpp_b_f64": [_P] * 12 + [_I, _I, _D, _D, _D, _P],
    "povar_e0_u_f64": [_P] * 5 + [_I, _I, _P],
    "povar_e0_scatter_f64": [_P] * 6 + [_I, _I, _P],
    "povar_apply_ldiff_f64": [_P] * 10 + [_I, _I, _D, _D, _P],
    "povar_poba_t3_f64": [_P] * 9 + [_I, _I, _D, _D, _P],
    "povar_apply_ldiff_stored_f64": [_P] * 10 + [_I, _I, _D, _D, _P],
    "povar_schur_diag_f64": [_P] * 6 + [_I, _I, _P],
    "povar_prepare2_f64": [_P] * 12 + [_I, _I, _I, _I, _D, _D, _P],
    "povar_hppb2_f64": [_P] * 10 + [_I, _I, _P],
    "povar_mat_dot2_f64": [_P] * 8 + [_I, _I, _I, _P],
    "povar_scatter2_f64": [_P] * 8 + [_I, _I, _P],
    "povar_ldiff2_f64": [_P] * 9 + [_I, _I, _P],
    "povar_schur_diag2_f64": [_P] * 8 + [_I, _I, _P],
    "povar_spmd_part_sums_f64": [_P] * 3 + [_I] * 5 + [_P],
    "povar_spmd_expand_rows_f64": [_P] * 3 + [_I] * 5 + [_P],
    "povar_spmd_reduce_reexpand_f64": [_P] * 3 + [_I] * 5 + [_P],
    "povar_lm_step": [_P] * 4 + [_D] * 6 + [_I] * 3 + [_U64, _I, _P],
    "povar_lm_condition": [_P, _U64, _I, _P, _I, _P],
    # the graph plumbing of lm.cu (no kernel of their own)
    "povar_graph_begin": [_P, _P],
    "povar_graph_end": [_P],
    "povar_cond_begin": [_P, _P, _I, _P, _P, _P],
    "povar_cond_end": [_P, _P, _P],
    "povar_capture_abort": [_P],
    "povar_graph_instantiate": [_P, _P],
    "povar_graph_launch": [_P, _P],
    "povar_graph_nodes": [_P, _P],
    "povar_graph_free": [_P, _P],
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (neither on PATH nor in $CUDA_HOME/bin): the "
            "CUDA kernels of povar_tpu_torch cannot be built"
        )
    return path


def sources():
    return sorted(CSRC.glob("*.cu"))


def source_key() -> str:
    """Hash of every kernel source and header plus the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless this exact source tree was built
    before; returns the library path. The compiler's output (including
    `-Xptxas -v`'s registers and spills per kernel) is kept in
    build.log beside the library."""
    out_dir = BUILD_ROOT / source_key()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [out_dir / f".{src.stem}.{tag}.o" for src in sources()]
    steps = [
        [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        for src, obj in zip(sources(), objs)
    ]
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for cmd in steps
    ]
    logs = [proc.communicate(timeout=900)[0] for proc in procs]
    failed = [
        (cmd, log) for cmd, log, proc in zip(steps, logs, procs)
        if proc.returncode != 0
    ]
    tmp = out_dir / f".{LIB_NAME}.{tag}"
    if not failed:
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True,
                              timeout=300)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append((link, logs[-1]))
    (out_dir / "build.log").write_text("".join(logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        cmd, log = failed[0]
        raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half
    return lib


def build_log() -> str:
    """The compiler output of the current build ('' before one)."""
    log = BUILD_ROOT / source_key() / "build.log"
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    return load(build())


def load(path: Path) -> ctypes.CDLL:
    """The kernel library at `path` (this tree's, or a build of an
    edited copy of csrc/) with every entry point's argument types."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.povar_error_string.argtypes = [ctypes.c_int]
    lib.povar_error_string.restype = ctypes.c_char_p
    return lib

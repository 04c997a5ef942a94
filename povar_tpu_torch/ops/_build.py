"""Build and load the package's CUDA kernels (csrc/*.cu).

`nvcc` compiles every csrc/*.cu into one shared library with a plain C
interface for Hopper (sm_90a), which `ctypes` loads: no PyTorch headers
are compiled, so a cold build takes seconds. The library lands in
build/povar_tpu_torch/<key>/ beside the package directory, where <key>
hashes the sources and the compiler flags: editing a kernel rebuilds it,
an unchanged tree reuses the last build. Importing this module builds
nothing; the first call to `library()` does.

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
LIB_NAME = "libpovar_pose1.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double

# argument types of every exported entry point (csrc/pose1.cu)
SIGNATURES = {
    "povar_prepare": [_P] * 10 + [_I, _I, _F, _F, _F, _I, _F, _F, _P],
    "povar_e0_factor": [_P] * 7 + [_I, _I, _F, _P],
    "povar_hpp_b": [_P] * 10 + [_I, _I, _F, _F, _F, _P],
    "povar_e0_u": [_P] * 5 + [_I, _I, _P],
    "povar_e0_scatter": [_P] * 5 + [_I, _I, _P],
    "povar_apply_ldiff": [_P] * 10 + [_I, _I, _F, _F, _P],
    "povar_pose_error": [_P] * 6 + [_I, _I, _I, _D, _D, _I, _D, _P],
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
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    (out_dir / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half
    return lib


def build_log() -> str:
    """The compiler output of the current build ('' before one)."""
    log = BUILD_ROOT / source_key() / "build.log"
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.povar_error_string.argtypes = [ctypes.c_int]
    lib.povar_error_string.restype = ctypes.c_char_p
    return lib

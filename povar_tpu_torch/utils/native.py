"""The native BAL tokenizer (csrc/bal_io.cpp) through ctypes.

The counterpart of povar_tpu/utils/native.py. The reference's data layer
is C++ (fscanf loops over millions of tokens, bal/bal_problem.cpp:
182-471); for BAL text of final-13682's size the numpy tokenizer builds
a Python object per token, so BAL files are parsed natively. The
library is built at first use with the host's C++ compiler into
build/povar_tpu_torch/bal_io/<key>/, where <key> hashes the source and
the flags (as ops/_build.py keys the kernels): an edited source
rebuilds, an unchanged one reuses the last build. Importing this module
builds nothing.

There is no fallback: a missing compiler, a failed compile or a failed
parse raises, with the compiler's output where there is one. The numpy
tokenizer (problem/bal_io.py `numpy_tokens`) stays as the plain version
the native one is held to.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from povar_tpu_torch.ops._build import BUILD_ROOT, CSRC

SOURCE = CSRC / "bal_io.cpp"
LIB_NAME = "libpovar_io.so"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")


def _cxx() -> str:
    """The host's C++ compiler: $CXX, else c++ or g++ on PATH."""
    for name in (os.environ.get("CXX"), "c++", "g++"):
        path = shutil.which(name) if name else None
        if path:
            return path
    raise RuntimeError(
        "no C++ compiler ($CXX, c++ or g++): the BAL tokenizer of "
        "povar_tpu_torch (csrc/bal_io.cpp) cannot be built")


def source_key() -> str:
    """Hash of the tokenizer's source and the compiler flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the tokenizer unless this exact source was built before;
    returns the library path. The compiler's output is kept in build.log
    beside the library."""
    out_dir = BUILD_ROOT / "bal_io" / source_key()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    log = proc.stdout + proc.stderr
    (out_dir / "build.log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"the BAL tokenizer's build failed:\n"
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded tokenizer (built on first use)."""
    lib = ctypes.CDLL(str(build()))
    lib.povar_count_tokens.restype = ctypes.c_longlong
    lib.povar_count_tokens.argtypes = [ctypes.c_char_p]
    lib.povar_parse_tokens.restype = ctypes.c_longlong
    lib.povar_parse_tokens.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_longlong,
    ]
    return lib


def parse_tokens(path: str) -> np.ndarray:
    """All whitespace-separated numeric tokens of a file, as f64, parsed
    natively (`strtod`, correctly rounded, as Python's float())."""
    lib = library()
    n = lib.povar_count_tokens(os.fsencode(path))
    if n < 0:
        raise IOError(f"native tokenizer failed to open {path}")
    out = np.empty(n, dtype=np.float64)
    got = lib.povar_parse_tokens(
        os.fsencode(path),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n,
    )
    if got != n:
        raise IOError(f"native tokenizer parsed {got} of {n} tokens in {path}")
    return out

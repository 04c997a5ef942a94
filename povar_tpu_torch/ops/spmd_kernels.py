"""Wrappers of the SPMD window layout's slot reduce/expand kernels.

The counterparts of povar_tpu/ops/pallas_spmd.py: `class_part_sums`,
`class_expand_rows` and `class_reduce_reexpand`, with the JAX names.
Where the Pallas kernels take one class of a device layout per call (and
return one array per part), these take the whole layout and write
straight into the concatenated output, one launch per call: the lanes
[K, o_dev] and slot rows [K, n_rows_dev] of ops/spmd_ref.py's docstring,
with K the flattened leading dimensions (parallel/spmd.py flattens).

As in ops/pose_kernels.py, each wrapper calls the plain PyTorch version
(ops/spmd_ref.py) when its tensor lies on the CPU, and only then;
otherwise it checks device, dtype, shape and contiguity, allocates the
output, launches the hand-written CUDA kernel (csrc/spmd.cu) on the
current stream, raises if the launch returned a CUDA error, and adds one
to its launch counter (`LAUNCHES`, read with the others by
ops/launches.py). Each kernel has an f32 and an f64 instantiation
(csrc/spmd.cu): the operand's dtype picks it, the output takes it, and
an f64 launch counts under the kernel's name with `_f64` appended
(F64_KERNELS). The f64 ones serve the mesh's pure f64, where the JAX
package's slot sums fall back per class to XLA in f64
(povar_tpu/ops/pallas_spmd.py:48-60); in mixed precision the f64 state
still reaches the f32 expansion as its hi and lo halves
(parallel/spmd.spmd_expand_rows). Another dtype or a non-contiguous CUDA
operand raises. There is no fallback from the card to the plain
version.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from povar_tpu_torch.ops import _build, spmd_ref
from povar_tpu_torch.ops.pose_kernels import _launch, _on_cpu, _ptr, _stream

KERNELS = ("class_part_sums", "class_expand_rows", "class_reduce_reexpand")

# the launch counters of the f64 instantiations
F64_KERNELS = tuple(f"{name}_f64" for name in KERNELS)

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS + F64_KERNELS}

# int32 fields of one entry of the kernels' layout table
TABLE_FIELDS = ("lane0", "stride", "cap", "w", "n", "row0", "work0")
# entries a launch stages in shared memory (csrc/spmd.cu kMaxEntries)
MAX_ENTRIES = 256


@functools.lru_cache(maxsize=64)
def layout_table(layout, tails: bool, device) -> Tuple[torch.Tensor, int, int]:
    """The kernels' int32 layout table on `device`, made once per layout
    (one host-to-device copy per solver): one entry per (class, part)
    (lane0 = the part's first lane in window 0, stride = win_lanes, cap,
    w, n = n_windows, row0 = its first slot row, work0 = the work items
    before it), and with `tails` one entry with w = 0 per class whose
    windows have tail lanes (cap = their count), which the expanding
    kernels zero. A work item is one (window, row) of an entry. Returns
    (table [n_entries * 7], n_entries, total work items)."""
    rows, work, lofs, rofs = [], 0, 0, 0
    for cl in layout:
        p = 0
        for cap, w in cl.parts:
            rows += [lofs + p, cl.win_lanes, cap, w, cl.n_windows, rofs, work]
            work += cl.n_windows * cap
            rofs += cl.n_windows * cap
            p += cap * w
        tail = cl.win_lanes - p
        if tails and tail:
            rows += [lofs + p, cl.win_lanes, tail, 0, cl.n_windows, -1, work]
            work += cl.n_windows * tail
        lofs += cl.n_windows * cl.win_lanes
    n_entries = len(rows) // len(TABLE_FIELDS)
    if work >= 2**31 or n_entries > MAX_ENTRIES:
        raise ValueError(f"layout of {work} work items in {n_entries} "
                         f"entries (the kernels take < 2^31 and "
                         f"<= {MAX_ENTRIES})")
    table = torch.tensor(rows, dtype=torch.int32, device=device)
    return table, n_entries, work


def _check(name: str, t: torch.Tensor, cols: int) -> None:
    """Shape of a [K, cols] operand, on both routes."""
    if t.dim() != 2 or t.shape[1] != cols or t.shape[0] < 1:
        raise ValueError(f"{name}: expected shape [K, {cols}], got "
                         f"{tuple(t.shape)}")


def _cuda_check(name: str, t: torch.Tensor) -> None:
    if t.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: expected torch.float32 or torch.float64, "
                        f"got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _run(name: str, symbol: str, src: torch.Tensor, layout, out_cols: int,
         tails: bool) -> torch.Tensor:
    """Launch one of the three kernels (C symbol povar_<symbol>, or its
    `_f64` instantiation for an f64 src) over the whole layout: src
    [K, .] -> a new [K, out_cols] tensor of src's dtype."""
    _cuda_check(name, src)
    suffix = "_f64" if src.dtype == torch.float64 else ""
    fn = getattr(_build.library(), f"povar_{symbol}{suffix}")
    k = src.shape[0]
    table, n_entries, work = layout_table(tuple(layout), tails, src.device)
    out = torch.empty((k, out_cols), dtype=src.dtype, device=src.device)
    _launch(name + suffix, fn, _ptr(src), _ptr(out), _ptr(table), n_entries,
            work, k, src.shape[1], out_cols, _stream(src), counts=LAUNCHES)
    return out


def class_part_sums(x: torch.Tensor, layout) -> torch.Tensor:
    """x [K, o_dev] f32 or f64 -> per-slot-row sums [K, n_rows_dev]
    (P1)."""
    o_dev, n_rows = spmd_ref.layout_sizes(layout)
    _check("x", x, o_dev)
    if _on_cpu(x):
        return spmd_ref.class_part_sums(x, layout)
    return _run("class_part_sums", "spmd_part_sums", x, layout, n_rows,
                tails=False)


def class_expand_rows(rows: torch.Tensor, layout) -> torch.Tensor:
    """rows [K, n_rows_dev] f32 or f64 -> lanes [K, o_dev], tail lanes
    zero (P2)."""
    o_dev, n_rows = spmd_ref.layout_sizes(layout)
    _check("rows", rows, n_rows)
    if _on_cpu(rows):
        return spmd_ref.class_expand_rows(rows, layout)
    return _run("class_expand_rows", "spmd_expand_rows", rows, layout, o_dev,
                tails=True)


def class_reduce_reexpand(x: torch.Tensor, layout) -> torch.Tensor:
    """x [K, o_dev] f32 or f64 -> [K, o_dev], each slot-row group
    replaced by its sum, tail lanes zero (P3)."""
    o_dev, _n_rows = spmd_ref.layout_sizes(layout)
    _check("x", x, o_dev)
    if _on_cpu(x):
        return spmd_ref.class_reduce_reexpand(x, layout)
    return _run("class_reduce_reexpand", "spmd_reduce_reexpand", x, layout,
                o_dev, tails=True)

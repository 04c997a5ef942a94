"""Plain PyTorch versions of the SPMD window layout's slot reduce/expand
kernels (csrc/spmd.cu): the counterparts of `class_part_sums`,
`class_expand_rows` and `class_reduce_reexpand` in
povar_tpu/ops/pallas_spmd.py, each over a whole device layout at once
(every class and part) where the Pallas kernels take one class.

A layout is a tuple of classes (parallel/spmd.ClassLayout: n_windows,
parts = ((cap, w), ...), win_lanes). Class c owns lanes [lofs_c,
lofs_c + n_windows * win_lanes) of the device's lane array; part i of a
window is the slab of cap * w lanes at offset p_i inside it, slot
element s of row r at lane p_i + s * cap + r; the lanes after the last
part are the window's tail. Slot rows are numbered class, then part,
then window, then row in the part:

  class_part_sums        rows[k, row(c,i,n,r)] = sum_s x[k, lane(c,i,n,s,r)]
  class_expand_rows      lanes[k, lane(c,i,n,s,r)] = rows[k, row(c,i,n,r)],
                         tail lanes 0
  class_reduce_reexpand  class_expand_rows(class_part_sums(x))

The sums add s = 0 .. w-1 from left to right, as the Pallas kernels
do, so they are bit-equal to them in interpret mode (and to the CUDA
kernels, which add in the same order). ops/spmd_kernels.py calls these
for tensors on the CPU (the tests) and chip_smoke.py holds each CUDA
kernel against them on the card.
"""

from __future__ import annotations

import torch


def layout_sizes(layout):
    """(o_dev, n_rows_dev): the lanes and slot rows of a device layout."""
    o_dev = sum(cl.n_windows * cl.win_lanes for cl in layout)
    n_rows = sum(cl.n_windows * cap for cl in layout for cap, _w in cl.parts)
    return o_dev, n_rows


def class_part_sums(x: torch.Tensor, layout) -> torch.Tensor:
    """x [K, o_dev] -> per-slot-row sums [K, n_rows_dev]."""
    k = x.shape[0]
    outs, lofs = [], 0
    for cl in layout:
        n, lanes = cl.n_windows, cl.win_lanes
        blk = x[:, lofs : lofs + n * lanes].reshape(k, n, lanes)
        p = 0
        for cap, w in cl.parts:
            seg = blk[:, :, p : p + cap * w].reshape(k, n, w, cap)
            acc = seg[:, :, 0]
            for s in range(1, w):
                acc = acc + seg[:, :, s]
            outs.append(acc.reshape(k, n * cap))
            p += cap * w
        lofs += n * lanes
    return torch.cat(outs, dim=-1)


def class_expand_rows(rows: torch.Tensor, layout) -> torch.Tensor:
    """Per-slot-row values [K, n_rows_dev] -> lanes [K, o_dev], each
    part's row broadcast over its w slot elements, tail lanes zero."""
    k = rows.shape[0]
    o_dev, _n_rows = layout_sizes(layout)
    out = torch.zeros((k, o_dev), dtype=rows.dtype, device=rows.device)
    lofs = rofs = 0
    for cl in layout:
        n, lanes = cl.n_windows, cl.win_lanes
        blk = out[:, lofs : lofs + n * lanes].view(k, n, lanes)
        p = 0
        for cap, w in cl.parts:
            seg = rows[:, rofs : rofs + n * cap].reshape(k, n, 1, cap)
            blk[:, :, p : p + cap * w] = seg.expand(k, n, w, cap).reshape(
                k, n, w * cap)
            p += cap * w
            rofs += n * cap
        lofs += n * lanes
    return out


def class_reduce_reexpand(x: torch.Tensor, layout) -> torch.Tensor:
    """x [K, o_dev] -> [K, o_dev]: each slot-row group of lanes replaced
    by its sum, tail lanes zero."""
    return class_expand_rows(class_part_sums(x, layout), layout)

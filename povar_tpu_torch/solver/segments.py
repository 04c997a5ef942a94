"""Segment reductions over the observation axis.

Two halves, as in povar_tpu/solver/segments.py:

- numpy planners, run once at solver construction: `build_slot_plan`
  (the landmark slot layout every per-landmark reduction uses) and
  `_build_padded_reduce` (a bucketed gather/reduce plan for an arbitrary
  segmentation);
- torch reductions over the planned layouts: `slot_part_sums`,
  `slot_segment_sum`, `slot_row_expand`, `slot_expand` and
  `padded_segment_sum`.

The slot layout reorders the observation axis so that each bucket of
landmarks with equal (padded) observation count w occupies a
contiguous block ordered SLOT-ELEMENT-MAJOR: lane index = k * G + g for
slot element k of landmark g. A per-landmark segment sum is then a sum
of w contiguous [.., G] slices and the inverse expansion a broadcast,
with no index gathers. Rare large landmarks (count > SLOT_EXACT_MAX)
are padded up to powers of two with zero-weight slots. The camera
windows of the JAX package (its large-N TPU layout) are not part of
this package: a GPU kernel gathers a camera row by index at any N.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class PaddedReduce(NamedTuple):
    """Static gather/reduce plan for one segmentation of the obs axis.

    idx[b]:  [G_b, L_b] int64 — observation positions of each segment in
             bucket b, padded with arbitrary valid positions
    mask[b]: [G_b, L_b] bool — True for real entries
    inv_order: [S] int64 — maps canonical segment id -> position in the
             bucket-concatenated output
    """

    idx: Tuple[torch.Tensor, ...]
    mask: Tuple[torch.Tensor, ...]
    inv_order: torch.Tensor


def _build_padded_reduce(
    seg_ids: np.ndarray, num_segments: int, device="cpu"
) -> PaddedReduce:
    """Group observation positions by segment id into power-of-two
    padded buckets."""
    order = np.argsort(seg_ids, kind="stable")
    sorted_ids = seg_ids[order]
    starts = np.searchsorted(sorted_ids, np.arange(num_segments), "left")
    ends = np.searchsorted(sorted_ids, np.arange(num_segments), "right")
    counts = ends - starts

    # bucket index = ceil(log2(max(count,1)))
    buckets = np.zeros(num_segments, dtype=np.int64)
    nonzero = counts > 0
    buckets[nonzero] = np.ceil(
        np.log2(np.maximum(counts[nonzero], 1))
    ).astype(np.int64)

    idx_list = []
    mask_list = []
    seg_order = []
    for b in sorted(set(buckets.tolist())):
        length = 1 << b
        segs = np.nonzero(buckets == b)[0]
        g = len(segs)
        idx = np.zeros((g, length), dtype=np.int64)
        mask = np.zeros((g, length), dtype=bool)
        for row, s in enumerate(segs):
            c = counts[s]
            idx[row, :c] = order[starts[s] : ends[s]]
            mask[row, :c] = True
        idx_list.append(torch.as_tensor(idx, device=device))
        mask_list.append(torch.as_tensor(mask, device=device))
        seg_order.extend(segs.tolist())

    inv_order = np.empty(num_segments, dtype=np.int64)
    inv_order[np.asarray(seg_order, dtype=np.int64)] = np.arange(
        num_segments, dtype=np.int64
    )
    return PaddedReduce(
        idx=tuple(idx_list),
        mask=tuple(mask_list),
        inv_order=torch.as_tensor(inv_order, device=device),
    )


def padded_segment_sum(x: torch.Tensor, red: PaddedReduce) -> torch.Tensor:
    """Sum x [..., O] per segment -> [..., S]."""
    parts = []
    for idx_b, mask_b in zip(red.idx, red.mask):
        g = x.index_select(-1, idx_b.reshape(-1))
        g = g.reshape(x.shape[:-1] + idx_b.shape)
        g = torch.where(mask_b, g, torch.zeros((), dtype=x.dtype, device=x.device))
        parts.append(g.sum(dim=-1))
    out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
    return out.index_select(-1, red.inv_order)


SLOT_EXACT_MAX = 64


def build_slot_plan(obs_lm: np.ndarray, num_landmarks: int, pad_to: int = 1):
    """Returns (perm, pad_weight, shapes, lm_order, inv_pos):
    perm [O_pad] original-obs position per slot (pads repeat a position),
    pad_weight [O_pad] 0/1, shapes = tuple of (num_landmarks_in_bucket,
    slot_width), lm_order [M (+1)] canonical lm id per slot-row,
    inv_pos [M] position of canonical lm id in lm_order.

    pad_to > 1 appends a zero-weight tail block so the total padded
    length is a multiple. The tail forms an extra fake slot row whose
    sum is dropped by inv_pos and whose expansion broadcasts landmark 0
    (masked everywhere by the zero weight)."""
    obs_lm = np.asarray(obs_lm)
    order = np.argsort(obs_lm, kind="stable")
    sorted_ids = obs_lm[order]
    starts = np.searchsorted(sorted_ids, np.arange(num_landmarks), "left")
    ends = np.searchsorted(sorted_ids, np.arange(num_landmarks), "right")
    counts = ends - starts

    def width(c):
        if c <= SLOT_EXACT_MAX:
            return int(c) if c > 0 else 1
        return 1 << int(np.ceil(np.log2(c)))

    widths = np.array([width(c) for c in counts], dtype=np.int64)
    perm_parts = []
    weight_parts = []
    shapes = []
    lm_order_parts = []
    for w in np.unique(widths):
        lms = np.nonzero(widths == w)[0]
        g = len(lms)
        blk_idx = np.zeros((g, w), dtype=np.int64)
        blk_w = np.zeros((g, w), dtype=np.float64)
        for row, m in enumerate(lms):
            c = counts[m]
            pos = order[starts[m] : ends[m]]
            blk_idx[row, :c] = pos
            blk_idx[row, c:] = pos[0] if c > 0 else 0
            blk_w[row, :c] = 1.0
        # slot-element-major: lane = k * G + g (see module comment)
        perm_parts.append(blk_idx.T.reshape(-1))
        weight_parts.append(blk_w.T.reshape(-1))
        shapes.append((g, int(w)))
        lm_order_parts.append(lms)
    perm = np.concatenate(perm_parts)
    pad_weight = np.concatenate(weight_parts)
    lm_order = np.concatenate(lm_order_parts).astype(np.int32)
    inv_pos = np.empty(num_landmarks, dtype=np.int32)
    inv_pos[lm_order] = np.arange(num_landmarks, dtype=np.int32)
    if pad_to > 1 and len(perm) % pad_to:
        tail = pad_to - len(perm) % pad_to
        perm = np.concatenate([perm, np.zeros(tail, perm.dtype)])
        pad_weight = np.concatenate([pad_weight, np.zeros(tail)])
        shapes.append((1, int(tail)))
        lm_order = np.concatenate([lm_order, np.zeros(1, np.int32)])
    return perm, pad_weight, tuple(shapes), lm_order, inv_pos


def slot_part_sums(x: torch.Tensor, shapes) -> torch.Tensor:
    """Per-slot-row sums for slot-ordered x [..., O_pad] ->
    [..., n_slot_rows]."""
    parts = []
    ofs = 0
    for g, w in shapes:
        blk = x[..., ofs : ofs + g * w]
        parts.append(blk.reshape(x.shape[:-1] + (w, g)).sum(dim=-2))
        ofs += g * w
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def slot_segment_sum(
    x: torch.Tensor, shapes, inv_pos: torch.Tensor
) -> torch.Tensor:
    """Per-landmark sum for slot-ordered x [..., O_pad] -> [..., M]
    (canonical landmark order)."""
    return slot_part_sums(x, shapes).index_select(-1, inv_pos)


def slot_row_expand(rows: torch.Tensor, shapes) -> torch.Tensor:
    """Per-slot-row values [..., n_slot_rows] -> per-observation
    [..., O_pad]: the broadcast half of slot_expand without the
    canonical-order gather. slot_row_expand(slot_part_sums(x))
    re-expands a per-landmark reduction with no index gathers."""
    parts = []
    ofs = 0
    for g, w in shapes:
        blk = rows[..., ofs : ofs + g]
        parts.append(
            blk.unsqueeze(-2).expand(blk.shape[:-1] + (w, g))
            .reshape(rows.shape[:-1] + (g * w,))
        )
        ofs += g
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def slot_expand(
    s: torch.Tensor, shapes, lm_order: torch.Tensor
) -> torch.Tensor:
    """Inverse of slot_segment_sum's indexing: per-landmark values
    s [..., M] -> per-observation [..., O_pad] (slot order)."""
    return slot_row_expand(s.index_select(-1, lm_order), shapes)

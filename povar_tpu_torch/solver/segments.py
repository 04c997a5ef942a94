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
are padded up to powers of two with zero-weight slots.

The window planners of the JAX package (`plan_camera_order`,
`choose_window_width`, `build_window_plan`, ...) are copied too: the
SPMD window layout (parallel/spmd.py) plans with them. The camera
windows themselves (the JAX package's large-N TPU layout, per-window
camera tables) have no counterpart: a GPU kernel gathers a camera row
by index at any N.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class PaddedReduce(NamedTuple):
    """Static gather/reduce plan for one segmentation of the obs axis.

    idx[b]:  [G_b, L_b] int64 (int32 in the banded CHOLESKY's plan) —
             observation positions of each segment in bucket b, padded
             with arbitrary valid positions
    mask[b]: [G_b, L_b] bool — True for real entries
    inv_order: [S] of idx's type — maps canonical segment id -> position
             in the bucket-concatenated output
    """

    idx: Tuple[torch.Tensor, ...]
    mask: Tuple[torch.Tensor, ...]
    inv_order: torch.Tensor


def _build_padded_reduce(
    seg_ids: np.ndarray, num_segments: int, device="cpu",
    index_dtype=np.int64,
) -> PaddedReduce:
    """Group observation positions by segment id into power-of-two
    padded buckets (the JAX package's plan, filled bucket by bucket
    instead of segment by segment; the banded CHOLESKY plans millions of
    segments). `index_dtype`: the integer type of idx and inv_order
    (the JAX package's is int32)."""
    order = np.argsort(seg_ids, kind="stable")
    # ids outside [0, num_segments) belong to no segment; negative ones
    # sort first
    inside = (seg_ids >= 0) & (seg_ids < num_segments)
    counts = np.bincount(seg_ids[inside], minlength=num_segments)
    starts = np.cumsum(counts) - counts + np.count_nonzero(seg_ids < 0)

    # bucket index = ceil(log2(max(count,1)))
    buckets = np.zeros(num_segments, dtype=np.int64)
    nonzero = counts > 0
    buckets[nonzero] = np.ceil(
        np.log2(np.maximum(counts[nonzero], 1))
    ).astype(np.int64)

    idx_list = []
    mask_list = []
    seg_order = []
    for b in np.nonzero(np.bincount(buckets))[0].tolist():
        length = 1 << b
        segs = np.nonzero(buckets == b)[0]
        g = len(segs)
        idx = np.zeros(g * length, dtype=index_dtype)
        mask = np.zeros(g * length, dtype=bool)
        # row r holds segment segs[r]'s positions in sorted order
        c = counts[segs]
        live = c > 0
        if length == 1:  # every count is 0 or 1
            at = np.nonzero(live)[0]
            idx[at] = order[starts[segs[at]]]
            mask[at] = True
        else:
            c = c[live]
            first = np.repeat(np.nonzero(live)[0] * length - np.cumsum(c)
                              + c, c)
            k = np.arange(int(c.sum()))
            src = np.repeat(starts[segs[live]] - np.cumsum(c) + c, c) + k
            idx[first + k] = order[src]
            mask[first + k] = True
        idx_list.append(torch.as_tensor(idx.reshape(g, length),
                                        device=device))
        mask_list.append(torch.as_tensor(mask.reshape(g, length),
                                         device=device))
        seg_order.append(segs)

    inv_order = np.empty(num_segments, dtype=index_dtype)
    inv_order[np.concatenate(seg_order) if seg_order else
              np.zeros(0, np.int64)] = np.arange(num_segments)
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


def slot_widths(counts: np.ndarray) -> np.ndarray:
    """The slot width of each observation count: exact up to
    SLOT_EXACT_MAX (an empty landmark or row takes one slot), the next
    power of two above."""
    c = np.asarray(counts, dtype=np.int64)
    out = np.maximum(c, 1)
    big = c > SLOT_EXACT_MAX
    out[big] = np.left_shift(1, np.ceil(np.log2(c[big])).astype(np.int64))
    return out


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

    widths = slot_widths(counts)
    perm_parts = []
    weight_parts = []
    shapes = []
    lm_order_parts = []
    for w in np.unique(widths).tolist():
        # every landmark of slot width w at once, not a Python step per
        # landmark (4.6M at final-13682): its slots take its
        # observations in order, then repeat its first one (observation
        # 0 when it has none), with weight 0
        lms = np.nonzero(widths == w)[0]
        g = len(lms)
        c = counts[lms][:, None]
        j = np.arange(w)[None, :]
        src = starts[lms][:, None] + np.where(j < c, j, 0)
        blk_idx = np.where(c > 0, order.take(src, mode="clip"), 0) if len(
            order) else np.zeros((g, w), dtype=np.int64)
        blk_w = (j < c).astype(np.float64)
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


# ---------------------------------------------------------------------
# Window planning (numpy; povar_tpu/solver/segments.py:360-600), used by
# the SPMD window layout (parallel/spmd.py) to order cameras and pack
# landmark slot rows into camera windows. Copied as they are: the SPMD
# plan must come out array for array as the JAX package's. The windows
# bound the TPU's in-VMEM one-hot; here they only shape the lane layout
# (which landmarks share a window, and so a device), since a GPU kernel
# gathers a camera row by its global index.
# ---------------------------------------------------------------------

WINDOW_W = 512  # largest supported window (VMEM bound on the one-hot)
WINDOW_CHOICES = (128, 256, 512)


def _lm_spans(obs_cam, obs_lm, num_landmarks):
    """Per-landmark (lo, hi) camera index range; unobserved -> (0, 0)."""
    lo = np.full(num_landmarks, np.iinfo(np.int64).max, dtype=np.int64)
    hi = np.full(num_landmarks, -1, dtype=np.int64)
    np.minimum.at(lo, obs_lm, obs_cam)
    np.maximum.at(hi, obs_lm, obs_cam)
    seen = hi >= 0
    lo[~seen] = 0
    hi[~seen] = 0
    return lo, hi


def camera_span_stats(
    obs_cam: np.ndarray, obs_lm: np.ndarray, num_landmarks: int
):
    """Per-landmark camera-index span statistics (span = hi - lo + 1).
    Returns (max_span, num_over_largest_window) — the inputs to both
    the window-width choice and the fallback diagnostics."""
    lo, hi = _lm_spans(
        np.asarray(obs_cam), np.asarray(obs_lm), num_landmarks
    )
    spans = hi - lo + 1
    return int(spans.max()), int(np.sum(spans > WINDOW_W))


def rcm_camera_order(
    obs_cam: np.ndarray,
    obs_lm: np.ndarray,
    num_cameras: int,
    lm_skip: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Bandwidth-minimizing camera ordering by reverse Cuthill-McKee
    over the camera co-observation graph, the TPU-planning analogue of
    the reference's camera-camera adjacency (bal_problem.cpp:268-303).

    Returns pos [N]: pos[c] = rank of camera c in the new order. The
    graph uses chain+star edges per landmark (first camera to every
    other, plus consecutive pairs) — O(sum obs) edges that bound each
    landmark's span by ~2x the graph bandwidth, vs O(sum obs^2) for
    the full clique. `lm_skip` [M] bool excludes landmarks from the
    graph (incompressible loop closures, which would otherwise drag
    every local span wider)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    obs_cam = np.asarray(obs_cam, dtype=np.int64)
    obs_lm = np.asarray(obs_lm)
    if lm_skip is not None:
        keep = ~lm_skip[obs_lm]
        obs_cam = obs_cam[keep]
        obs_lm = obs_lm[keep]
    order = np.argsort(obs_lm, kind="stable")
    cam_s = obs_cam[order]
    lm_s = obs_lm[order]
    same = lm_s[1:] == lm_s[:-1]
    # chain edges: consecutive cameras of the same landmark
    rows = cam_s[:-1][same]
    cols = cam_s[1:][same]
    # star edges: landmark's first camera to each later one
    first_pos = np.searchsorted(lm_s, lm_s)  # first index of each lm
    rows2 = cam_s[first_pos]
    rows = np.concatenate([rows, rows2])
    cols = np.concatenate([cols, cam_s])
    data = np.ones(len(rows), dtype=np.int8)
    g = coo_matrix(
        (data, (rows, cols)), shape=(num_cameras, num_cameras)
    ).tocsr()
    perm = reverse_cuthill_mckee(g + g.T, symmetric_mode=True)
    pos = np.empty(num_cameras, dtype=np.int64)
    pos[perm] = np.arange(num_cameras, dtype=np.int64)
    return pos


def plan_camera_order(
    obs_cam: np.ndarray, obs_lm: np.ndarray, num_cameras: int,
    num_landmarks: int,
) -> Optional[np.ndarray]:
    """Choose the camera ordering the window planner works in: the
    best of {identity, RCM, RCM without heavy outlier landmarks} under
    the window_cost_model (modeled one-hot lanes(w)*w at each
    candidate's best width). Returns pos [N] or None for identity.

    Heavy landmarks (obs count >> median) act like loop closures:
    including their star edges drags every local span wider, so a
    candidate ordering excludes them and lets them ride the overflow
    partition instead."""
    obs_cam = np.asarray(obs_cam)
    obs_lm = np.asarray(obs_lm)

    def score(cam):
        # the same lanes(w)*w model the width choice minimizes
        w, cost = window_cost_model(cam, obs_lm, num_landmarks)
        return (cost, w)

    cands = [(score(obs_cam), None)]
    pos1 = rcm_camera_order(obs_cam, obs_lm, num_cameras)
    cands.append((score(pos1[obs_cam]), pos1))
    counts = np.bincount(obs_lm, minlength=num_landmarks)
    med = max(float(np.median(counts[counts > 0])), 1.0)
    heavy = counts > max(4.0 * med, 16.0)
    if heavy.any() and not heavy.all():
        pos2 = rcm_camera_order(
            obs_cam, obs_lm, num_cameras, lm_skip=heavy
        )
        cands.append((score(pos2[obs_cam]), pos2))
    return min(cands, key=lambda c: c[0])[1]


def _bucket_lanes(counts: np.ndarray) -> int:
    """Total slot lanes for per-row observation counts under the
    build_slot_plan_windowed bucket rule (exact up to SLOT_EXACT_MAX,
    next power of two above)."""
    counts = counts[counts > 0]
    small = counts <= SLOT_EXACT_MAX
    lanes = int(counts[small].sum())
    big = counts[~small]
    if len(big):
        lanes += int(
            (1 << np.ceil(np.log2(big)).astype(np.int64)).sum()
        )
    return lanes


def window_cost_model(
    obs_cam: np.ndarray, obs_lm: np.ndarray, num_landmarks: int
) -> tuple:
    """(best width, modeled one-hot contraction cost) over
    WINDOW_CHOICES: cost(w) = lanes(w) * w. Every slot lane (real or
    bucket pad) pays an O(w) one-hot gather/scatter per kernel pass,
    so the cost of a width is the EXACT lane count its plan would
    produce — including the extra grid-cell sub-rows that landmarks
    with span > w split into (build_window_plan) — times the width. A
    width whose overflow rows cost less than the wider window's
    universal 2-4x one-hot tax wins: one medium-span landmark
    population no longer forces the widest window on everyone (the
    round-2 overflow-budget rule did exactly that on mixed-span
    problems, a 0.22x throughput cliff)."""
    obs_cam = np.asarray(obs_cam, dtype=np.int64)
    obs_lm = np.asarray(obs_lm, dtype=np.int64)
    lo, hi = _lm_spans(obs_cam, obs_lm, num_landmarks)
    span = hi - lo  # inclusive span minus one; row is normal if < w
    lm_counts = np.bincount(obs_lm, minlength=num_landmarks)
    best_w, best_cost = None, None
    for w in WINDOW_CHOICES:
        normal = span < w
        lanes = _bucket_lanes(lm_counts[normal])
        ovf = ~normal[obs_lm]
        if ovf.any():
            # one sub-row per occupied (landmark, width-w grid cell)
            key = obs_lm[ovf] * (int(obs_cam.max()) // w + 2) + (
                obs_cam[ovf] // w
            )
            _, cell_counts = np.unique(key, return_counts=True)
            lanes += _bucket_lanes(cell_counts)
        cost = lanes * w
        if best_cost is None or cost < best_cost:
            best_w, best_cost = w, cost
    return best_w, best_cost


def choose_window_width(
    obs_cam: np.ndarray, obs_lm: np.ndarray, num_landmarks: int
) -> int:
    """Window width minimizing the window_cost_model."""
    return window_cost_model(obs_cam, obs_lm, num_landmarks)[0]


def build_window_plan(
    obs_cam: np.ndarray,
    obs_lm: np.ndarray,
    num_landmarks: int,
    width: int = WINDOW_W,
):
    """Window packing of landmark slot ROWS by camera span.

    Landmarks whose camera span fits `width` pack greedily (sorted by
    their lowest camera) into windows with arbitrary starts, one row
    per landmark — the round-2 scheme. Landmarks whose span exceeds
    `width` (loop closures etc.) no longer make the plan infeasible:
    their observations are partitioned by camera into a fixed GRID of
    width-`width` cells, producing one sub-landmark row per occupied
    (landmark, cell); the per-landmark sums are then re-combined across
    rows by the caller (slot plan `combine`), mirroring how duplicated
    cameras across windows are combined on the camera side. This
    replaces the reference's arbitrary-incidence landmark blocks
    (sc/landmark_block.hpp:58-133) with no feasibility cliff.

    Returns (obs_row [O] i64 slot-row id per observation,
    row_window [R] i32, row_lm [R] i64 canonical landmark per row,
    win_start [n_win] i64)."""
    obs_cam = np.asarray(obs_cam, dtype=np.int64)
    obs_lm = np.asarray(obs_lm, dtype=np.int64)
    lo, hi = _lm_spans(obs_cam, obs_lm, num_landmarks)
    normal = (hi - lo) < width

    # greedy packing of normal landmarks (one row per landmark): in lo
    # order, a landmark whose hi reaches the current window's start +
    # width opens a window at its lo. Every landmark before a window's
    # first one ends below that bound (its own window started no later),
    # so the next window opens at the first landmark where the running
    # maximum of hi reaches it: one search per window, not a Python step
    # per landmark (millions at final-13682)
    order = np.argsort(lo, kind="stable")
    order = order[normal[order]]
    lo_s = lo[order]
    run_hi = np.maximum.accumulate(hi[order]) if len(order) else lo_s
    firsts = []
    i = 0
    while i < len(order):
        firsts.append(i)
        i = int(np.searchsorted(run_hi, lo_s[i] + width, side="left"))
    row_of_lm = np.full(num_landmarks, -1, dtype=np.int64)
    row_of_lm[order] = np.arange(len(order))
    row_window = [np.repeat(np.arange(len(firsts)),
                            np.diff(firsts + [len(order)]))]
    row_lm = [order]
    starts = [lo_s[firsts]]

    obs_row = row_of_lm[obs_lm]
    if not normal.all():
        # overflow rows: grid cells of stride `width`
        ovf = ~normal[obs_lm]
        cell = obs_cam[ovf] // width
        key = obs_lm[ovf] * (int(obs_cam.max()) // width + 2) + cell
        uniq, inv = np.unique(key, return_inverse=True)
        base = len(order)
        obs_row[np.nonzero(ovf)[0]] = base + inv
        # window per occupied cell (dedup grid starts)
        first = np.zeros(len(uniq), dtype=np.int64)
        first[inv[::-1]] = np.nonzero(ovf)[0][::-1]  # first obs per row
        cell_of_row = obs_cam[first] // width
        grid_cells, grid_inv = np.unique(cell_of_row, return_inverse=True)
        starts.append(grid_cells * width)
        row_window.append(len(firsts) + grid_inv)
        row_lm.append(obs_lm[first])

    return (
        obs_row,
        np.concatenate(row_window).astype(np.int32),
        np.concatenate(row_lm).astype(np.int64),
        np.concatenate(starts).astype(np.int64),
    )

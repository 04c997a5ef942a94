"""Multi-device windowed execution: each rank owns whole camera windows.

The counterpart of povar_tpu/parallel/spmd.py. The plan half is the JAX
package's numpy, copied: `build_spmd_plan` assigns whole (cloned,
fixed-profile) camera windows to devices and overflow landmarks by load,
and uniformizes every static dimension, so that every device runs one
program (`SpmdPlan`, device-major arrays; `build_uniform_combine`, the
device-stacked slot-row -> landmark reduce). It must come out array for
array as the JAX package's: the tests hold it to that. It leaves out
the JAX plan's window maps of the TPU kernels (cam_local, kmap,
win_gather, win_scatter): a GPU kernel gathers a camera row by its
global index (plan.cam), so the plan, like the one-device path, takes
any camera count (the TPU's 1,024-camera one-hot limit does not apply).
Where the JAX package's plan steps through rows, landmarks and windows
in Python, the port's computes the same arrays with whole-array numpy
(`_split_clones`, the fill by slot width): final-13682's
~4.6M slot rows.

The execution half replaces `shard_map` and `psum` by one process per
device (parallel/mesh.py). `SpmdStage1Solver` / `SpmdStage2Solver` are
the single-device stage solvers with the JAX package's landmark-layout
overrides: per-landmark reductions stay on the rank (the three slot
reduce/expand kernels of ops/spmd_kernels.py over the uniform window
layout, plus the combine reduce), and only the per-camera accumulators
([12, N], [144, N], ...) and the LM scalars are all-reduced, through the
base class hooks (solver/slots.SlotSolver._psum). The method bodies are
the single-device ones, so every ported per-observation kernel runs
unchanged on the rank's lanes, and every rank takes the same LM
decisions from the same all-reduced numbers. An f64 state runs in mixed
precision (f32 storage and solves) or in pure f64, where the rank's
storage, solves and kernels (their f64 instantiations) are f64 on the
same structured layout, as the JAX package's SPMD solvers run pure f64
through its XLA mirrors. Camera state is replicated
on every rank; landmark state lives in the plan's device-major padded
order, each rank holding its shard of m_dev landmarks (`pad_landmarks`,
`unpad_landmarks`).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from povar_tpu_torch.ops import spmd_kernels
from povar_tpu_torch.options import SolverOptions, SolverType
from povar_tpu_torch.solver.segments import (
    PaddedReduce,
    _build_padded_reduce,
    build_window_plan,
    choose_window_width,
    padded_segment_sum,
    plan_camera_order,
    slot_widths,
)
from povar_tpu_torch.solver.slots import Obs, common_unsupported
from povar_tpu_torch.solver.stage1 import Stage1Solver
from povar_tpu_torch.solver.stage2 import Stage2Solver

# the plan's window lane alignment: the JAX package's PART_ALIGN
# (povar_tpu/ops/pallas_pose.py), kept so that the lane layout is its
PART_ALIGN = 4096

# per-part row caps are padded to this so the [w, cap] reshape in
# spmd_part_sums / spmd_expand_rows keeps cap on the 128-lane tile
ROW_ALIGN = 128


class ClassLayout(NamedTuple):
    """Static per-device layout of one window class: n_windows windows,
    each with `parts` = ((cap, w), ...) rows and win_lanes total lanes
    (profile lanes + tail pad to the block alignment)."""

    n_windows: int
    parts: Tuple[Tuple[int, int], ...]
    win_lanes: int


class SpmdPlan(NamedTuple):
    """Host-built sharded windowed plan (all numpy; device-major)."""

    n_dev: int
    width: int
    layout: Tuple[ClassLayout, ...]  # static; identical per device
    n_win_dev: int  # total windows per device (sum of class counts)
    o_dev: int  # obs lanes per device
    m_dev: int  # landmark slots per device
    n_rows_dev: int  # slot rows per device
    # per-lane arrays [D * o_dev]
    perm: np.ndarray  # original obs index per lane (pads repeat 0)
    pad_weight: np.ndarray  # 0/1
    cam: np.ndarray  # original camera id per lane
    lm_local: np.ndarray  # device-local landmark id per lane
    # per-slot-row arrays [D * n_rows_dev]
    lm_order: np.ndarray  # device-local landmark id (pads -> 0)
    row_lm_ext: np.ndarray  # device-local lm id, pads -> m_dev
    # per-landmark-slot arrays [D * m_dev]
    lm_mask: np.ndarray  # 1 real / 0 fake
    # canonical landmark id -> global padded position [n_lms]
    lm_perm: np.ndarray
    # whether any landmark owns several rows (span overflow)
    has_duplicates: bool
    # diagnostics
    lane_utilization: float  # real obs lanes / total lanes


def _assign_overflow(ovf_obs_counts, n_dev):
    """Balance overflow landmarks over devices by observation count
    (largest first, each to the least loaded device, the first of equal
    loads): the device of each. Exact integer loads in Python, one step
    a landmark."""
    dev = np.zeros(len(ovf_obs_counts), dtype=np.int64)
    if n_dev == 1:
        return dev
    order = np.argsort(-ovf_obs_counts)
    loads = [0] * n_dev
    out = []
    for c in ovf_obs_counts[order].tolist():
        d = loads.index(min(loads))
        out.append(d)
        loads[d] += c
    dev[order] = out
    return dev


def _split_clones(group, width, caps):
    """Every window's rows split into fixed-profile clones, for all
    windows at once: rows (given in ascending row order) grouped by
    `group` (ascending), within a group by width, chunk k of a group's
    rows of width w (caps[w] rows a chunk) going to the group's k-th
    clone. Returns (clone [R]: global clone index, groups in order;
    slot [R]: the row's place in its clone's part of width w; the
    clones of each group present, in group order)."""
    n = len(group)
    cap = np.zeros(max(caps) + 1, dtype=np.int64)
    for w, c in caps.items():
        cap[w] = c
    order = np.argsort(group * len(cap) + width, kind="stable")
    g_s, w_s = group[order], width[order]
    new = np.ones(n, dtype=bool)
    new[1:] = (g_s[1:] != g_s[:-1]) | (w_s[1:] != w_s[:-1])
    run0 = np.nonzero(new)[0]
    rank = np.arange(n) - np.repeat(run0, np.diff(np.append(run0, n)))
    k = rank // cap[w_s]
    g_new = np.ones(n, dtype=bool)
    g_new[1:] = g_s[1:] != g_s[:-1]
    g0 = np.nonzero(g_new)[0]
    per_group = np.maximum.reduceat(k + 1, g0)
    first = np.cumsum(per_group) - per_group
    clone = np.empty(n, dtype=np.int64)
    slot = np.empty(n, dtype=np.int64)
    clone[order] = np.repeat(first, np.diff(np.append(g0, n))) + k
    slot[order] = rank % cap[w_s]
    return clone, slot, per_group


def build_spmd_plan(
    obs_cam: np.ndarray,
    obs_lm: np.ndarray,
    num_cameras: int,
    num_landmarks: int,
    n_dev: int,
    block_align: int,
) -> SpmdPlan:
    """Build the uniformized sharded windowed plan.

    Steps: choose the planning camera order and window width exactly
    like the single-chip path; build the row-based window plan; assign
    whole normal windows to devices contiguously and overflow
    landmarks by load; then uniformize (pad) every static dimension so
    shard_map sees one program."""
    obs_cam = np.asarray(obs_cam, dtype=np.int64)
    obs_lm = np.asarray(obs_lm, dtype=np.int64)

    pos = plan_camera_order(obs_cam, obs_lm, num_cameras, num_landmarks)
    cam_plan = obs_cam if pos is None else pos[obs_cam]
    width = choose_window_width(cam_plan, obs_lm, num_landmarks)
    obs_row, row_window, row_lm, win_start = build_window_plan(
        cam_plan, obs_lm, num_landmarks, width=width
    )
    n_rows = len(row_lm)
    row_counts = np.bincount(obs_row, minlength=n_rows)
    row_width = slot_widths(row_counts)

    # overflow landmarks own >1 row (a span > width always crosses >= 2
    # width-aligned grid cells); normal landmarks exactly 1
    lm_nrows = np.bincount(row_lm, minlength=num_landmarks)
    is_ovf_lm = lm_nrows > 1
    row_is_grid = is_ovf_lm[row_lm]

    # ---- clone construction ------------------------------------------
    # Natural windows vary wildly in row count; padding every window to
    # a max-over-windows profile wastes up to tens of percent. Instead
    # every window is SPLIT into fixed-profile CLONES (same camera
    # start; duplicated window columns combine like any shared camera):
    # per width w, at most cap_w rows per clone, with cap_w drawn from
    # the global row mix so a clone holds ~`budget` lanes. Padding is
    # then bounded by one partial chunk per width per window, and
    # devices balance by simply counting clones (all clones have equal
    # padded lane counts).
    WIDTHS = np.unique(row_width)
    norm_rows = ~row_is_grid

    def make_caps(mask, max_clones_per_dev):
        if not mask.any():
            return {}
        R = {
            int(w): int(np.sum(row_width[mask] == w)) for w in WIDTHS
        }
        R = {w: c for w, c in R.items() if c}
        total = sum(c * w for w, c in R.items())
        # smallest block-aligned clone budget that keeps the clone
        # count per device bounded: small clones bound the padding of
        # each window's PARTIAL last clone by one budget's worth
        budget = block_align * max(
            1,
            -(-total // (block_align * n_dev * max_clones_per_dev)),
        )
        # clamp by the global count: a width never needs more rows
        # per clone than it has rows in total (tiny problems)
        caps = {
            w: min(max(1, int(np.ceil(c * budget / total))), c)
            for w, c in R.items()
        }
        # ALIGN each cap to the lane tile (128): spmd_part_sums /
        # spmd_expand_rows reshape every part to [n_win, w, cap] and
        # reduce/broadcast over w. With cap % 128 == 0 that reshape is
        # a tile-preserving bitcast and the reduce a native sublane
        # sum; an unaligned cap forces XLA to relayout the whole lane
        # array per call (measured ~4.5x the copy floor at venice-89,
        # cap=1638). The extra rows are zero-weight fakes.
        caps = {
            w: -(-c // ROW_ALIGN) * ROW_ALIGN for w, c in caps.items()
        }
        # absorb the block-alignment pad into the dominant width so
        # full clones carry real rows in those lanes instead of pad —
        # in ROW_ALIGN steps so the cap stays tile-aligned
        lanes = sum(c * w for w, c in caps.items())
        pad = (-lanes) % block_align
        wd = max(R, key=R.get)
        caps[wd] += (pad // wd) // ROW_ALIGN * ROW_ALIGN
        return caps

    caps0 = make_caps(norm_rows, 256)
    caps1 = make_caps(row_is_grid, 64)
    D = n_dev

    # class 0: the natural windows' normal rows -> clones, in window
    # order, split over devices contiguously in equal counts (clones are
    # equal-sized)
    rows0 = np.nonzero(norm_rows)[0]
    lm_dev = np.full(num_landmarks, -1, dtype=np.int64)
    if len(rows0):
        clone0, slot0, per_win = _split_clones(
            row_window[rows0].astype(np.int64), row_width[rows0], caps0)
        n0 = int(per_win.sum())
        clone0_dev = np.arange(n0) * D // n0
        dev0 = clone0_dev[clone0]
        win0 = clone0 - np.searchsorted(clone0_dev, np.arange(D))[dev0]
        lm_dev[row_lm[rows0]] = dev0
        n_norm_dev = int(np.bincount(clone0_dev, minlength=D).max())
    else:
        n_norm_dev = 0

    # class 1, overflow landmarks: balanced over devices by obs count,
    # then each device's grid cells cloned
    rows1 = np.nonzero(row_is_grid)[0]
    n_grid_dev = 0
    if len(rows1):
        ovf_lms = np.nonzero(is_ovf_lm)[0]
        ovf_counts = np.bincount(
            row_lm, weights=row_counts.astype(np.float64),
            minlength=num_landmarks,
        )[ovf_lms].astype(np.int64)
        lm_dev[ovf_lms] = _assign_overflow(ovf_counts, D)
        dev1 = lm_dev[row_lm[rows1]]
        cell = win_start[row_window[rows1]] // width
        n_cell = int(cell.max()) + 1
        key1 = dev1 * n_cell + cell
        clone1, slot1, per_cell = _split_clones(key1, row_width[rows1],
                                                caps1)
        # a device's clones are contiguous, its cells in order
        dev_clones = np.bincount(np.unique(key1) // n_cell,
                                 weights=per_cell, minlength=D).astype(
            np.int64)
        win1 = clone1 - (np.cumsum(dev_clones) - dev_clones)[dev1]
        n_grid_dev = int(dev_clones.max())

    def class_layout(n_windows, caps):
        parts = tuple(
            (int(c), int(w)) for w, c in sorted(caps.items())
        )
        lanes = sum(c * w for c, w in parts)
        pad = (-lanes) % block_align
        return ClassLayout(
            n_windows=int(n_windows),
            parts=parts,
            win_lanes=lanes + pad,
        )

    layout = []
    if n_norm_dev:
        layout.append(class_layout(n_norm_dev, caps0))
    if n_grid_dev:
        layout.append(class_layout(n_grid_dev, caps1))
    layout = tuple(layout)
    n_win_dev = sum(cl.n_windows for cl in layout)
    o_dev = sum(cl.n_windows * cl.win_lanes for cl in layout)
    n_rows_dev = sum(
        cl.n_windows * sum(c for c, _w in cl.parts) for cl in layout
    )

    # ---- landmark shards ---------------------------------------------
    m_dev = 0
    dev_lms: List[np.ndarray] = []
    for d in range(D):
        dl = np.nonzero(lm_dev == d)[0]
        dev_lms.append(dl)
        m_dev = max(m_dev, len(dl))
    m_dev = max(m_dev, 1)
    lm_mask = np.zeros(D * m_dev)
    lm_perm = np.zeros(num_landmarks, dtype=np.int64)
    local_of = np.zeros(num_landmarks, dtype=np.int64)
    for d, dl in enumerate(dev_lms):
        lm_mask[d * m_dev : d * m_dev + len(dl)] = 1.0
        lm_perm[dl] = d * m_dev + np.arange(len(dl))
        local_of[dl] = np.arange(len(dl))

    # ---- fill per-device arrays --------------------------------------
    # each row's first lane and its slot row: a device holds its class-0
    # clones, then its grid clones, then fakes; in a window, part (cap,
    # w) lays slot element j of its i-th row on lane part_ofs + j*cap +
    # i, and the slot rows run (class, part, window, row-in-part) so the
    # vectorized per-class reduce (spmd_part_sums) matches
    row_lane = np.zeros(n_rows, dtype=np.int64)
    row_slot = np.zeros(n_rows, dtype=np.int64)
    classes = []
    if n_norm_dev:
        classes.append((layout[0], rows0, dev0, win0, slot0))
    if n_grid_dev:
        classes.append((layout[-1], rows1, dev1, win1, slot1))
    lane_ofs = row_ofs = 0
    for cl, rows, dev, win, slot in classes:
        part_lane = np.zeros(int(WIDTHS.max()) + 1, dtype=np.int64)
        part_row = np.zeros_like(part_lane)
        cap = np.zeros_like(part_lane)
        p = part_rows = 0
        for c, w in cl.parts:
            part_lane[w], part_row[w], cap[w] = p, part_rows, c
            p += c * w
            part_rows += c
        w_r = row_width[rows]
        row_lane[rows] = (dev * o_dev + lane_ofs + win * cl.win_lanes
                          + part_lane[w_r] + slot)
        row_slot[rows] = (dev * n_rows_dev + row_ofs
                          + part_row[w_r] * cl.n_windows
                          + win * cap[w_r] + slot)
        lane_ofs += cl.n_windows * cl.win_lanes
        row_ofs += cl.n_windows * part_rows
    assert lane_ofs == o_dev and row_ofs == n_rows_dev

    order = np.argsort(obs_row, kind="stable")
    row_obs_start = np.searchsorted(obs_row[order], np.arange(n_rows))

    perm = np.zeros(D * o_dev, dtype=np.int64)
    pad_w = np.zeros(D * o_dev)
    cam_lane = np.zeros(D * o_dev, dtype=np.int64)
    lm_lane = np.zeros(D * o_dev, dtype=np.int32)
    lm_order = np.zeros(D * n_rows_dev, dtype=np.int32)
    row_lm_ext_all = np.full(D * n_rows_dev, m_dev, dtype=np.int64)
    real_lanes = 0
    for w in WIDTHS.tolist():
        # every row of slot width w, of any class and device, at once
        rows_w = np.nonzero(row_width == w)[0]
        cap_w = np.where(row_is_grid[rows_w], caps1.get(w, 0),
                         caps0.get(w, 0))
        counts = row_counts[rows_w]  # [R]
        offs = row_obs_start[rows_w]  # [R]
        j = np.arange(w)
        lanes = row_lane[rows_w][:, None] + j[None, :] * cap_w[:, None]
        live = j[None, :] < counts[:, None]
        # pad lanes carry zero weight; any in-bounds obs index works
        # (count 0: an unobserved landmark's row, which the single-chip
        # plan also keeps)
        safe_j = np.minimum(j[None, :], np.maximum(counts[:, None] - 1, 0))
        po_mat = order[offs[:, None] + safe_j]  # [R, w]
        po_mat[counts == 0] = 0
        perm[lanes] = po_mat
        pad_w[lanes] = live.astype(pad_w.dtype)
        real_lanes += int(counts.sum())
        cam_lane[lanes] = np.where(live, obs_cam[po_mat], 0)
        lm_loc = local_of[row_lm[rows_w]]  # [R]
        lm_lane[lanes] = np.broadcast_to(
            lm_loc[:, None], lanes.shape).astype(np.int32)
        lm_order[row_slot[rows_w]] = lm_loc
        row_lm_ext_all[row_slot[rows_w]] = lm_loc

    return SpmdPlan(
        n_dev=D,
        width=int(width),
        layout=layout,
        n_win_dev=n_win_dev,
        o_dev=o_dev,
        m_dev=m_dev,
        n_rows_dev=n_rows_dev,
        perm=perm,
        pad_weight=pad_w,
        cam=cam_lane,
        lm_local=lm_lane,
        lm_order=lm_order,
        row_lm_ext=row_lm_ext_all,
        lm_mask=lm_mask,
        lm_perm=lm_perm,
        has_duplicates=bool(is_ovf_lm.any()),
        lane_utilization=real_lanes / max(D * o_dev, 1),
    )



def build_uniform_combine(row_lm_ext, n_dev, n_rows_dev, m_dev):
    """Device-stacked slot-row -> local-landmark combine reduce with
    IDENTICAL bucket shapes on every device (the JAX package's
    uniformity rule, kept so that the arrays are its). Returns a
    PaddedReduce of CPU tensors whose arrays are device-major
    concatenations on their first axis: idx/mask [D*G_b, L_b] per
    bucket, inv_order [D*(m_dev+1)]; `rank_combine` cuts one device's
    slice out."""
    reds = [
        _build_padded_reduce(
            row_lm_ext[d * n_rows_dev : (d + 1) * n_rows_dev],
            m_dev + 1,
        )
        for d in range(n_dev)
    ]
    # bucket set = union of lengths; G = max groups per bucket
    lengths = sorted(
        {int(i.shape[1]) for r in reds for i in r.idx}
    )
    g_max = {
        L: max(
            max(
                (int(i.shape[0]) for i in r.idx if i.shape[1] == L),
                default=0,
            )
            for r in reds
        )
        for L in lengths
    }
    idx_out = []
    mask_out = []
    inv_out = []
    for d, r in enumerate(reds):
        by_len = {int(i.shape[1]): k for k, i in enumerate(r.idx)}
        # positions shift when buckets are padded: recompute the
        # device's inv_order for the uniform bucket structure
        seg_pos = np.zeros(m_dev + 1, dtype=np.int64)
        pos0 = 0
        dev_idx = []
        dev_mask = []
        for L in lengths:
            G = g_max[L]
            if L in by_len:
                k = by_len[L]
                i_np = r.idx[k].numpy()
                m_np = r.mask[k].numpy()
                g = i_np.shape[0]
            else:
                i_np = np.zeros((0, L), np.int32)
                m_np = np.zeros((0, L), bool)
                g = 0
            i_pad = np.zeros((G, L), np.int32)
            m_pad = np.zeros((G, L), bool)
            i_pad[:g] = i_np
            m_pad[:g] = m_np
            dev_idx.append(i_pad)
            dev_mask.append(m_pad)
            # which segments live in this bucket, in group order: the
            # original inv_order maps segment -> concatenated position
            if g:
                inv = r.inv_order.numpy()
                # original start position of bucket k
                orig_start = sum(
                    int(r.idx[j].shape[0]) for j in range(k)
                )
                in_bucket = (inv >= orig_start) & (
                    inv < orig_start + g
                )
                seg_pos[in_bucket] = pos0 + (
                    inv[in_bucket] - orig_start
                )
            pos0 += G
        idx_out.append(dev_idx)
        mask_out.append(dev_mask)
        inv_out.append(seg_pos)
    idx = tuple(
        torch.as_tensor(
            np.concatenate([idx_out[d][b] for d in range(n_dev)], 0)
        )
        for b in range(len(lengths))
    )
    mask = tuple(
        torch.as_tensor(
            np.concatenate([mask_out[d][b] for d in range(n_dev)], 0)
        )
        for b in range(len(lengths))
    )
    inv_order = torch.as_tensor(
        np.concatenate(inv_out).astype(np.int32)
    )
    return PaddedReduce(idx=idx, mask=mask, inv_order=inv_order)


def rank_combine(combine: PaddedReduce, n_dev: int, rank: int,
                 device) -> PaddedReduce:
    """One device's [G_b, L_b] / [m_dev + 1] slice of a device-stacked
    combine reduce (build_uniform_combine), as int64 indices on
    `device`."""
    def mine(a):
        return a.reshape((n_dev, -1) + tuple(a.shape[1:]))[rank].to(device)

    return PaddedReduce(
        idx=tuple(mine(i).long() for i in combine.idx),
        mask=tuple(mine(m) for m in combine.mask),
        inv_order=mine(combine.inv_order).long(),
    )


# ---------------------------------------------------------------------
# Per-device reduces over the uniform layout (the JAX package's
# spmd_part_sums / spmd_expand_rows / spmd_reduce_reexpand, :561-651):
# one call of a kernel's wrapper over every class and part (the plain
# version for CPU tensors, the f32 or f64 kernel for CUDA tensors). In
# mixed precision the only f64 operand, the state expanded for the cost,
# is expanded as its f32 hi and lo halves, as the JAX package's
# _compute_error_df32 does (povar_tpu/solver/stage1.py:2228-2230); in
# pure f64 every operand is f64 and takes the f64 kernels.
# ---------------------------------------------------------------------


def _route(x: torch.Tensor, kernel, layout) -> torch.Tensor:
    """kernel([K, L] view of x [..., L]) reshaped to x's leading dims."""
    out = kernel(x.reshape(-1, x.shape[-1]), layout)
    return out.reshape(x.shape[:-1] + out.shape[-1:])


def spmd_part_sums(x: torch.Tensor, layout) -> torch.Tensor:
    """x [..., o_dev] -> per-slot-row sums [..., n_rows_dev]."""
    return _route(x, spmd_kernels.class_part_sums, layout)


def spmd_expand_rows(s_rows: torch.Tensor, layout,
                     hi_lo: bool = True) -> torch.Tensor:
    """Per-slot-row values [..., n_rows_dev] -> per-lane [..., o_dev]
    (window tail lanes get zeros), in the operand's dtype. With `hi_lo`
    (the mixed-precision cost) an f64 operand goes through the f32
    kernel as hi = f32(s) and lo = f32(s - hi), in one launch, and comes
    back as hi + lo in f64: 48 of f64's 53 bits, as the JAX package's
    double-float cost takes the state; without it (pure f64) through the
    f64 kernel, all 53."""
    if not (hi_lo and s_rows.dtype == torch.float64):
        return _route(s_rows, spmd_kernels.class_expand_rows, layout)
    hi = s_rows.float()
    lo = (s_rows - hi.double()).float()
    both = _route(torch.stack((hi, lo)), spmd_kernels.class_expand_rows,
                  layout).double()
    return both[0] + both[1]


def spmd_reduce_reexpand(x: torch.Tensor, layout) -> torch.Tensor:
    """Fused per-slot-row reduce-then-broadcast [..., o_dev] ->
    [..., o_dev] (the E0 power-term inner op with unique rows); tail
    lanes come back zero, as expand_rows(part_sums(x))."""
    return _route(x, spmd_kernels.class_reduce_reexpand, layout)


# ---------------------------------------------------------------------
# Sharded solvers: the stage solvers with the landmark-layout overrides
# of the JAX package's _SpmdCommon (:790-985), one rank's shard each.
# ---------------------------------------------------------------------


def spmd_unsupported(options: SolverOptions, n_cams: int,
                     dtype) -> Optional[str]:
    """Why the SPMD window layout does not run this configuration, or
    None: the port's refusals everywhere, and on a mesh the
    configurations the JAX package sends to its GSPMD fallback
    (pipeline._spmd_eligible) rather than to this path."""
    why = common_unsupported(options, n_cams, dtype)
    if why is not None:
        return why
    gspmd = ("on a mesh, which the JAX package runs on its GSPMD fallback "
             "(ROADMAP.md queue 1 item 13, multi-device)")
    if options.detailed_timing:
        # povar_tpu/solver/pipeline.py:27-43 sends it there; its SPMD
        # solver raises (povar_tpu/parallel/spmd.py:1022)
        return f"detailed_timing=True {gspmd}"
    if dtype != torch.float64:
        return f"an LM state of {dtype} {gspmd}"
    if options.pallas_kernels == "off":
        return f"pallas_kernels='off' {gspmd}"
    return None


class _SpmdCommon:
    """Construction from the plan and the landmark-layout overrides of
    the sharded stage solvers.

    L space (where per-landmark tables live between a slot reduce and an
    expansion) is the rank's slot-ROW order when every landmark owns one
    slot row: reduce, expand and the E0 reduce-reexpand are the three
    kernels, with no index gather, and the state crosses to and from the
    rank's landmark order once per stage (`lm_pack` / `lm_unpack`, a
    take and a combine). With overflow landmarks (rows duplicated
    within a rank: `plan.has_duplicates`) L space is the rank's landmark
    order itself, and every reduce goes through the combine."""

    PATH = ("the SPMD window layout (POWER_VARPROJ, POWER_SCHUR_COMPLEMENT "
            "or PCG and RIPOBA or RIPCG, structured, an f64 state in mixed "
            "precision or pure f64)")
    # the trial's sums are all-reduced over the mesh between kernels, so
    # the host loop drives it, as the JAX package's sharded solvers
    # (povar_tpu/parallel/spmd.py `supports_device_loop`): "auto" takes
    # the host loop, "on" raises ValueError (slots.use_device_loop)
    supports_device_loop = False

    def __init__(self, plan: SpmdPlan, obs_uv, num_cameras: int,
                 num_landmarks: int, options: SolverOptions, mesh,
                 dtype=torch.float64, obs_weight=None):
        if mesh.size != plan.n_dev:
            raise ValueError(f"plan for {plan.n_dev} devices on a mesh of "
                             f"{mesh.size}")
        self.plan = plan
        self.layout = plan.layout
        self.mesh = mesh
        self._obs_weight = obs_weight
        super().__init__(None, None, obs_uv, num_cameras, num_landmarks,
                         options, dtype=dtype, device=mesh.device)
        # ResidualInfo counts every rank's live observations
        self.n_obs_live = self._n_obs_global

    def unsupported(self, options, n_cams, dtype):
        return spmd_unsupported(options, n_cams, dtype)

    @staticmethod
    def uses_unstructured(options, dtype) -> bool:
        """Never: the mesh runs the structured window layout in mixed
        precision and in pure f64 (f64 storage, solves and kernels), as
        the JAX package's SPMD solvers set `use_pallas` whatever the
        precision (povar_tpu/parallel/spmd.py:1029-1038); the
        configurations that would take the unstructured one are refused
        (spmd_unsupported)."""
        return False

    def _expand_rows(self, s):
        """spmd_expand_rows with the mixed-precision cost's hi / lo
        expansion of an f64 operand; pure f64 expands natively."""
        return spmd_expand_rows(s, self.layout,
                                hi_lo=self.solve_dtype != torch.float64)

    def _make_obs(self, _obs_cam, _obs_lm, obs_uv):
        """This rank's lanes, slot rows and landmark slots of the plan;
        no slot shapes (the layout is `self.layout`)."""
        plan, d = self.plan, self.mesh.rank
        lanes = slice(d * plan.o_dev, (d + 1) * plan.o_dev)
        rows = slice(d * plan.n_rows_dev, (d + 1) * plan.n_rows_dev)
        uv = np.asarray(obs_uv)
        if uv.ndim == 2 and uv.shape[-1] == 2:
            uv = uv.T  # [2, O]
        w = plan.pad_weight.copy()
        if self._obs_weight is not None:
            w = w * np.asarray(self._obs_weight)[plan.perm]
        self._n_obs_global = int(np.sum(w > 0))
        self.combine = rank_combine(
            build_uniform_combine(plan.row_lm_ext, plan.n_dev,
                                  plan.n_rows_dev, plan.m_dev),
            plan.n_dev, d, self.device)

        def dev(a, dt=None):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                   device=self.device)

        obs = Obs(
            cam=dev(plan.cam[lanes].astype(np.int32)),
            lm=dev(plan.lm_local[lanes].astype(np.int32)),
            uv=dev(uv[:, plan.perm[lanes]], self.dtype),
            weight=dev(w[lanes], self.dtype),
            lm_order=dev(plan.lm_order[rows].astype(np.int64)),
            lm_inv=None,
            lm_mask=dev(plan.lm_mask[d * plan.m_dev:(d + 1) * plan.m_dev],
                        torch.float32),
        )
        return obs, None

    # landmark-axis layout overrides ----------------------------------
    def _combine(self, rows: torch.Tensor) -> torch.Tensor:
        """Slot rows [..., R] -> the rank's landmarks [..., m_dev] (the
        last combine segment is the pad-row bin)."""
        return padded_segment_sum(rows, self.combine)[..., :-1]

    def _seg_lm(self, x):
        return self._combine(spmd_part_sums(x.contiguous(), self.layout))

    def _gather_lm_x(self, s):
        return self._expand_rows(s.index_select(-1, self.obs.lm_order))

    def _seg_L(self, x):
        rows = spmd_part_sums(x.contiguous(), self.layout)
        return self._combine(rows) if self.plan.has_duplicates else rows

    def _expand_L(self, s):
        if self.plan.has_duplicates:
            return self._gather_lm_x(s)
        return self._expand_rows(s.contiguous())

    def _seg_lm_reexpand(self, u):
        if self.plan.has_duplicates:
            return self._gather_lm_x(self._seg_lm(u))
        return spmd_reduce_reexpand(u.contiguous(), self.layout)

    def _L_to_lm(self, s):
        return s if self.plan.has_duplicates else self._combine(s)

    def _lm_to_L(self, s):
        if self.plan.has_duplicates:
            return s.contiguous()
        return s.index_select(-1, self.obs.lm_order)

    # state conversion ------------------------------------------------
    def pad_landmarks(self, lm) -> torch.Tensor:
        """Canonical [n_lms, k] -> this rank's shard [m_dev, k] of the
        device-major padded order (fake landmarks zero), in the state
        dtype on the rank's device."""
        lm = np.asarray(lm)
        plan, d = self.plan, self.mesh.rank
        out = np.zeros((plan.n_dev * plan.m_dev,) + lm.shape[1:], lm.dtype)
        out[plan.lm_perm] = lm
        return torch.as_tensor(out[d * plan.m_dev:(d + 1) * plan.m_dev],
                               dtype=self.dtype, device=self.device)

    def unpad_landmarks(self, lm_shard: torch.Tensor) -> np.ndarray:
        """The ranks' shards [m_dev, k] -> canonical numpy [n_lms, k] on
        every rank (one all-gather)."""
        full = self.mesh.all_gather(lm_shard.contiguous())
        return full.cpu().numpy()[self.plan.lm_perm]


class SpmdStage1Solver(_SpmdCommon, Stage1Solver):
    """Stage-1 solver over one rank's shard of an SPMD plan
    (`SpmdStage1Solver(plan, obs_uv, num_cameras, num_landmarks, options,
    mesh)`); the API of Stage1Solver, with landmark state in the rank's
    shard (`pad_landmarks`). CHOLESKY is refused, as by the JAX
    package's."""

    def unsupported(self, options, n_cams, dtype):
        if options.solver_type_step_1 == SolverType.CHOLESKY:
            return ("CHOLESKY on a mesh (a single-device solver in the JAX "
                    "package too; ROADMAP.md queue 1 item 13, "
                    "multi-device)")
        return super().unsupported(options, n_cams, dtype)


class SpmdStage2Solver(_SpmdCommon, Stage2Solver):
    """Stage-2 solver over one rank's shard of an SPMD plan; the API of
    Stage2Solver."""

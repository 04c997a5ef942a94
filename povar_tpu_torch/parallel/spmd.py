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
global index (plan.cam).

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
decisions from the same all-reduced numbers. Camera state is replicated
on every rank; landmark state lives in the plan's device-major padded
order, each rank holding its shard of m_dev landmarks (`pad_landmarks`,
`unpad_landmarks`).
"""

from __future__ import annotations

from collections import defaultdict
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from povar_tpu_torch.ops import spmd_kernels
from povar_tpu_torch.options import SolverOptions, SolverType
from povar_tpu_torch.solver.segments import (
    SLOT_EXACT_MAX,
    PaddedReduce,
    _build_padded_reduce,
    build_window_plan,
    choose_window_width,
    padded_segment_sum,
    plan_camera_order,
)
from povar_tpu_torch.solver.slots import (
    MAX_CAMERAS,
    Obs,
    common_unsupported,
)
from povar_tpu_torch.solver.stage1 import Stage1Solver
from povar_tpu_torch.solver.stage2 import Stage2Solver

# the plan's window lane alignment: the JAX package's PART_ALIGN
# (povar_tpu/ops/pallas_pose.py), kept so that the lane layout is its
PART_ALIGN = 4096

# per-part row caps are padded to this so the [w, cap] reshape in
# spmd_part_sums / spmd_expand_rows keeps cap on the 128-lane tile
ROW_ALIGN = 128


def _width(c: int) -> int:
    if c <= SLOT_EXACT_MAX:
        return int(c) if c > 0 else 1
    return 1 << int(np.ceil(np.log2(c)))


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


def _assign_overflow(ovf_lms, ovf_obs_counts, n_dev):
    """Balance overflow landmarks over devices by observation count
    (largest first)."""
    loads = np.zeros(n_dev)
    assign = {}
    order = np.argsort(-ovf_obs_counts)
    for i in order:
        d = int(np.argmin(loads))
        assign[int(ovf_lms[i])] = d
        loads[d] += ovf_obs_counts[i]
    return assign


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
    o_real = len(obs_cam)

    pos = plan_camera_order(obs_cam, obs_lm, num_cameras, num_landmarks)
    cam_plan = obs_cam if pos is None else pos[obs_cam]
    width = choose_window_width(cam_plan, obs_lm, num_landmarks)
    obs_row, row_window, row_lm, win_start = build_window_plan(
        cam_plan, obs_lm, num_landmarks, width=width
    )
    n_rows = len(row_lm)
    row_counts = np.bincount(obs_row, minlength=n_rows)
    row_width = np.array([_width(c) for c in row_counts], dtype=np.int64)

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

    def split_clones(rows, caps):
        """Rows of one window -> list of per-clone row lists (chunked
        per width by the fixed caps)."""
        by_w = {}
        for rr in rows:
            by_w.setdefault(int(row_width[rr]), []).append(rr)
        n_clones = max(
            (
                -(-len(v) // caps[w])
                for w, v in by_w.items()
            ),
            default=1,
        )
        clones = [[] for _ in range(n_clones)]
        for w, v in by_w.items():
            c = caps[w]
            for j in range(0, len(v), c):
                clones[j // c].extend(v[j : j + c])
        return clones

    # class 0: natural normal windows -> clones, in window order
    clones0 = []  # (start_plan, [rows])
    if norm_rows.any():
        rows_by_win = {}
        for rr in np.nonzero(norm_rows)[0]:
            rows_by_win.setdefault(int(row_window[rr]), []).append(rr)
        for wwin in sorted(rows_by_win):
            for rows in split_clones(rows_by_win[wwin], caps0):
                clones0.append((int(win_start[wwin]), rows))
    # contiguous equal-count device split (clones are equal-sized)
    n0 = len(clones0)
    clone0_dev = (
        np.arange(n0) * n_dev // max(n0, 1) if n0 else np.array([], int)
    )
    lm_dev = np.full(num_landmarks, -1, dtype=np.int64)
    for ci, (_st, rows) in enumerate(clones0):
        for rr in rows:
            lm_dev[row_lm[rr]] = clone0_dev[ci]

    # overflow landmarks: balance by obs count, then clone each
    # device's grid cells
    grid_rows_idx = np.nonzero(row_is_grid)[0]
    clones1_by_dev = {d: [] for d in range(n_dev)}
    ovf_lms = np.nonzero(is_ovf_lm)[0]
    if len(ovf_lms):
        ovf_counts = np.bincount(
            row_lm, weights=row_counts.astype(np.float64),
            minlength=num_landmarks,
        )[ovf_lms].astype(np.int64)
        assign = _assign_overflow(ovf_lms, ovf_counts, n_dev)
        for m, d in assign.items():
            lm_dev[m] = d
        # one pass over grid rows grouped by (device, cell) — not a
        # per-device rescan of all grid rows
        grid_dev = lm_dev[row_lm[grid_rows_idx]]
        grid_cell = win_start[row_window[grid_rows_idx]] // width
        by_dev_cell = defaultdict(list)
        for rr, gd, cell in zip(
            grid_rows_idx, grid_dev, grid_cell
        ):
            by_dev_cell[(int(gd), int(cell))].append(rr)
        for (d, cell) in sorted(by_dev_cell):
            for rows in split_clones(by_dev_cell[(d, cell)], caps1):
                clones1_by_dev[d].append((cell * width, rows))

    n_norm_dev = (
        int(np.bincount(clone0_dev, minlength=n_dev).max()) if n0 else 0
    )
    n_grid_dev = max(
        (len(v) for v in clones1_by_dev.values()), default=0
    )

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

    # ---- fill per-device arrays --------------------------------------
    order = np.argsort(obs_row, kind="stable")
    row_obs_start = np.searchsorted(obs_row[order], np.arange(n_rows))
    row_obs_end = np.searchsorted(obs_row[order], np.arange(n_rows) + 1)

    D = n_dev
    perm = np.zeros(D * o_dev, dtype=np.int64)
    pad_w = np.zeros(D * o_dev)
    cam_lane = np.zeros(D * o_dev, dtype=np.int64)
    lm_lane = np.zeros(D * o_dev, dtype=np.int32)
    lm_order = np.zeros(D * n_rows_dev, dtype=np.int32)
    row_lm_ext_all = np.zeros(D * n_rows_dev, dtype=np.int64)

    m_dev = 0
    dev_lms: List[np.ndarray] = []
    for d in range(D):
        dl = np.nonzero(lm_dev == d)[0]
        dev_lms.append(dl)
        m_dev = max(m_dev, len(dl))
    m_dev = max(m_dev, 1)
    lm_mask = np.zeros(D * m_dev)
    lm_perm = np.zeros(num_landmarks, dtype=np.int64)

    real_lanes = 0
    for d in range(D):
        dl = dev_lms[d]
        lm_mask[d * m_dev : d * m_dev + len(dl)] = 1.0
        lm_perm[dl] = d * m_dev + np.arange(len(dl))
        local_of = np.zeros(num_landmarks, dtype=np.int64)
        local_of[dl] = np.arange(len(dl))

        # device-local windows: its class-0 clones in order, then its
        # grid clones, then fakes
        my0 = [clones0[i] for i in range(n0) if clone0_dev[i] == d]
        my1 = clones1_by_dev.get(d, [])
        lane_base = d * o_dev
        row_base = d * n_rows_dev
        lane_ofs = 0
        class_row_ofs = 0  # rows before the current class

        def fill_window(cl: ClassLayout, wi_c, rows_of_win):
            """Fill one window's lanes + slot rows. Slot-row canonical
            order is (class, part, window, row-in-part) so the
            vectorized per-class reduce (spmd_part_sums) matches."""
            nonlocal lane_ofs, real_lanes
            p = 0  # lane offset within the window
            part_rows = 0  # rows of earlier parts (whole class)
            rows_np = np.asarray(rows_of_win, dtype=np.int64)
            for cap, w in cl.parts:
                rows_w = (
                    rows_np[row_width[rows_np] == w]
                    if len(rows_np)
                    else rows_np
                )
                n_r = len(rows_w)
                assert n_r <= cap, (n_r, cap, w)
                rbase = (
                    row_base + class_row_ofs
                    + part_rows * cl.n_windows + wi_c * cap
                )
                if n_r:
                    # vectorized over the part's rows (the plan builds
                    # ~1M rows at venice-1778; a per-row Python loop
                    # here was 60% of plan-build time)
                    counts = row_counts[rows_w]  # [R]
                    offs = row_obs_start[rows_w]  # [R]
                    j = np.arange(w)
                    # slot-element-major: lane = part_ofs + j*cap + i
                    lanes = (
                        lane_base + lane_ofs + p
                        + j[None, :] * cap
                        + np.arange(n_r)[:, None]
                    )  # [R, w]
                    live = j[None, :] < counts[:, None]
                    # pad lanes carry zero weight; any in-bounds obs
                    # index works (count 0: an unobserved landmark's
                    # row, which the single-chip plan also keeps)
                    safe_j = np.minimum(
                        j[None, :], np.maximum(counts[:, None] - 1, 0)
                    )
                    po_mat = order[offs[:, None] + safe_j]  # [R, w]
                    po_mat[counts == 0] = 0
                    perm[lanes] = po_mat
                    pad_w[lanes] = live.astype(pad_w.dtype)
                    real_lanes += int(counts.sum())
                    cam_lane[lanes] = np.where(
                        live, obs_cam[po_mat], 0
                    )
                    lm_loc = local_of[row_lm[rows_w]]  # [R]
                    lm_lane[lanes] = np.broadcast_to(
                        lm_loc[:, None], lanes.shape
                    ).astype(np.int32)
                    lm_order[rbase : rbase + n_r] = lm_loc
                    row_lm_ext_all[rbase : rbase + n_r] = lm_loc
                row_lm_ext_all[rbase + n_r : rbase + cap] = m_dev
                p += cap * w
                part_rows += cap
            lane_ofs += cl.win_lanes

        # class 0: normal-window clones
        if layout and n_norm_dev:
            cl0 = layout[0]
            for wi_c, (_st, rows) in enumerate(my0):
                fill_window(cl0, wi_c, rows)
            for wi_c in range(len(my0), cl0.n_windows):
                fill_window(cl0, wi_c, [])  # fake window
            class_row_ofs += cl0.n_windows * sum(
                c for c, _w in cl0.parts
            )
        # class 1: grid clones
        if n_grid_dev:
            cl1 = layout[-1]
            for wi_c, (_st, rows) in enumerate(my1):
                fill_window(cl1, wi_c, rows)
            for wi_c in range(len(my1), cl1.n_windows):
                fill_window(cl1, wi_c, [])
            class_row_ofs += cl1.n_windows * sum(
                c for c, _w in cl1.parts
            )
        assert lane_ofs == o_dev and class_row_ofs == n_rows_dev

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
# version for CPU tensors, the f32 kernel for CUDA tensors). The only
# f64 operand, the state expanded for the mixed-precision cost, is
# expanded as its f32 hi and lo halves, as the JAX package's
# _compute_error_df32 does (povar_tpu/solver/stage1.py:2228-2230).
# ---------------------------------------------------------------------


def _route(x: torch.Tensor, kernel, layout) -> torch.Tensor:
    """kernel([K, L] view of x [..., L]) reshaped to x's leading dims."""
    out = kernel(x.reshape(-1, x.shape[-1]), layout)
    return out.reshape(x.shape[:-1] + out.shape[-1:])


def spmd_part_sums(x: torch.Tensor, layout) -> torch.Tensor:
    """x [..., o_dev] -> per-slot-row sums [..., n_rows_dev]."""
    return _route(x, spmd_kernels.class_part_sums, layout)


def spmd_expand_rows(s_rows: torch.Tensor, layout) -> torch.Tensor:
    """Per-slot-row values [..., n_rows_dev] -> per-lane [..., o_dev]
    (window tail lanes get zeros). An f64 operand goes through the f32
    kernel as hi = f32(s) and lo = f32(s - hi), in one launch, and comes
    back as hi + lo in f64: 48 of f64's 53 bits, as the JAX package's
    double-float cost takes the state."""
    if s_rows.dtype != torch.float64:
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
    if n_cams > MAX_CAMERAS:
        return (
            f"{n_cams} cameras > {MAX_CAMERAS} on a mesh (ROADMAP.md queue 1 "
            "item 13, multi-device: the mesh's larger-N plan; one device "
            "runs any N)"
        )
    if dtype == torch.float64 and not options.mixed_precision_solves:
        return (
            "mixed_precision_solves=False with an f64 state on a mesh: the "
            "mesh's pure f64 (the window layout's per-observation kernels "
            "and slot kernels in f64) is the part of ROADMAP.md queue 1 "
            "item 11, precision modes, still to come; one device runs it"
        )
    gspmd = ("on a mesh, which the JAX package runs on its GSPMD fallback "
             "(ROADMAP.md queue 1 item 13, multi-device)")
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
            "precision)")
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
        return spmd_expand_rows(s.index_select(-1, self.obs.lm_order),
                                self.layout)

    def _seg_L(self, x):
        rows = spmd_part_sums(x.contiguous(), self.layout)
        return self._combine(rows) if self.plan.has_duplicates else rows

    def _expand_L(self, s):
        if self.plan.has_duplicates:
            return self._gather_lm_x(s)
        return spmd_expand_rows(s.contiguous(), self.layout)

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

"""Banded direct Cholesky of the explicit reduced camera system (RCS):
CHOLESKY at any camera count.

The counterpart of povar_tpu/solver/band_chol.py. The reference factors
the sparse RCS with Eigen's SimplicialLLT (linearization_sc.hpp:
236-245), which has no camera-count ceiling; the JAX package maps the
same capability to dense panels, and the port keeps its plan and its
arithmetic:

  1. Cameras are reordered by reverse Cuthill-McKee over the camera
     co-visibility graph (segments.rcm_camera_order). BAL problems
     have strong temporal locality, so the RCS becomes a BANDED block
     matrix: block (i, j) is nonzero only when cameras i and j co-observe
     a landmark, |pos_i - pos_j| <= bw.

  2. A block-banded matrix of bandwidth bw <= K is block tridiagonal over
     supernodes of K consecutive cameras (B = 12K scalar dims): per
     supernode s, F_s = E_s L_{s-1}^-T, M_s = D_s - F_s F_s^T,
     L_s = chol(M_s), then a forward and a backward sweep. The JAX
     package computes this outside any Pallas kernel with its own
     blocked Cholesky over lax.scan; here each step is one library
     Cholesky (cholesky_ex) and triangular solve of a [B, B] panel, as
     the dense route's ops/linalg.solve_psd_dense.

  3. Assembly: S = blockdiag(Hpp) + lam I - A A^T with A the camera-
     landmark coupling (W_o Hll^-1/2); -A A^T is the sum of per-landmark
     observation-pair products WL_a WL_b^T, accumulated into the band by
     padded segment sums (segments.PaddedReduce) over host-planned
     (position, diagonal offset) keys, in chunks of PAIR_CHUNK pairs.

The plan (`build_band_plan`) is numpy, the JAX package's bit for bit;
`band_arrays_to` moves its index arrays to the solver's device once.
`assemble_band` and `solve_band` are torch, on whatever device their
operands live.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from povar_tpu_torch.solver.segments import (
    PaddedReduce,
    _build_padded_reduce,
    padded_segment_sum,
    rcm_camera_order,
)

# pair-stream chunking for the band assembly: bounds the [144, C]
# product intermediate (512k pairs * 576 B = ~300 MB in f32)
PAIR_CHUNK = 512 * 1024

# supernode width cap: K = 256 gives B = 3072 dense panels; beyond this
# the problem has no useful band structure and the iterative solvers are
# the right tool
MAX_SUPERNODE = 256

# unbandable fallback ceiling: forcing bw = N - 1 degenerates the plan to
# a FULL band (one dense supernode chain) through the same pair-stream
# assembly and factorization. The block table is O(N^2): 576 N^2 bytes
# in f32, 2.4 GB at this cap. The route (direct or PCG) decides the
# trajectory, so the port changes route where the JAX package does.
DENSE_UNBANDED_MAX = 2048


class BandMeta(NamedTuple):
    """Static shape metadata of the banded RCS solve."""

    n_cams: int
    bw: int  # block bandwidth in the RCM ordering
    K: int  # supernode width (cameras per supernode), K >= bw
    S: int  # number of supernodes (ceil(n/K))
    nb: int  # band storage rows = N * (bw + 1)


class BandArrays(NamedTuple):
    """Index arrays of the banded solve: numpy in a plan
    (`build_band_plan`; the pair chunks' reduces are CPU tensors), torch
    on the solver's device after `band_arrays_to`."""

    pos: object  # [N] camera id -> band position (RCM)
    diag_rows: object  # [N] band-storage row of block (pos, pos)
    pair_chunks: Tuple[Tuple[object, object, PaddedReduce], ...]
    d_idx: object  # [S, K, K] int32 into the block table
    e_idx: object  # [S, K, K] int32 into the block table


class BandPlan(NamedTuple):
    meta: BandMeta
    arrays: BandArrays


def _landmark_pairs(
    obs_cam: np.ndarray, obs_lm: np.ndarray, pos: np.ndarray,
    num_landmarks: int, bw: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Enumerate per-landmark observation pairs (a, b) ordered so
    pos[cam_a] <= pos[cam_b], including self-pairs (o, o), plus BOTH
    orders for distinct observations sharing a camera position (their
    products are not symmetric individually). Returns (ia, ib, key)
    with key = pos_a * (bw + 1) + (pos_b - pos_a)."""
    order = np.argsort(obs_lm, kind="stable")
    lm_sorted = obs_lm[order]
    starts = np.searchsorted(lm_sorted, np.arange(num_landmarks), "left")
    ends = np.searchsorted(lm_sorted, np.arange(num_landmarks), "right")

    ia_parts: List[np.ndarray] = []
    ib_parts: List[np.ndarray] = []
    counts = ends - starts
    # vectorize per distinct observation count
    for k in np.unique(counts):
        if k == 0:
            continue
        lms = np.nonzero(counts == k)[0]
        # [n_k, k] observation indices of each landmark
        rows = order[starts[lms][:, None] + np.arange(k)[None, :]]
        aa, bb = np.meshgrid(np.arange(k), np.arange(k), indexing="ij")
        up = aa <= bb  # unordered pairs incl. self
        oa = rows[:, aa[up]].ravel()
        ob = rows[:, bb[up]].ravel()
        pa, pb = pos[obs_cam[oa]], pos[obs_cam[ob]]
        swap = pa > pb
        oa2 = np.where(swap, ob, oa)
        ob2 = np.where(swap, oa, ob)
        ia_parts.append(oa2)
        ib_parts.append(ob2)
        # same-position distinct-obs pairs: both orders hit the
        # diagonal block and the two products are mutual transposes
        dup = (pa == pb) & (oa != ob)
        if dup.any():
            ia_parts.append(ob[dup])
            ib_parts.append(oa[dup])
    ia = np.concatenate(ia_parts) if ia_parts else np.zeros(0, np.int64)
    ib = np.concatenate(ib_parts) if ib_parts else np.zeros(0, np.int64)
    pa, pb = pos[obs_cam[ia]], pos[obs_cam[ib]]
    key = pa * (bw + 1) + (pb - pa)
    return ia, ib, key


def build_band_plan(
    obs_cam: np.ndarray, obs_lm: np.ndarray, num_cameras: int,
    num_landmarks: int, live: Optional[np.ndarray] = None,
    allow_dense: bool = False,
) -> Optional[BandPlan]:
    """The banded-RCS plan, or None when the RCM bandwidth exceeds
    MAX_SUPERNODE (no exploitable band structure). With `allow_dense`,
    an unbandable graph at num_cameras <= DENSE_UNBANDED_MAX degenerates
    to the FULL band (bw = N - 1, one dense supernode chain) instead.
    `live` is an optional per-observation mask excluding zero-weight
    padding rows from the pair stream (their products are exact
    zeros)."""
    obs_cam = np.asarray(obs_cam)
    obs_lm = np.asarray(obs_lm)
    keep = None
    if live is not None:
        keep = np.nonzero(np.asarray(live) > 0)[0]
        obs_cam_l, obs_lm_l = obs_cam[keep], obs_lm[keep]
    else:
        obs_cam_l, obs_lm_l = obs_cam, obs_lm
    pos = rcm_camera_order(obs_cam_l, obs_lm_l, num_cameras)
    pos = np.asarray(pos, np.int64)

    p_obs = pos[obs_cam_l]
    lo = np.full(num_landmarks, np.iinfo(np.int64).max)
    hi = np.full(num_landmarks, -1)
    np.minimum.at(lo, obs_lm_l, p_obs)
    np.maximum.at(hi, obs_lm_l, p_obs)
    seen = hi >= 0
    bw = int(np.max(hi[seen] - lo[seen])) if seen.any() else 0
    if bw > MAX_SUPERNODE:
        if not allow_dense or num_cameras > DENSE_UNBANDED_MAX:
            return None
        bw = num_cameras - 1  # full band: dense direct factorization
    # supernode width: >= bw, a multiple of 32 (the JAX package's rule,
    # which sizes its TPU panels)
    K = max(32, int(np.ceil(max(bw, 1) / 32)) * 32)
    S = int(np.ceil(num_cameras / K))
    nb = num_cameras * (bw + 1)

    ia, ib, key = _landmark_pairs(
        obs_cam_l, obs_lm_l, pos, num_landmarks, bw
    )
    if keep is not None:
        ia, ib = keep[ia], keep[ib]

    def chunk(c0):
        sl = slice(c0, c0 + PAIR_CHUNK)
        return (ia[sl].astype(np.int32), ib[sl].astype(np.int32),
                _build_padded_reduce(key[sl], nb, index_dtype=np.int32))

    # each chunk's reduce spans all nb segments: plan them on the host's
    # cores at once (numpy releases the GIL in the sorts and scatters)
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        chunks = list(pool.map(chunk, range(0, len(ia), PAIR_CHUNK)))

    # block table layout: [0, nb) = band blocks, [nb, 2nb) = their
    # transposes, 2nb = zero block, 2nb + 1 = identity block
    ZERO, EYE = 2 * nb, 2 * nb + 1

    def block_index(p: np.ndarray, q: np.ndarray) -> np.ndarray:
        """Vectorized index of block (p, q) in the table."""
        inb = (p >= 0) & (p < num_cameras) & (q >= 0) & (q < num_cameras)
        d = q - p
        upper = inb & (d >= 0) & (d <= bw)
        lower = inb & (d < 0) & (-d <= bw)
        idx = np.full(p.shape, ZERO, np.int64)
        idx[upper] = (p * (bw + 1) + d)[upper]
        idx[lower] = (q * (bw + 1) - d)[lower] + nb
        pad_diag = (p == q) & (p >= num_cameras) & (p < S * K)
        idx[pad_diag] = EYE
        return idx

    ii = np.arange(K)
    ss = np.arange(S)
    p_d = ss[:, None, None] * K + ii[None, :, None]
    q_d = ss[:, None, None] * K + ii[None, None, :]
    d_idx = block_index(
        np.broadcast_to(p_d, (S, K, K)).copy(),
        np.broadcast_to(q_d, (S, K, K)).copy(),
    ).astype(np.int32)
    q_e = (ss[:, None, None] - 1) * K + ii[None, None, :]
    e_idx = block_index(
        np.broadcast_to(p_d, (S, K, K)).copy(),
        np.broadcast_to(q_e, (S, K, K)).copy(),
    ).astype(np.int32)
    e_idx[0] = ZERO

    return BandPlan(
        meta=BandMeta(n_cams=num_cameras, bw=bw, K=K, S=S, nb=nb),
        arrays=BandArrays(
            pos=pos.astype(np.int32),
            diag_rows=(pos * (bw + 1)).astype(np.int32),
            pair_chunks=tuple(chunks),
            d_idx=d_idx, e_idx=e_idx,
        ),
    )


def band_arrays_to(arrs: BandArrays, device) -> BandArrays:
    """The plan's index arrays as torch tensors on `device` (int32, as
    the plan holds them; the pair positions and reduces too)."""
    def dev(a):
        return torch.as_tensor(a).to(device)

    return BandArrays(
        pos=dev(arrs.pos), diag_rows=dev(arrs.diag_rows),
        pair_chunks=tuple(
            (dev(ia), dev(ib), PaddedReduce(
                idx=tuple(dev(t) for t in red.idx),
                mask=tuple(dev(t) for t in red.mask),
                inv_order=dev(red.inv_order)))
            for ia, ib, red in arrs.pair_chunks),
        d_idx=dev(arrs.d_idx), e_idx=dev(arrs.e_idx),
    )


def plan_bytes(arrs: BandArrays) -> int:
    """Bytes of a plan's index arrays (on the host or on a device)."""
    def nbytes(a):
        return int(a.numel() * a.element_size()) if isinstance(
            a, torch.Tensor) else int(np.asarray(a).nbytes)

    total = sum(nbytes(a) for a in (arrs.pos, arrs.diag_rows, arrs.d_idx,
                                    arrs.e_idx))
    for ia, ib, red in arrs.pair_chunks:
        total += nbytes(ia) + nbytes(ib) + nbytes(red.inv_order)
        total += sum(nbytes(t) for t in red.idx + red.mask)
    return total


def solve_bytes(meta: BandMeta, arrs: BandArrays, dtype) -> int:
    """Bytes one banded solve holds at its peak besides the
    linearization, in `dtype`: the assembled band [nb, 144] and its block
    table [2 nb + 2, 144], one pair chunk's gathered operands and
    products with the padded sums over it, and the factor's panels (the
    L and F stacks, S [B, B] each less F_0, and four working panels)."""
    elem = torch.empty((), dtype=dtype).element_size()
    B = 12 * meta.K
    chunk = 0
    for ia, _ib, red in arrs.pair_chunks:
        padded = sum(int(np.prod(tuple(t.shape))) for t in red.idx)
        chunk = max(chunk, 2 * 36 * len(ia) + 3 * 144 * len(ia)
                    + 3 * 144 * padded)
    band = 144 * meta.nb + 144 * (2 * meta.nb + 2)
    panels = (2 * meta.S - 1 + 4) * B * B
    return elem * (band + max(chunk, panels))


def assemble_band(meta: BandMeta, arrs: BandArrays, wl: torch.Tensor,
                  hpp: torch.Tensor, lam) -> torch.Tensor:
    """The band storage [nb, 144] in wl's dtype: wl [12, 3, O]
    (observation last), hpp [12, 12, N], lam a number or a 0-d tensor
    (already in wl's dtype). Each chunk gathers WL at its pairs, forms
    the 144 products of each pair, and segment-sums them negated into
    the band; then hpp + lam I lands on the diagonal blocks."""
    dt, dev = wl.dtype, wl.device
    s_acc = torch.zeros((144, meta.nb), dtype=dt, device=dev)
    for ia, ib, red in arrs.pair_chunks:
        va = wl.index_select(-1, ia)  # [12, 3, C]
        vb = wl.index_select(-1, ib)
        # "iko,jko->ijo" summed over k in order, as the JAX package's
        # unrolled small_einsum
        prod = va[:, None, 0] * vb[None, :, 0]
        prod = prod + va[:, None, 1] * vb[None, :, 1]
        prod = prod + va[:, None, 2] * vb[None, :, 2]
        del va, vb
        s_acc += padded_segment_sum(-prod.reshape(144, ia.shape[0]), red)
        del prod
    eye = torch.eye(12, dtype=dt, device=dev)
    diag = hpp.permute(2, 0, 1).to(dt) + lam * eye[None]
    s_flat = s_acc.T.contiguous()
    del s_acc
    # diag_rows are distinct: one add per element
    s_flat.index_add_(0, arrs.diag_rows, diag.reshape(-1, 144))
    return s_flat


def solve_band(meta: BandMeta, arrs: BandArrays, s_flat: torch.Tensor,
               rhs: torch.Tensor) -> torch.Tensor:
    """Factor and solve the banded RCS: s_flat [nb, 144] from
    assemble_band (consumed: the block table replaces it), rhs [12, N]
    (column-major per camera as the dense route). Returns inc [12, N]
    (NOT negated) in s_flat's dtype, all NaN where a supernode is not
    positive definite (the JAX package's square root of a negative
    pivot), which the LM loop rejects. No host synchronisation.

    Each supernode's [B, B] panels D_s, E_s are gathered from the block
    table when its step runs; the factor keeps the L_s and F_s stacks
    for the two sweeps."""
    K, S, nb = meta.K, meta.S, meta.nb
    B = 12 * K
    dt, dev = s_flat.dtype, s_flat.device
    blocks = s_flat.reshape(nb, 12, 12)
    table = torch.cat([
        blocks,
        blocks.transpose(1, 2),
        torch.zeros((1, 12, 12), dtype=dt, device=dev),
        torch.eye(12, dtype=dt, device=dev)[None],
    ], dim=0)
    del blocks, s_flat

    def panel(idx):
        t = table.index_select(0, idx.reshape(-1)).reshape(K, K, 12, 12)
        return t.transpose(1, 2).reshape(B, B)

    ls, fs = [], [None]
    bad = torch.zeros((), dtype=torch.int32, device=dev)
    for s in range(S):
        m = panel(arrs.d_idx[s])
        if s:
            # F_s = E_s L_{s-1}^-T: F L_{s-1}^T = E
            f = torch.linalg.solve_triangular(
                ls[-1].mT, panel(arrs.e_idx[s]), upper=True, left=False)
            m = m - f @ f.mT
            fs.append(f)
        l_s, info = torch.linalg.cholesky_ex(m)
        del m
        bad = bad + info.to(torch.int32).clamp(max=1)
        ls.append(l_s)
    del table

    # rhs: camera-major [N * 12] in band position order, padded to S K
    r = torch.zeros((S * K, 12), dtype=dt, device=dev)
    r[arrs.pos.long()] = rhs.T.to(dt)
    r = r.reshape(S, B, 1)

    ys = []
    for s in range(S):
        v = r[s] if s == 0 else r[s] - fs[s] @ ys[-1]
        ys.append(torch.linalg.solve_triangular(ls[s], v, upper=False))
    # backward: x_s = L_s^-T (y_s - F_{s+1}^T x_{s+1})
    xs = [None] * S
    for s in reversed(range(S)):
        v = ys[s] if s == S - 1 else ys[s] - fs[s + 1].mT @ xs[s + 1]
        xs[s] = torch.linalg.solve_triangular(ls[s].mT, v, upper=True)

    x = torch.cat(xs, dim=0).reshape(S * K, 12)
    x = x.index_select(0, arrs.pos.long()).T
    return torch.where(bad == 0, x, torch.full_like(x, float("nan")))

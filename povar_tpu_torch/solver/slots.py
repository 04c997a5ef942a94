"""The slot layout and L-space state shared by both stage solvers.

The counterpart of the non-windowed half of povar_tpu's `CamWindows`
(povar_tpu/solver/stage1.py): the observation axis in slot order (each
landmark's observations in a fixed-width contiguous slot, padded with
zero-weight rows to a multiple of OBS_PAD), per-landmark tables in "L
space" (slot-row order, so that a per-landmark reduce and its
re-expansion are reshape-sums and broadcasts with no index gathers), and
the LM landmark state threaded through a solve in that order
(`LmState`). The camera windows of the JAX package (its large-N TPU
layout) have no counterpart: a GPU kernel gathers a camera row by index
at any N.

`SlotSolver` is the base of `Stage1Solver` and `Stage2Solver`: the
device check, the configuration gate, the observation layout, the
per-observation constants every kernel call takes, the fused power-term
plan (`plan_e0_fused`) and the CG preconditioner's apply.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from povar_tpu_torch.ops import cam_kernels, linalg
from povar_tpu_torch.options import (
    PreconditionerType,
    RobustNorm,
    SolverOptions,
)
from povar_tpu_torch.solver.common import accumulate_residual_info
from povar_tpu_torch.solver.segments import (
    build_slot_plan,
    slot_part_sums,
    slot_row_expand,
)

# the observation axis is padded with zero-weight rows to a multiple of
# this (povar_tpu/ops/pallas_cam.py OBS_PAD), so both packages see the
# same slot layout
OBS_PAD = 8192
# largest camera count of this path (povar_tpu/ops/pallas_cam.py
# MAX_CAMERAS); beyond it the JAX package switches to camera windows
MAX_CAMERAS = 1024
# widest slot part the fused power-series term takes
# (povar_tpu/ops/pallas_pose.py E0_TERM_MAX_W); wider parts and all after
# them run the composed kernels
E0_TERM_MAX_W = 16

ROBUST_CODE = {
    RobustNorm.NONE: 0,
    RobustNorm.HUBER: 1,
    RobustNorm.CAUCHY: 2,
}


class Obs(NamedTuple):
    """Static problem structure in slot order (segments.build_slot_plan):
    each landmark's observations occupy a fixed-width contiguous slot.
    cam: per-observation camera index [Op] (int32); uv: measurements
    [2, Op]; weight: 0/1 mask [Op] over slot pads (None when there are
    none); lm_order/lm_inv: slot-row <-> canonical landmark id maps."""

    cam: torch.Tensor
    uv: torch.Tensor
    weight: Optional[torch.Tensor]
    lm_order: torch.Tensor
    lm_inv: torch.Tensor


def mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batch-last matrix-vector product 'ijn,jn->in'."""
    return (m * v[None]).sum(dim=1)


class FusedPlan(NamedTuple):
    """Where the fused power-series term runs (`plan_e0_fused`).

    parts: (ofs, g, w) per fused slot part, in slot order: g landmarks
    of slot width w from observation `ofs` on, slot element j of
    landmark l at observation ofs + j * g + l (build_slot_plan's
    slot-element-major layout), so a part is read in place with no
    reshaped copy. suffix: None, or (cut, shapes) of the composed-kernel
    tail [cut, O) that still holds live observations."""

    parts: Tuple[Tuple[int, int, int], ...]
    suffix: Optional[Tuple[int, tuple]]


def plan_e0_fused(lm_shapes, weight) -> Optional[FusedPlan]:
    """The fused-term plan of povar_tpu's `CamWindows._plan_e0_fused`
    (povar_tpu/solver/stage1.py:576-636), or None where it declines.

    The prefix of slot parts with w <= E0_TERM_MAX_W runs fused; the
    first wider part and everything after it form the composed suffix,
    dropped when it holds no live observation. The plan is declined when
    no observation is live or when the suffix carries half or more of the
    live work. `weight`: the 0/1 slot weights [O] (numpy), or None where
    every row is live. The TPU's VMEM budget (e0_term_geometry) and lane
    padding have no counterpart: at N <= MAX_CAMERAS the JAX package's
    geometry accepts every part of width <= 16."""
    parts = []
    ofs = 0
    for g, w in lm_shapes:
        if w > E0_TERM_MAX_W:
            break
        parts.append((ofs, int(g), int(w)))
        ofs += g * w
    if not parts:
        return None
    o_pad = sum(g * w for g, w in lm_shapes)
    cut = ofs
    live = np.ones(o_pad, bool) if weight is None else np.asarray(weight) > 0
    live_total = int(live.sum())
    live_suffix = int(live[cut:].sum())
    if live_total == 0 or (live_total - live_suffix) / live_total < 0.5:
        return None
    suffix = (cut, tuple(lm_shapes[len(parts):])) if live_suffix else None
    return FusedPlan(parts=tuple(parts), suffix=suffix)


class LmState(NamedTuple):
    """Landmark state threaded through the LM loop in L space (slot-row
    order): `rows` is [K, L] in the state dtype (K = 3 euclidean in step
    1, 4 homogeneous in step 2). Produced by `lm_pack`, converted back
    to the canonical [M, K] layout by `lm_unpack`."""

    rows: torch.Tensor


def make_obs(
    obs_cam, obs_lm, obs_uv, num_cameras, num_landmarks, dtype, device,
) -> Tuple[Obs, tuple]:
    """Build the slot-ordered Obs on `device`. Returns (obs,
    lm_slot_shapes)."""
    obs_cam_np = np.asarray(obs_cam)
    obs_lm_np = np.asarray(obs_lm)
    obs_uv_np = np.asarray(obs_uv)
    if obs_uv_np.ndim == 2 and obs_uv_np.shape[-1] == 2:
        obs_uv_np = obs_uv_np.T  # accept [O, 2] input, use [2, O]
    if len(obs_cam_np) and (
        obs_cam_np.min() < 0 or obs_cam_np.max() >= num_cameras
    ):
        raise ValueError("camera index out of range [0, num_cameras)")
    if len(obs_lm_np) and (
        obs_lm_np.min() < 0 or obs_lm_np.max() >= num_landmarks
    ):
        raise ValueError("landmark index out of range [0, num_landmarks)")

    perm, pad_w, shapes, lm_order, inv_pos = build_slot_plan(
        obs_lm_np, num_landmarks, pad_to=OBS_PAD
    )
    w = pad_w if (pad_w < 1.0).any() else None

    def dev(a, dt=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)

    obs = Obs(
        cam=dev(obs_cam_np[perm].astype(np.int32)),
        uv=dev(obs_uv_np[:, perm], dtype),
        weight=None if w is None else dev(w, dtype),
        lm_order=dev(lm_order.astype(np.int64)),
        lm_inv=dev(inv_pos.astype(np.int64)),
    )
    return obs, shapes


def common_unsupported(
    options: SolverOptions, n_cams: int, dtype
) -> Optional[str]:
    """Why this configuration is outside both ported stages, or None
    (the checks that do not depend on the step)."""
    if dtype not in (torch.float64, torch.float32):
        return f"LM state dtype {dtype} (the states are f64 and f32)"
    if dtype == torch.float64 and not options.mixed_precision_solves:
        # an f32 state solves in f32 whatever this option says, as in
        # the JAX package (stage1.py:676-680)
        return (
            "mixed_precision_solves=False with an f64 state, the pure-f64 "
            "solve (ROADMAP.md queue 1 item 11, precision modes)"
        )
    if options.pallas_kernels == "off":
        return (
            "pallas_kernels='off', the unstructured path (ROADMAP.md "
            "queue 1 item 9)"
        )
    if n_cams > MAX_CAMERAS:
        return (
            f"{n_cams} cameras > {MAX_CAMERAS} (ROADMAP.md queue 1 item "
            "12, large N)"
        )
    if options.device_lm_loop == "on":
        return (
            "device_lm_loop='on' (ROADMAP.md queue 1 item 8, the device "
            "LM loop)"
        )
    if options.detailed_timing:
        return (
            "detailed_timing=True (ROADMAP.md queue 1 item 14, per-stage "
            "timing)"
        )
    return None


class SlotSolver:
    """Stage-solver base bound to one problem's observations on
    `device` ("cuda" launches the CUDA kernels; "cpu" runs their plain
    versions, as the tests do). Raises RuntimeError for "cuda" without a
    CUDA device and NotImplementedError, naming the ROADMAP.md item, for
    a configuration the port does not run yet (`unsupported` returns
    the reason or None); it never substitutes another path."""

    # what the subclass runs, for the NotImplementedError message
    PATH = ""

    def __init__(
        self,
        obs_cam,
        obs_lm,
        obs_uv,
        num_cameras: int,
        num_landmarks: int,
        options: SolverOptions,
        dtype,
        device,
        unsupported: Callable[[SolverOptions, int, object], Optional[str]],
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"{type(self).__name__}(device='cuda') but torch finds "
                    "no CUDA device"
                )
            # the f32 contractions must run in full f32, not TF32
            torch.backends.cuda.matmul.allow_tf32 = False
        self.n_cams = int(num_cameras)
        self.n_lms = int(num_landmarks)
        why = unsupported(options, self.n_cams, dtype)
        if why is not None:
            raise NotImplementedError(
                f"povar_tpu_torch runs {self.PATH} only; not ported yet: "
                f"{why}"
            )
        self.opts = options
        self.dtype = dtype
        self.solve_dtype = torch.float32
        self.robust = ROBUST_CODE[options.residual.robust_norm]
        self.huber = float(options.residual.huber_parameter)
        self.power_m = int(options.power_sc_iterations)
        self.obs, self.lm_shapes = make_obs(
            obs_cam, obs_lm, obs_uv, self.n_cams, self.n_lms, dtype,
            self.device,
        )
        self.jacobi_eps = options.effective_jacobi_scaling_epsilon(
            np.float32
        )
        o = int(self.obs.cam.shape[0])
        w = self.obs.weight
        # live-observation count for ResidualInfo (padding rows carry
        # zero weight and must not inflate num_obs / mean residuals)
        self.n_obs_live = o if w is None else int((w > 0).sum())
        sd = self.solve_dtype
        # per-observation constants of every kernel call, made once
        self._uv_s = self.obs.uv.to(sd)
        self._mask1 = (
            torch.ones((1, o), dtype=sd, device=self.device) if w is None
            else (w > 0).to(sd).reshape(1, -1)
        )
        # where the fused power-series term runs (None: the composed
        # kernels everywhere)
        self.e0_plan = plan_e0_fused(
            self.lm_shapes, None if w is None else w.cpu().numpy()
        ) if options.fused_power_term else None

    # ---- landmark "L space": per-landmark tables live in slot-ROW
    # order between a slot reduce and a slot expansion, so both
    # directions are reshape-sums / broadcasts with no index gathers

    def _seg_L(self, x: torch.Tensor) -> torch.Tensor:
        """[..., O] -> [..., L] per-landmark reduce into L space."""
        return slot_part_sums(x, self.lm_shapes)

    def _expand_L(self, s: torch.Tensor) -> torch.Tensor:
        """[..., L] -> per-observation [..., O]."""
        return slot_row_expand(s, self.lm_shapes)

    def _seg_lm_reexpand(self, u: torch.Tensor) -> torch.Tensor:
        """Per-landmark sum of u [..., O] re-expanded to observations
        [..., O] — the inner operation of every E0 matvec
        (right_mul_e0, linearization_power_varproj.hpp:364-453)."""
        return self._expand_L(self._seg_L(u))

    def _L_to_lm(self, s: torch.Tensor) -> torch.Tensor:
        """[..., L] -> canonical [..., M]."""
        return s.index_select(-1, self.obs.lm_inv)

    def _lm_to_L(self, s: torch.Tensor) -> torch.Tensor:
        """Canonical [..., M] -> [..., L]."""
        return s.index_select(-1, self.obs.lm_order)

    def lm_pack(self, lm_p):
        """Canonical [M, K] state -> LmState."""
        if isinstance(lm_p, LmState):
            return lm_p
        return LmState(rows=self._lm_to_L(lm_p.to(self.dtype).T))

    def lm_unpack(self, lm_p):
        """LmState -> canonical [M, K] state (identity otherwise)."""
        if not isinstance(lm_p, LmState):
            return lm_p
        return self._L_to_lm(lm_p.rows).T.contiguous()

    def _lm_rows(self, lm_p) -> torch.Tensor:
        """State rows [K, L] in the state dtype from either
        representation."""
        if isinstance(lm_p, LmState):
            return lm_p.rows
        return self._lm_to_L(lm_p.T)

    def _cam_table(self, cam_space: torch.Tensor, dtype) -> torch.Tensor:
        """cam_space [N, 3, 4] -> [12, N] table of vec(P) rows."""
        return cam_space.to(dtype).reshape(self.n_cams, 12).T.contiguous()

    # ---- the cost of an f32 LM state (`_compute_error` of the JAX
    # package off its double-float route), shared by both stages

    def _gather_cams(self, cam_space: torch.Tensor) -> torch.Tensor:
        """f32 cam_space [N, 3, 4] -> per-observation P [3, 4, O] through
        the cam_gather kernel (`_gather_cams` of the JAX package)."""
        table = self._cam_table(cam_space, torch.float32)
        return cam_kernels.cam_gather(table, self.obs.cam).reshape(3, 4, -1)

    def _mask_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Zero the slot pad rows of per-observation rows [k, O]."""
        if self.obs.weight is None:
            return x
        return torch.where(self.obs.weight > 0, x, torch.zeros_like(x))

    def _residual_info(self, err, res_sq, valid, finite):
        """The ResidualInfo dict of per-row robust costs `err`, squared
        residual norms `res_sq`, projection validity and finiteness [O],
        pad rows neither counted, valid nor non-finite."""
        if self.obs.weight is not None:
            active = self.obs.weight > 0
            err = torch.where(active, err, torch.zeros_like(err))
            valid = valid & active
            finite = finite | ~active
        return accumulate_residual_info(
            err, torch.sqrt(res_sq), valid, finite,
            num_obs_all=self.n_obs_live,
        )

    def _precond_closure(self, pmats):
        """The CG preconditioner's apply over its materials (`pmats`, as
        each stage's `_pcg_precond_s` makes them): IDENTITY (), JACOBI
        (inverse diagonal,) or SCHUR_JACOBI (Cholesky factors of the
        diagonal blocks,)."""
        pt = self.opts.preconditioner_type
        if pt == PreconditionerType.IDENTITY:
            return lambda v: v
        if pt == PreconditionerType.JACOBI:
            (invd,) = pmats
            return lambda v: invd * v
        (chol,) = pmats

        def precond(v):
            y = linalg.solve_lower_trif(chol, v)
            return linalg.solve_upper_from_lowerf(chol, y)

        return precond

    def _precond_mats(self, diag_blocks: torch.Tensor):
        """Preconditioner materials from the damped diagonal blocks
        [n, n, N] of the reduced camera system (already less their Schur
        corrections): JACOBI keeps 1 / diagonal (1 where it is 0),
        SCHUR_JACOBI the blocks' Cholesky factors."""
        if self.opts.preconditioner_type == PreconditionerType.JACOBI:
            dg = torch.diagonal(diag_blocks, dim1=0, dim2=1).T
            return (torch.where(dg != 0, 1.0 / dg, torch.ones_like(dg)),)
        return (linalg.cholesky_smallf(diag_blocks),)

    def _solve_scalar(self, lam) -> float:
        """lam rounded to the solve dtype, as a Python float."""
        return float(torch.tensor(float(lam), dtype=self.solve_dtype))

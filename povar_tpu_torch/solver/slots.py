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
device check, the configuration gate, the observation layout and the
per-observation constants every kernel call takes.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from povar_tpu_torch.options import RobustNorm, SolverOptions
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
    if not options.mixed_precision_solves:
        return (
            "mixed_precision_solves=False (ROADMAP.md queue 1 item 11, "
            "precision modes)"
        )
    if dtype != torch.float64:
        return (
            f"LM state dtype {dtype} (ROADMAP.md queue 1 item 11, "
            "precision modes: the f32 LM state)"
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

    def _solve_scalar(self, lam) -> float:
        """lam rounded to the solve dtype, as a Python float."""
        return float(torch.tensor(float(lam), dtype=self.solve_dtype))

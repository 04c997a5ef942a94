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
device check, the configuration gate, the solve dtype, the observation
layout, the per-observation constants every kernel call takes, the fused
power-term plan (`plan_e0_fused`), the CG preconditioner's apply, and
the camera- and landmark-side helpers of the unstructured layout (the
explicit-Jacobian `Lin1` / `Lin2` of `pallas_kernels="off"`, CHOLESKY
and pure f64): its per-camera sums and gathers run the camera-table
kernels (ops/cam_kernels.py, in the solve dtype: f32, or f64 in pure
f64) where the JAX package runs a one-hot incidence or padded segment
sums, and its per-landmark tables live in canonical landmark order, as
in the JAX package.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from povar_tpu_torch.ops import cam_kernels, linalg, pose_math
from povar_tpu_torch.options import (
    PreconditionerType,
    RobustNorm,
    SolverOptions,
)
from povar_tpu_torch.solver import pcg as pcg_mod
from povar_tpu_torch.solver.common import accumulate_residual_info
from povar_tpu_torch.solver.segments import (
    build_slot_plan,
    slot_expand,
    slot_part_sums,
    slot_row_expand,
    slot_segment_sum,
)

# the observation axis is padded with zero-weight rows to a multiple of
# this (povar_tpu/ops/pallas_cam.py OBS_PAD), so both packages see the
# same slot layout
OBS_PAD = 8192
# the TPU's in-VMEM one-hot limit (povar_tpu/ops/pallas_cam.py
# MAX_CAMERAS), past which the JAX package switches to camera windows.
# The port gathers by camera index and has no such limit, on one device
# or on a mesh; the constant names the JAX refusal below
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
    cam / lm: per-observation camera and landmark index [Op] (int32; a
    slot pad row carries the ids of the observation it copies, with
    weight 0); uv: measurements [2, Op]; weight: 0/1 mask [Op] over slot
    pads (None when there are none); lm_order/lm_inv: slot-row <->
    canonical landmark id maps (on the SPMD layout, parallel/spmd.py:
    slot row -> the rank's landmark, and lm_inv None)."""

    cam: torch.Tensor
    lm: torch.Tensor
    uv: torch.Tensor
    weight: Optional[torch.Tensor]
    lm_order: torch.Tensor
    lm_inv: Optional[torch.Tensor]
    # 1/0 over the landmark axis: real and fake landmarks of an SPMD
    # shard (parallel/spmd.py); None on one device
    lm_mask: Optional[torch.Tensor] = None


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
    padding have no counterpart: the card's kernel takes every part of
    width <= 16 at any N (csrc/pose_common.cuh launch_tiles), as the JAX
    package's geometry does at N <= MAX_CAMERAS."""
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
        lm=dev(obs_lm_np[perm].astype(np.int32)),
        uv=dev(obs_uv_np[:, perm], dtype),
        weight=None if w is None else dev(w, dtype),
        lm_order=dev(lm_order.astype(np.int64)),
        lm_inv=dev(inv_pos.astype(np.int64)),
    )
    return obs, shapes


def solve_dtype_of(options: SolverOptions, dtype):
    """The inner solves' and linearization storage's dtype for an LM state
    of `dtype` (JAX stage1.py:676-680): f32 under mixed-precision solves
    of an f64 state, else the state's own (an f32 state solves in f32
    whatever the option says; `mixed_precision_solves=False` with an f64
    state is pure f64)."""
    if options.mixed_precision_solves and dtype == torch.float64:
        return torch.float32
    return dtype


def common_unsupported(
    options: SolverOptions, n_cams: int, dtype
) -> Optional[str]:
    """Why this configuration is outside both ported stages, or None
    (the checks that do not depend on the step)."""
    if dtype not in (torch.float64, torch.float32):
        return f"LM state dtype {dtype} (the states are f64 and f32)"
    return None


def use_device_loop(options: SolverOptions, solver, detailed: bool) -> bool:
    """Whether `solver` runs its LM loop on the device
    (solver/device_loop.py): the rule of `_use_device_loop` in
    povar_tpu/solver/lm.py, word for word. The fused trial must exist
    (`supports_trial`: not CHOLESKY), the solver must take the device
    loop (`supports_device_loop`: not on a mesh) and per-stage timing
    must be off; "on" raises ValueError where one of them fails, "auto"
    takes the host loop there, "off" always."""
    mode = getattr(options, "device_lm_loop", "off")
    capable = (
        (not detailed)
        and getattr(solver, "supports_trial", False)
        and getattr(solver, "supports_device_loop", False)
    )
    if mode == "on" and not capable:
        raise ValueError(
            "device_lm_loop='on' requires the fused trial "
            "(supports_trial) and detailed_timing=False"
        )
    return mode in ("auto", "on") and capable


class SlotSolver:
    """Stage-solver base bound to one problem's observations on
    `device` ("cuda" launches the CUDA kernels; "cpu" runs their plain
    versions, as the tests do). Raises RuntimeError for "cuda" without a
    CUDA device and NotImplementedError, naming the ROADMAP.md item, for
    a configuration the port does not run yet (`unsupported` returns
    the reason or None); it never substitutes another path.

    The SPMD hooks of the JAX package's `CamWindows` (stage1.py:343-394,
    514-520) live here too: `_psum` and its scalar and cost-dict forms
    all-reduce over `mesh`, and `_lm_masked` / `_lm_masked_L` zero the
    per-landmark outputs of fake landmarks (Obs.lm_mask). On one device
    (`mesh` None, no mask) each is the identity; the SPMD solvers
    (parallel/spmd.py) set both."""

    # what the subclass runs, for the NotImplementedError message
    PATH = ""
    # the mesh the solve's sums are all-reduced over (parallel/mesh.Mesh)
    mesh = None
    # the LM loop may run on the device (use_device_loop); the SPMD
    # solvers say no (parallel/spmd.py), as the JAX package's
    supports_device_loop = True
    # the fused trial (solve + apply + cost) exists; Stage1Solver says
    # no for CHOLESKY, as the JAX package's
    supports_trial = True

    @staticmethod
    def uses_unstructured(options: SolverOptions, dtype) -> bool:
        """Whether the stage runs the unstructured layout (explicit
        Jacobians) under `options` with an LM state of `dtype`: with
        `pallas_kernels="off"`, as in the JAX package, whose "auto" also
        runs it off the TPU, and in pure f64, which the JAX package's
        kernels do not take (pallas_cam.supported needs f32 solves), so
        it runs the f64 XLA layout on one device whatever
        `pallas_kernels` says ("on" raises ValueError)."""
        return (options.pallas_kernels == "off"
                or solve_dtype_of(options, dtype) == torch.float64)

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
        why = self.unsupported(options, self.n_cams, dtype)
        if why is not None:
            raise NotImplementedError(
                f"povar_tpu_torch runs {self.PATH} only; not ported yet: "
                f"{why}"
            )
        self.opts = options
        self.dtype = dtype
        self.solve_dtype = solve_dtype_of(options, dtype)
        # the device LM loop last run on this solver (solver/lm.py: on
        # the card, its captured graph), by what it was captured for
        self.device_runs = {}
        if options.pallas_kernels == "on" and (
                self.solve_dtype == torch.float64):
            # the JAX package's refusal (stage1.py:705-710), word for word
            raise ValueError(
                "pallas_kernels='on' but the problem shape is unsupported "
                f"(n_cams={self.n_cams} <= {MAX_CAMERAS}, f32 inner solves "
                "required)"
            )
        self.unstructured = self.uses_unstructured(options, dtype)
        self.robust = ROBUST_CODE[options.residual.robust_norm]
        self.huber = float(options.residual.huber_parameter)
        self.power_m = int(options.power_sc_iterations)
        self.obs, self.lm_shapes = self._make_obs(obs_cam, obs_lm, obs_uv)
        # the Jacobi epsilon follows the solve dtype (stage1.py of the JAX
        # package): 1e-5 for f64 solves, sqrt(1e-5) for f32 ones
        self.jacobi_eps = options.effective_jacobi_scaling_epsilon(
            np.float32 if self.solve_dtype == torch.float32 else np.float64
        )
        o = int(self.obs.cam.shape[0])
        w = self.obs.weight
        # live-observation count for ResidualInfo (padding rows carry
        # zero weight and must not inflate num_obs / mean residuals)
        self.n_obs_live = o if w is None else int((w > 0).sum())
        # per-observation constants of every kernel call, made once: the
        # measurements in the solve dtype, and the live-row gate in f32
        # whatever the solve dtype (the kernels that take it, the f64
        # cost kernels among them, read it as f32)
        self._uv_s = self.obs.uv.to(self.solve_dtype)
        self._mask1 = (
            torch.ones((1, o), dtype=torch.float32, device=self.device)
            if w is None else (w > 0).to(torch.float32).reshape(1, -1)
        )
        # where the fused power-series term runs (None: the composed
        # kernels everywhere, or the unstructured layout)
        self.e0_plan = plan_e0_fused(
            self.lm_shapes, None if w is None else w.cpu().numpy()
        ) if (options.fused_power_term and not self.unstructured
              and self.lm_shapes is not None) else None

    def unsupported(self, options: SolverOptions, n_cams: int,
                    dtype) -> Optional[str]:
        """Why this solver does not run `options` yet, or None."""
        return common_unsupported(options, n_cams, dtype)

    def _make_obs(self, obs_cam, obs_lm, obs_uv) -> Tuple[Obs, tuple]:
        """(the observation layout on the solver's device, its slot
        shapes): the slot layout of `make_obs`."""
        return make_obs(obs_cam, obs_lm, obs_uv, self.n_cams, self.n_lms,
                        self.dtype, self.device)

    # ---- the SPMD hooks (identity on one device)

    def _psum(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the mesh (a per-camera accumulator or a scalar),
        the same on every rank."""
        if self.mesh is None:
            return x
        return self.mesh.all_reduce_(x.contiguous())

    def _psum_scalars(self, *xs: torch.Tensor):
        """Several 0-d tensors summed over the mesh in one all-reduce (as
        f64, exact for the counts and flags among them), each back in
        its dtype (a bool: whether any rank's was true)."""
        if self.mesh is None:
            return xs
        dev = xs[0].device
        tot = self._psum(torch.stack(
            [torch.as_tensor(x, device=dev).to(torch.float64) for x in xs]))
        return tuple(t.to(x.dtype) for t, x in zip(tot, xs))

    def _psum_err(self, d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A cost dict all-reduced over the mesh (`_psum_err` of the JAX
        package): the bucket sums and the valid count summed, the
        numerical validity an AND over the ranks; num_obs_all stays the
        static global live count."""
        if self.mesh is None:
            return d
        keys = ("error_all", "residual_sum_all", "num_obs_valid",
                "error_valid", "residual_sum_valid")
        *tot, bad = self._psum_scalars(
            *(d[k] for k in keys), ~d["is_numerically_valid"])
        return dict(d, **dict(zip(keys, tot)), is_numerically_valid=~bad)

    def _lm_masked(self, x: torch.Tensor) -> torch.Tensor:
        """Zero the fake landmarks' entries of per-landmark x [..., M]
        (their normal equations are singular, so their increments would
        come out NaN and must not touch the state)."""
        if self.obs.lm_mask is None:
            return x
        return torch.where(self.obs.lm_mask > 0, x, torch.zeros_like(x))

    def _lm_masked_L(self, x: torch.Tensor) -> torch.Tensor:
        """`_lm_masked` for L-space x [..., L]."""
        if self.obs.lm_mask is None:
            return x
        m = self._lm_to_L(self.obs.lm_mask) > 0
        return torch.where(m, x, torch.zeros_like(x))

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
        """Canonical [M, K] state -> LmState (identity on the
        unstructured layout, whose state stays canonical as in the JAX
        package)."""
        if isinstance(lm_p, LmState) or self.unstructured:
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

    # ---- the unstructured layout's camera side (`_seg_cam` /
    # `_gather_cam_x` of the JAX package, stage1.py:1169-1188): per-camera
    # sums and gathers of any leading shape through the camera-table
    # kernels, for operands in the solve dtype (f32, or f64 in pure f64)

    def _seg_cam(self, x: torch.Tensor) -> torch.Tensor:
        """[..., O] -> [..., N] per-camera sums (cam_scatter_add)."""
        flat = x.reshape(-1, x.shape[-1]).contiguous()
        out = cam_kernels.cam_scatter_add(flat, self.obs.cam, self.n_cams)
        return out.reshape(x.shape[:-1] + (self.n_cams,))

    def _gather_cam_x(self, x: torch.Tensor) -> torch.Tensor:
        """[..., N] camera table -> per-observation [..., O]
        (cam_gather)."""
        flat = x.reshape(-1, x.shape[-1]).contiguous()
        out = cam_kernels.cam_gather(flat, self.obs.cam)
        return out.reshape(x.shape[:-1] + (out.shape[-1],))

    def _e0_w_matvec(self, v: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
        """E0 v through the factorized operand W [dl, dc, O] (`_e0_w_matvec`
        of the JAX package): e0_u, the per-landmark reduce and re-expand
        over the slot layout, e0_scatter. v, result: [dc, N]."""
        w_flat = W.reshape(-1, W.shape[-1])
        u = cam_kernels.e0_u(w_flat, self.obs.cam, v.contiguous())
        sb = self._seg_lm_reexpand(u).contiguous()
        return cam_kernels.e0_scatter(w_flat, self.obs.cam, sb, self.n_cams)

    # ---- the unstructured layout's normal equations and solves, shared
    # by both stages (`Lin1` with Jp [4, 12, O], Jl [4, 3, O]; `Lin2` with
    # the tangent Jp_ns [2, 11, O], Jl_ns [2, 3, O]); pieces of
    # `_prep_hll` / `_prep_hpp_b` / `_e0_factor` / `_schur_diag` /
    # `_power_iterate` / `_pcg_iterate` of the JAX package
    # (stage1.py:1362-1607, stage2.py:592-822)

    def _weigh_u(self, r, Jp, Jl):
        """The sqrt robust weights applied to the residual and Jacobians
        [k, .., O] of a linearization."""
        _err, w = pose_math.robust_error_and_weight(
            (r * r).sum(dim=0), self.robust, self.huber
        )
        sw = torch.sqrt(w)
        return r * sw[None], Jp * sw[None, None], Jl * sw[None, None]

    def _lin_scale_jp(self, Jp):
        """Pose Jacobi column scaling 1 / (eps + col norm) from the
        per-camera Jp column norms (scale_Jp_cols_pOSE / _joint,
        landmark_block.hpp:324-350): one cam_scatter_add, one
        cam_gather. Returns (scaled Jp, pose_scale [12, N])."""
        pose_scale = 1.0 / (self.jacobi_eps + torch.sqrt(
            self._seg_cam((Jp * Jp).sum(dim=0))))
        return Jp * self._gather_cam_x(pose_scale)[None], pose_scale

    def _hll_u(self, jl: torch.Tensor) -> torch.Tensor:
        """Per-landmark Jl^T Jl [3, 3, M]."""
        return self._seg_lm(torch.einsum("kio,kjo->ijo", jl, jl))

    def _hll_inv_u(self, jl, r, lam_s):
        """(hll_inv [3, 3, M], hll_inv bl [3, M]) with the landmark blocks
        damped by lam_s I where it is given."""
        hll = self._hll_u(jl)
        if lam_s is not None:
            eye = torch.eye(3, dtype=hll.dtype, device=hll.device)
            hll = hll + lam_s * eye[:, :, None]
        hll_inv = linalg.inv3x3f(hll)
        bl = self._seg_lm(torch.einsum("kio,ko->io", jl, r))
        return hll_inv, mv(hll_inv, bl)

    def _hpp_b_u(self, jp, jl, r, hll_inv_bl):
        """(hpp [d, d, N] undamped, b [d, N]): the per-camera normal
        equations of the VarProj-corrected residual
        r~ = r - Jl hll_inv bl, one hpp_b launch."""
        r_tilde = r - torch.einsum("ijo,jo->io", jl,
                                   self._gather_lm_x(hll_inv_bl))
        k, d = jp.shape[:2]
        hpp, b = cam_kernels.hpp_b(jp.reshape(k * d, -1).contiguous(),
                                   r_tilde.contiguous(), self.obs.cam,
                                   self.n_cams)
        return hpp.reshape(d, d, self.n_cams), b

    def _e0_factor_u(self, jp, jl, hll_inv) -> torch.Tensor:
        """The factorized E0 operand W_o = L^T Jl_o^T Jp_o [3, d, O] with
        hll_inv = L L^T, so E0 = (scatter_cam W^T)(seg_lm W gather)."""
        a = torch.einsum("kio,kjo->ijo", jl, jp)  # [3, d, O]
        lg = self._gather_lm_x(linalg.cholesky_smallf(hll_inv))
        # contiguous once per solve: every power term or CG iteration
        # hands it to e0_u and e0_scatter
        return torch.einsum("kio,kjo->ijo", lg, a).contiguous()

    def _schur_corr_u(self, jp, jl, hll_inv) -> torch.Tensor:
        """The Schur corrections of the reduced camera system's diagonal
        blocks, sum over a camera's observations of W_o hll_inv W_o^T
        with W_o = Jp_o^T Jl_o [d, d, N] (a landmark observes a camera at
        most once, so the diagonal block couples an observation with
        itself only): one cam_scatter_add of d d rows."""
        w = torch.einsum("kio,kjo->ijo", jp, jl)  # [d, 3, O]
        wh = torch.einsum("ijo,jko->iko", w, self._gather_lm_x(hll_inv))
        return self._seg_cam(torch.einsum("iko,jko->ijo", wh, w))

    def _power_series(self, b_inv_apply, e0_apply, neg_b, ctl):
        """The power series over the solver's terms and tolerances: the
        host form, or with a control object `ctl` (the device LM loop)
        the device form. Returns (x, terms: an int, or a 0-d tensor with
        `ctl`)."""
        kw = dict(max_terms=self.power_m, q_tolerance=self.opts.eta,
                  r_tolerance=self.opts.r_tolerance)
        if ctl is None:
            return pcg_mod.power_series(b_inv_apply, e0_apply, neg_b, **kw)
        return pcg_mod.power_series_dev(b_inv_apply, e0_apply, neg_b,
                                        ctl=ctl, **kw)

    def _cg(self, matvec, b, precond, ctl):
        """CG from x0 = 0 with the solver's iteration limits and eta (the
        r-tolerance off, as in the JAX package): the host form, or with
        `ctl` the device form. Returns (x, iterations: an int, or a 0-d
        tensor with `ctl`)."""
        kw = dict(max_iterations=self.opts.max_linear_solver_iterations,
                  min_iterations=self.opts.min_linear_solver_iterations,
                  q_tolerance=self.opts.eta, r_tolerance=-1.0,
                  residual_reset_period=self.opts.residual_reset_period)
        if ctl is None:
            x, n_iter, _term = pcg_mod.conjugate_gradients(
                matvec, b, torch.zeros_like(b), precond, **kw)
            return x, n_iter
        return pcg_mod.conjugate_gradients_dev(
            matvec, b, torch.zeros_like(b), precond, ctl=ctl, **kw)

    def _power_prep_u(self, jp, jl, r, hll_inv, hll_inv_bl, lam_s):
        """The power series' operands (`_power_prep` of the JAX package,
        the `prepare` span): (-b, B^-1 with B = hpp + lam I, the
        factorized E0 operand W)."""
        hpp, b = self._hpp_b_u(jp, jl, r, hll_inv_bl)
        w = self._e0_factor_u(jp, jl, hll_inv)
        eye = torch.eye(hpp.shape[0], dtype=hpp.dtype, device=hpp.device)
        b_inv = linalg.inv_psd_smallf(hpp + lam_s * eye[:, :, None])
        return -b, b_inv, w

    def _power_iterate_u(self, prep, ctl=None):
        """The power series x = sum_i (B^-1 E0)^i B^-1 (-b) from
        `_power_prep_u`'s operands (the `solve_reduced_system` span).
        Returns (inc [d, N] in the state dtype, terms)."""
        neg_b, b_inv, w = prep
        inc, n_iter = self._power_series(
            lambda v: mv(b_inv, v), lambda v: self._e0_w_matvec(v, w), neg_b,
            ctl)
        return inc.to(self.dtype), n_iter

    def _pcg_prep_u(self, jp, jl, r, hll_inv, hll_inv_bl):
        """PCG's operands (`_pcg_prep` of the JAX package, the `prepare`
        span): (b, hpp undamped, the factorized E0 operand W)."""
        hpp, b = self._hpp_b_u(jp, jl, r, hll_inv_bl)
        return b, hpp, self._e0_factor_u(jp, jl, hll_inv)

    def _pcg_precond_u(self, jp, jl, hll_inv, hpp, lam_s):
        """The preconditioner's materials (`_pcg_precond` of the JAX
        package, the `compute_preconditioner` span) from the damped
        diagonal blocks less their Schur corrections; none for
        IDENTITY."""
        if self.opts.preconditioner_type == PreconditionerType.IDENTITY:
            return ()
        eye = torch.eye(hpp.shape[0], dtype=hpp.dtype, device=hpp.device)
        return self._precond_mats(hpp + lam_s * eye[:, :, None]
                                  - self._schur_corr_u(jp, jl, hll_inv))

    def _pcg_iterate_u(self, b, hpp, w, lam_s, pmats, ctl=None):
        """PCG on the implicit reduced camera system S x = b,
        S = hpp + lam I - E0 (the `solve_reduced_system` span). Returns
        (inc = -x [d, N] in the state dtype, CG iterations)."""

        def matvec(v):
            return mv(hpp, v) + lam_s * v - self._e0_w_matvec(v, w)

        x, n_iter = self._cg(matvec, b, self._precond_closure(pmats), ctl)
        return (-x).to(self.dtype), n_iter

    def _damped_lm_step_u(self, jp, jl, r, inc, lam_s):
        """The damped landmark step from the stored scaled blocks (the
        poBA / step-2 back-substitution, landmark_block.hpp:574-668):
        (jp inc [k, O], -(Hll + lam I)^-1 seg_lm(Jl^T (r + Jp inc))
        [3, M])."""
        eye = torch.eye(3, dtype=jl.dtype, device=jl.device)
        jp_inc = torch.einsum("ijo,jo->io", jp,
                              self._gather_cam_x(inc.to(self.solve_dtype)))
        inc_lm = -linalg.solve3x3f(
            self._hll_u(jl) + lam_s * eye[:, :, None],
            self._seg_lm(torch.einsum("kio,ko->io", jl, r + jp_inc)),
        )
        return jp_inc, inc_lm

    def _l_diff_u(self, j_inc, r) -> torch.Tensor:
        """The model cost decrease -sum(j_inc (0.5 j_inc + r)), summed in
        f64 as a 0-d tensor."""
        return -(j_inc * (0.5 * j_inc + r)).sum(dtype=torch.float64)

    def _lm_add_u(self, lm_p, inc: torch.Tensor):
        """The landmark state plus a canonical-order increment [K, M], in
        the state dtype and the state's representation."""
        inc = inc.to(self.dtype)
        if isinstance(lm_p, LmState):
            return LmState(rows=lm_p.rows + self._lm_to_L(inc))
        return lm_p + inc.T

    # ---- the unstructured layout's landmark side, in canonical order

    def _seg_lm(self, x: torch.Tensor) -> torch.Tensor:
        """[..., O] -> [..., M] per-landmark sums."""
        return slot_segment_sum(x, self.lm_shapes, self.obs.lm_inv)

    def _gather_lm_x(self, s: torch.Tensor) -> torch.Tensor:
        """[..., M] -> per-observation [..., O]."""
        return slot_expand(s, self.lm_shapes, self.obs.lm_order)

    # ---- the cost of an f32 LM state (`_compute_error` of the JAX
    # package off its double-float route), shared by both stages

    def _gather_cams(self, cam_space: torch.Tensor,
                     dtype=None) -> torch.Tensor:
        """cam_space [N, 3, 4] -> per-observation P [3, 4, O] in `dtype`
        (default the solve dtype) through the cam_gather kernel
        (`_gather_cams` of the JAX package)."""
        table = self._cam_table(cam_space, dtype or self.solve_dtype)
        return cam_kernels.cam_gather(table, self.obs.cam).reshape(3, 4, -1)

    def _gather_cams_state(self, cam_space: torch.Tensor) -> torch.Tensor:
        """cam_space [N, 3, 4] -> per-observation P [3, 4, O] in the state
        dtype, through cam_gather (f32 or f64, a copy bit for bit)."""
        return self._gather_cams(cam_space, self.dtype)

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
        return self._psum_err(accumulate_residual_info(
            err, torch.sqrt(res_sq), valid, finite,
            num_obs_all=self.n_obs_live,
        ))

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

    def _solve_scalar(self, lam):
        """lam rounded to the solve dtype: a Python float for a number
        (the host loop), a 0-d tensor for a 0-d tensor (the device loop,
        whose lambda never leaves the device)."""
        if isinstance(lam, torch.Tensor):
            return lam.to(self.solve_dtype)
        return float(torch.tensor(float(lam), dtype=self.solve_dtype))

"""Step-2 Riemannian projective refinement: RIPOBA on the structured path.

The counterpart of povar_tpu/solver/stage2.py on its structured path
(`Lin2S`, composed power term): the homogeneous Jacobians are never
materialized; every per-observation pass is one of the six kernels of
ops/pose2_kernels.py (hand-written CUDA on the card, their plain
PyTorch versions on the CPU), and the landmark side is reshape-sums and
broadcasts over the slot layout. This module replaces:
  - linearize_landmark_projective_space_homogeneous + linearize_nullspace
    (sc/landmark_block.hpp:180-269)
  - prepare_Hb_joint / solve_joint / right_mul_*_joint
    (sc/linearization_power_varproj.hpp:74-122, 240-287, 341-453)
  - back_substitute_joint (sc/landmark_block.hpp:574-623)
  - apply_joint camera lift (solver/linearizor_power_varproj.cpp:276-308)

Geometry: cameras live on the quotient of 12-dof matrices by global
scale, landmarks on the quotient of homogeneous 4-vectors by scale.
Tangent spaces are the nullspaces of the current representative (11
dimensions for a camera, 3 for a landmark), with the JAX package's
Householder bases (ops/linalg.nullspace_of_rowf). The camera lift folds
per camera into Kps = pose_scale . kernel_cam [12, 11, N], applied
around the kernels, which work in the unprojected 12-dof frame.

Layouts as in stage1.py: per-observation rows [k, O], camera tables
[12, N], per-landmark tables in L space [.., L]. The LM state (cameras
[N, 3, 4], homogeneous landmarks) and the cost are f64; linearization
storage and the inner solve are f32. Retraction after each step:
Frobenius-normalize the cameras and dehomogenize the landmarks
(bal_bundle_adjustment.cpp:700-705).

What this slice covers is the default step-2 configuration of the JAX
package with `fused_power_term=False`: any other step-2 configuration
raises NotImplementedError naming its ROADMAP.md item.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from povar_tpu_torch.ops import linalg, pose2_kernels
from povar_tpu_torch.options import SolverOptions, SolverTypeRiemannian
from povar_tpu_torch.solver import pcg as pcg_mod
from povar_tpu_torch.solver.slots import (
    LmState,
    SlotSolver,
    common_unsupported,
)


class Lin2S(NamedTuple):
    """Structured step-2 linearization point (all f32): the compact
    per-observation projection state instead of the Jp/Jl storage (the
    Jacobians re-derive in registers from (mm, x4); the tangent lifts
    fold per camera into kps). Landmark-axis fields live in L space."""

    ct: torch.Tensor  # [12, N] normalized camera table
    x4: torch.Tensor  # [4, O] homogeneous landmarks expanded
    mm: torch.Tensor  # [3, O] (mx, my, 1/p2) projection cache
    sw: torch.Tensor  # [1, O] sqrt robust weight (0 on dead rows)
    r_w: torch.Tensor  # [2, O] sqrt-weighted residuals
    jls8: torch.Tensor  # [8, O] weighted SCALED Jl rows (r*4+c)
    jlns: torch.Tensor  # [6, O] tangent-projected Jl_ns rows (r*3+i)
    hll_raw: torch.Tensor  # [3, 3, L] undamped tangent Hll slot sums
    bl_raw: torch.Tensor  # [3, L] tangent gradient slot sums
    jl_scale: torch.Tensor  # [4, L]
    pose_scale: torch.Tensor  # [12, N]
    kernel_cam: torch.Tensor  # [12, 11, N]
    kernel_lm: torch.Tensor  # [4, 3, L]
    kps: torch.Tensor  # [12, 11, N] = pose_scale . kernel_cam


def create_homogeneous(
    cam_space: torch.Tensor, lm_p: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step boundary (create_homogeneous_landmark,
    bal_bundle_adjustment.cpp:544-553): lift landmarks [M, 3] to
    homogeneous coordinates [M, 4] and Frobenius-normalize the cameras."""
    lm_p_h = torch.cat([lm_p, torch.ones_like(lm_p[..., :1])], dim=-1)
    return linalg.frobenius_normalize(cam_space), lm_p_h


def _unsupported(options: SolverOptions, n_cams: int, dtype) -> Optional[str]:
    """Why this configuration is outside the ported slice, or None."""
    if options.solver_type_step_2 != SolverTypeRiemannian.RIPOBA:
        return (
            f"solver_type_step_2={options.solver_type_step_2.value} "
            "(ROADMAP.md queue 1 item 9, the other solvers: RIPCG)"
        )
    if options.fused_power_term:
        return (
            "fused_power_term=True (ROADMAP.md queue 2, e0_term2_parts: "
            "the fused step-2 power-series term kernel)"
        )
    return common_unsupported(options, n_cams, dtype)


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batch-last matrix-vector product 'ijn,jn->in'."""
    return (m * v[None]).sum(dim=1)


class Stage2Solver(SlotSolver):
    """Step-2 (RIPOBA) solver bound to one problem's observations on
    `device` ("cuda", the default, launches the CUDA kernels; "cpu" runs
    their plain versions).

    Public API as in the JAX package: compute_error, linearize,
    solve_power, apply, trial, lm_pack, lm_unpack. Landmark state may be
    passed canonical ([M, 4] homogeneous) or packed (LmState)."""

    PATH = "step 2 on the structured RIPOBA path"

    def __init__(
        self,
        obs_cam,
        obs_lm,
        obs_uv,
        num_cameras: int,
        num_landmarks: int,
        options: SolverOptions,
        dtype=torch.float64,
        device="cuda",
    ):
        super().__init__(
            obs_cam, obs_lm, obs_uv, num_cameras, num_landmarks, options,
            dtype, device, _unsupported,
        )
        self.use_valid_only = options.use_projection_validity_check()

    def trial(self, cam_space, lm_p_h, lin: Lin2S, lam):
        """One LM backtracking trial: solve + apply + f64 cost, with no
        host synchronisation except the power series' early-exit test.
        Returns (new_cams, new_lms, inc_finite, num_inner_iters, l_diff,
        err_dict), as Stage1Solver.trial."""
        inc, n_iter = self.solve_power(lin, lam)
        inc_finite = torch.isfinite(inc).all()
        new_cams, new_lms, l_diff = self.apply(cam_space, lm_p_h, lin, inc,
                                               lam)
        err = self.compute_error(new_cams, new_lms)
        return new_cams, new_lms, inc_finite, n_iter, l_diff, err

    # ------------------------------------------------------------- error

    def compute_error(self, cam_space, lm_p_h) -> Dict[str, torch.Tensor]:
        """compute_error_projective_space_homogeneous (helper.cpp:
        156-196) in native f64 (the pose_error2 kernel, where the JAX
        package evaluates double-float on the TPU,
        stage2._compute_error_df32): the all and valid buckets, the
        valid count and the non-finite flag."""
        ct = self._cam_table(cam_space, self.dtype)
        x4 = self._expand_L(self._lm_rows(lm_p_h).to(self.dtype))
        return pose2_kernels.pose_error2(
            self.obs.cam, ct, x4, self.obs.uv, self._mask1,
            robust=self.robust, huber=self.huber,
        )

    # --------------------------------------------------------- linearize

    def linearize(self, cam_space, lm_p_h) -> Lin2S:
        """Homogeneous linearization, Jacobi scaling and tangent-space
        projection (`_linearize_s` of the JAX package): one `prepare2`
        pass, the landmark slot sums, the scales, the tangent bases and
        the projected landmark storage."""
        sd = self.solve_dtype
        ct = self._cam_table(cam_space, sd)
        x4_L = self._lm_rows(lm_p_h).to(sd)  # [4, L]
        x4 = self._expand_L(x4_L)  # [4, O]
        rw, sw, mm, jlw, jlsq, jpsq = pose2_kernels.prepare2(
            self.obs.cam, ct, x4, self._uv_s, self._mask1,
            use_valid=self.use_valid_only, robust=self.robust,
            huber=self.huber,
        )
        jl_scale = 1.0 / (self.jacobi_eps + torch.sqrt(self._seg_L(jlsq)))
        pose_scale = 1.0 / (self.jacobi_eps + torch.sqrt(jpsq))
        return self._lin2_tangent_s(ct, x4_L, x4, rw, sw, mm, jlw, jl_scale,
                                    pose_scale)

    def _lin2_tangent_s(self, ct, x4_L, x4, rw, sw, mm, jlw, jl_scale,
                        pose_scale) -> Lin2S:
        """Tangent bases, projected storage and the tangent Hll / bl slot
        sums (the reference's QR/COD analogue)."""
        kernel_cam = linalg.nullspace_of_rowf(ct)  # [12, 11, N]
        kernel_lm = linalg.nullspace_of_rowf(x4_L)  # [4, 3, L]

        jls_e = self._expand_L(jl_scale)  # [4, O]
        jls8 = jlw * torch.cat([jls_e, jls_e], dim=0)
        klm_e = self._expand_L(
            kernel_lm.reshape(12, kernel_lm.shape[-1])
        )  # [12, O], rows c*3+i
        jlns_rows = []
        for r in range(2):
            for i in range(3):
                acc = jls8[r * 4] * klm_e[i]
                for c in range(1, 4):
                    acc = acc + jls8[r * 4 + c] * klm_e[c * 3 + i]
                jlns_rows.append(acc)
        jlns = torch.stack(jlns_rows)  # [6, O], rows r*3+i

        prods = torch.stack([
            jlns[i] * jlns[j] + jlns[3 + i] * jlns[3 + j]
            for i in range(3) for j in range(3)
        ])
        hll_raw = self._seg_L(prods).reshape(3, 3, -1)
        blp = torch.stack([
            jlns[i] * rw[0] + jlns[3 + i] * rw[1] for i in range(3)
        ])
        bl_raw = self._seg_L(blp)
        kps = pose_scale[:, None, :] * kernel_cam
        return Lin2S(
            ct=ct, x4=x4, mm=mm, sw=sw, r_w=rw, jls8=jls8, jlns=jlns,
            hll_raw=hll_raw, bl_raw=bl_raw, jl_scale=jl_scale,
            pose_scale=pose_scale, kernel_cam=kernel_cam,
            kernel_lm=kernel_lm, kps=kps,
        )

    # ------------------------------------------------------------ solve

    def _damped_hll(self, lin: Lin2S, lam_s: float) -> torch.Tensor:
        """Tangent Hll + lam I (the bases are orthonormal, so the
        reference's Proj^T lam Proj damping is lam I)."""
        eye = torch.eye(3, dtype=lin.hll_raw.dtype, device=lin.hll_raw.device)
        return lin.hll_raw + lam_s * eye[:, :, None]

    def _prep_hll_s(self, lin: Lin2S, lam_s: float):
        """(hll_inv [3,3,L], hib_obs [3,O], b6 [6,O] = Jl_ns L rows) of
        the damped tangent landmark blocks."""
        hll_inv = linalg.inv3x3f(self._damped_hll(lin, lam_s))
        hib = _mv(hll_inv, lin.bl_raw)
        lchol = linalg.cholesky_smallf(hll_inv)  # [3, 3, L]
        hib_obs = self._expand_L(hib)
        l_obs = self._expand_L(lchol.reshape(9, lchol.shape[-1]))  # i*3+c
        b6_rows = []
        for r in range(2):
            for c in range(3):
                acc = lin.jlns[r * 3] * l_obs[c]
                for i in range(1, 3):
                    acc = acc + lin.jlns[r * 3 + i] * l_obs[i * 3 + c]
                b6_rows.append(acc)
        return hll_inv, hib_obs, torch.stack(b6_rows)

    def _fold_kps(self, lin: Lin2S, m12, b12):
        """Per-camera tangent folds: [144, N] -> Kps^T . M . Kps
        [11, 11, N] and [12, N] -> Kps^T . b [11, N]."""
        kps = lin.kps
        h11 = None
        if m12 is not None:
            hpp = m12.reshape(12, 12, self.n_cams)
            tmp = (kps[:, :, None, :] * hpp[:, None, :, :]).sum(dim=0)
            h11 = (tmp[:, :, None, :] * kps[None]).sum(dim=1)
        b11 = None
        if b12 is not None:
            b11 = (kps * b12[:, None, :]).sum(dim=0)
        return h11, b11

    def solve_power(self, lin: Lin2S, lam) -> Tuple[torch.Tensor, int]:
        """RIPOBA: power series on the 11-dof tangent system
        (solve_joint, hpp:240-287). Returns (inc [11, N] in the state
        dtype, num_terms)."""
        lam_s = self._solve_scalar(lam)
        _hll_inv, hib_obs, b6 = self._prep_hll_s(lin, lam_s)
        hpp12, b12 = pose2_kernels.hppb2(
            self.obs.cam, lin.x4, lin.mm, lin.sw, lin.r_w, lin.jlns,
            hib_obs, self.n_cams,
        )
        hpp11, b11 = self._fold_kps(lin, hpp12, b12)
        eye = torch.eye(11, dtype=hpp11.dtype, device=hpp11.device)
        b_inv = linalg.inv_psd_smallf(hpp11 + lam_s * eye[:, :, None])
        inc, n_iter = pcg_mod.power_series(
            lambda v: _mv(b_inv, v),
            self._e0_apply_s(lin, b6),
            -b11,
            max_terms=self.power_m,
            q_tolerance=self.opts.eta,
            r_tolerance=self.opts.r_tolerance,
        )
        return inc.to(self.dtype), n_iter

    def _e0_apply_s(self, lin: Lin2S, b6: torch.Tensor):
        """Matrix-free tangent E0 (right_mul_e0_joint, hpp:409-453): the
        composed mat_dot2 -> slot reduce / re-expand -> scatter2 term
        through the zt = Kps v table (stage2.py:1171-1183 of the JAX
        package)."""
        cam = self.obs.cam

        def e0(v11):
            zt = _mv(lin.kps, v11)  # [12, N]
            u3 = pose2_kernels.mat_dot2(
                cam, lin.x4, lin.mm, lin.sw, b6, None, zt, add_r=False
            )
            sb = self._seg_lm_reexpand(u3)
            out12 = pose2_kernels.scatter2(
                cam, lin.x4, lin.mm, lin.sw, b6, sb, self.n_cams
            )
            return self._fold_kps(lin, None, out12)[1]

        return e0

    # ------------------------------------------------------------- apply

    def apply(self, cam_space, lm_p_h, lin: Lin2S, inc, lam):
        """back_substitute_joint + apply_joint + retraction
        (landmark_block.hpp:574-623, linearizor_power_varproj.cpp:
        276-308, bal_bundle_adjustment.cpp:700-705). Returns
        (new_cam_space, new_lm_p_h, l_diff)."""
        new_lm, l_diff = self._back_sub_s(lm_p_h, lin, inc, lam)
        return self._update_cams(cam_space, lin, inc), new_lm, l_diff

    def _back_sub_s(self, lm_p_h, lin: Lin2S, inc, lam):
        """Damped tangent landmark back-substitution, the lift 3 -> 4,
        the model cost decrease and the dehomogenizing landmark update.
        Returns (new_lm_p_h, l_diff) with l_diff a 0-d f64 tensor."""
        sd = self.solve_dtype
        lam_s = self._solve_scalar(lam)
        zt = _mv(lin.kps, inc.to(sd))  # [12, N]
        cam = self.obs.cam
        t3_obs = pose2_kernels.mat_dot2(
            cam, lin.x4, lin.mm, lin.sw, lin.jlns, lin.r_w, zt, add_r=True
        )
        inc3 = -linalg.solve3x3f(self._damped_hll(lin, lam_s),
                                 self._seg_L(t3_obs))  # [3, L]
        inc_proj = _mv(lin.kernel_lm, inc3)  # [4, L]
        neg_l_diff = pose2_kernels.ldiff2(
            cam, lin.x4, lin.mm, lin.sw, lin.r_w, lin.jls8,
            self._expand_L(inc_proj), zt,
        )
        inc4 = (inc_proj * lin.jl_scale).to(self.dtype)
        if isinstance(lm_p_h, LmState):
            rows = lm_p_h.rows + inc4
            # dehomogenize per row (the pad row divides by its copy's w:
            # finite, and only dead observations see it)
            return LmState(rows=rows / rows[3:4, :]), -neg_l_diff
        new_lm_h = lm_p_h + self._L_to_lm(inc4).T
        return new_lm_h / new_lm_h[:, 3:4], -neg_l_diff

    def _update_cams(self, cam_space, lin: Lin2S, inc):
        """Camera tangent lift 11 -> 12 through kernel_cam, unscale, add,
        Frobenius-normalize retraction (apply_joint,
        linearizor_power_varproj.cpp:276-308)."""
        inc12 = _mv(lin.kernel_cam, inc.to(self.solve_dtype))  # [12, N]
        inc12 = (inc12 * lin.pose_scale).to(self.dtype)
        new_cam = cam_space + inc12.T.reshape(self.n_cams, 3, 4)
        return linalg.frobenius_normalize(new_cam)

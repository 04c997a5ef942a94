"""Step-2 Riemannian projective refinement: RIPOBA and RIPCG.

The counterpart of povar_tpu/solver/stage2.py on both of its layouts.
The structured one (`Lin2S`, the default): the homogeneous Jacobians
are never materialized; every per-observation pass is one of the eight
kernels of ops/pose2_kernels.py (hand-written CUDA on the card, their
plain PyTorch versions on the CPU), and the landmark side is
reshape-sums and broadcasts over the slot layout. The unstructured one
(`Lin2`, with `pallas_kernels="off"`): explicit weighted, scaled and
tangent-projected Jacobians (ops/pose_math.py), per-camera sums and
gathers through the camera-table kernels of ops/cam_kernels.py, and
per-landmark tables in canonical landmark order; pure f64 on one device
runs it too, as in the JAX package (on a mesh pure f64 runs the
structured layout through the kernels' f64 instantiations). This module
replaces:
  - linearize_landmark_projective_space_homogeneous + linearize_nullspace
    (sc/landmark_block.hpp:180-269)
  - prepare_Hb_joint / solve_joint / right_mul_*_joint
    (sc/linearization_power_varproj.hpp:74-122, 240-287, 341-453)
  - back_substitute_joint (sc/landmark_block.hpp:574-623)
  - the implicit tangent RCS + PCG of RIPCG (solver/linearizor_sc.cpp:
    245-325)
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
[N, 3, 4], homogeneous landmarks) and the cost are f64 by default, or
f32 (`dtype=torch.float32`); linearization storage and the inner solve
are f32 (`solve_dtype`), or f64 in pure f64 (`mixed_precision_solves=
False` with an f64 state: the unstructured layout on one device, the
structured one on a mesh). Retraction after
each step:
Frobenius-normalize the cameras and dehomogenize the landmarks
(bal_bundle_adjustment.cpp:700-705).

Both step-2 solvers run on both layouts, the structured one with the
fused power term (the JAX package's default) or the composed one
(`fused_power_term=False`), and in pure f64 on the unstructured one on
one device and the structured one on a mesh; any other step-2
configuration raises
NotImplementedError naming its ROADMAP.md item.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from povar_tpu_torch.ops import linalg, pose2_kernels, pose_math
from povar_tpu_torch.options import (
    PreconditionerType,
    SolverOptions,
    SolverTypeRiemannian,
)
from povar_tpu_torch.solver.common import fused, timed_spans
from povar_tpu_torch.solver.segments import slot_part_sums, slot_row_expand
from povar_tpu_torch.solver.slots import LmState, SlotSolver, mv


class Lin2(NamedTuple):
    """Unstructured step-2 linearization point (all in the solve dtype,
    f32 or f64): the scaled
    storage, its tangent projections and the tangent bases. Landmark-
    axis fields are in canonical landmark order."""

    Jp: torch.Tensor  # [2, 12, O] scaled
    Jl: torch.Tensor  # [2, 4, O] scaled
    r: torch.Tensor  # [2, O] sqrt-weighted residuals
    Jp_ns: torch.Tensor  # [2, 11, O]
    Jl_ns: torch.Tensor  # [2, 3, O]
    kernel_cam: torch.Tensor  # [12, 11, N]
    kernel_lm: torch.Tensor  # [4, 3, M]
    pose_scale: torch.Tensor  # [12, N]
    jl_scale: torch.Tensor  # [4, M]


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


class Stage2Solver(SlotSolver):
    """Step-2 (RIPOBA or RIPCG) solver bound to one problem's
    observations on `device` ("cuda", the default, launches the CUDA
    kernels; "cpu" runs their plain versions).

    Public API as in the JAX package: compute_error, linearize,
    solve_power, solve_pcg, solve, apply, trial, lm_pack, lm_unpack,
    dispatching on the layout of `lin`, and the staged API of
    `detailed_timing`, linearize_timed, solve_timed and apply_timed: the
    same pieces, each timed (solver/common.py). Landmark state may be
    passed canonical ([M, 4] homogeneous) or packed (LmState); the
    unstructured layout keeps it canonical."""

    PATH = "step 2 (RIPOBA, RIPCG) on the structured and unstructured layouts"

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
            dtype, device,
        )
        self.use_valid_only = options.use_projection_validity_check()

    def solve(self, lin, lam, ctl=None, span=fused
              ) -> Tuple[torch.Tensor, int]:
        """Dispatch on solver_type_step_2: (inc [11, N] in the state
        dtype, power terms or CG iterations; with `ctl`, as
        Stage1Solver.solve, a 0-d tensor count). `span` runs each piece
        (solver/common.py)."""
        if self.opts.solver_type_step_2 == SolverTypeRiemannian.RIPCG:
            return self.solve_pcg(lin, lam, ctl, span)
        return self.solve_power(lin, lam, ctl, span)

    def trial(self, cam_space, lm_p_h, lin, lam, ctl=None):
        """One LM backtracking trial: solve + apply + cost, with no host
        synchronisation except the inner solve's early-exit tests (none
        with `ctl` and a 0-d tensor `lam`, the device LM loop's).
        Returns (new_cams, new_lms, inc_finite, num_inner_iters, l_diff,
        err_dict), as Stage1Solver.trial."""
        inc, n_iter = self.solve(lin, lam, ctl)
        inc_finite = torch.isfinite(inc).all()
        new_cams, new_lms, l_diff = self.apply(cam_space, lm_p_h, lin, inc,
                                               lam)
        err = self.compute_error(new_cams, new_lms)
        return new_cams, new_lms, inc_finite, n_iter, l_diff, err

    # ----------------------------------------------- staged (timed) API
    # (as Stage1Solver's; the JAX package's stage2.py:298-395)

    def linearize_timed(self, cam_space, lm_p_h):
        """Returns (lin, timings): jacobian_evaluation,
        scale_landmark_jacobian, scale_pose_jacobian, perform_qr (the
        tangent nullspace projection, the reference's QR/COD
        analogue)."""
        t = {}
        return self.linearize(cam_space, lm_p_h,
                              timed_spans(self.device, t)), t

    def solve_timed(self, lin, lam):
        """`solve` with per-stage times: returns (inc, lin_iters,
        timings): stage2 (the tangent Hll and its damping), landmark_
        damping (equal to stage2: the joint Hll damping is inside it),
        prepare, compute_preconditioner (RIPCG), solve_reduced_system."""
        t = {}
        inc, n_iter = self.solve(lin, lam, span=timed_spans(self.device, t))
        t["landmark_damping"] = t["stage2"]
        return inc, n_iter, t

    def apply_timed(self, cam_space, lm_p_h, lin, inc, lam):
        """`apply` with its back_substitution and update_cameras wall
        times: (new_cam_space, new_lm_p_h, l_diff, timings)."""
        t = {}
        out = self.apply(cam_space, lm_p_h, lin, inc, lam,
                         timed_spans(self.device, t))
        return (*out, t)

    # ------------------------------------------------------------- error

    def compute_error(self, cam_space, lm_p_h) -> Dict[str, torch.Tensor]:
        """compute_error_projective_space_homogeneous (helper.cpp:
        156-196): the all and valid buckets, the valid count and the
        non-finite flag. An f64 state is evaluated in native f64 (the
        pose_error2 kernel, where the JAX package evaluates double-float
        on the TPU, stage2._compute_error_df32); an f32 state in f32 from
        the cameras the cam_gather kernel gathers, as the JAX package's
        `_compute_error` (stage2.py:477-494), with the f32 validity
        threshold (pose_math.sophus_eps_sqrt)."""
        if self.dtype == torch.float32:
            P = self._gather_cams(cam_space)
            xh = self._expand_L(self._lm_rows(lm_p_h))  # [4, O]
            r, valid = pose_math.homogeneous_residual_t(P, xh, self.obs.uv)
            r = self._mask_rows(r)
            res_sq = (r * r).sum(dim=0)
            err, _w = pose_math.robust_error_and_weight(
                res_sq, self.robust, self.huber
            )
            return self._residual_info(err, res_sq, valid,
                                       torch.isfinite(r).all(dim=0))
        ct = self._cam_table(cam_space, self.dtype)
        x4 = self._expand_L(self._lm_rows(lm_p_h).to(self.dtype))
        d = pose2_kernels.pose_error2(
            self.obs.cam, ct, x4, self.obs.uv, self._mask1,
            robust=self.robust, huber=self.huber,
        )
        # the static global live count, as the JAX package's
        # stage2._compute_error_df32
        d["num_obs_all"] = self.n_obs_live
        return self._psum_err(d)

    # --------------------------------------------------------- linearize

    def linearize(self, cam_space, lm_p_h, span=fused):
        """Homogeneous linearization, Jacobi scaling and tangent-space
        projection. Structured (`_linearize_s` of the JAX package): one
        `prepare2` pass, the landmark slot sums, the scales, the tangent
        bases and the projected landmark storage; unstructured
        (`_linearize`, in the reference's order: weight, scale Jl, scale
        Jp, then project the scaled blocks, landmark_block.hpp:227-269).
        Spans: jacobian_evaluation, scale_landmark_jacobian,
        scale_pose_jacobian, perform_qr."""
        if self.unstructured:
            r, Jp, Jl = span("jacobian_evaluation", self._lin_core,
                             cam_space, lm_p_h)
            Jl, jl_scale = span("scale_landmark_jacobian",
                                self._lin_scale_jl, Jl)
            Jp, pose_scale = span("scale_pose_jacobian", self._lin_scale_jp,
                                  Jp)
            return span("perform_qr", self._lin_nullspace, cam_space, lm_p_h,
                        Jp, Jl, r, pose_scale, jl_scale)
        core = span("jacobian_evaluation", self._lin_core_s, cam_space,
                    lm_p_h)
        jl_scale = span("scale_landmark_jacobian", self._jacobi_scale,
                        core[-2])
        pose_scale = span("scale_pose_jacobian", self._jacobi_scale,
                          core[-1])
        return span("perform_qr", self._lin2_tangent_s, *core[:-2],
                    jl_scale, pose_scale)

    def _lin_core_s(self, cam_space, lm_p_h):
        """The structured projection / residual / weight pass and the raw
        column-norm sums (`_lin2_core_s` of the JAX package): (ct, x4_L,
        x4, rw, sw, mm, jlw, jl_sq [4, L], jpsq [12, N])."""
        sd = self.solve_dtype
        ct = self._cam_table(cam_space, sd)
        x4_L = self._lm_rows(lm_p_h).to(sd)  # [4, L]
        x4 = self._expand_L(x4_L)  # [4, O]
        rw, sw, mm, jlw, jlsq, jpsq = pose2_kernels.prepare2(
            self.obs.cam, ct, x4, self._uv_s, self._mask1,
            use_valid=self.use_valid_only, robust=self.robust,
            huber=self.huber,
        )
        return (ct, x4_L, x4, rw, sw, mm, jlw, self._seg_L(jlsq),
                self._psum(jpsq))

    def _jacobi_scale(self, col_sq):
        """The Jacobi column scale 1 / (eps + col norm) from squared
        column norms (scale_Jl_cols_homogeneous / scale_Jp_cols_joint)."""
        return 1.0 / (self.jacobi_eps + torch.sqrt(col_sq))

    def _lin_core(self, cam_space, lm_p_h):
        """The homogeneous residual and Jacobians, pad rows zeroed,
        invalid projections zeroed where the validity check is on
        (landmark_block.hpp:203-222), with sqrt robust weights applied."""
        xh = self._expand_L(self._lm_rows(lm_p_h).to(self.solve_dtype))
        r, Jp, Jl, valid = pose_math.homogeneous_jacobians_t(
            self._gather_cams(cam_space), xh, self._uv_s
        )
        r, Jp, Jl = (self._mask_rows(t) for t in (r, Jp, Jl))
        if self.use_valid_only:
            r, Jp, Jl = (torch.where(valid, t, torch.zeros_like(t))
                         for t in (r, Jp, Jl))
        return self._weigh_u(r, Jp, Jl)

    def _lin_scale_jl(self, Jl):
        """scale_Jl_cols_homogeneous (landmark_block.hpp:302-318)."""
        jl_scale = 1.0 / (self.jacobi_eps
                          + torch.sqrt(self._seg_lm((Jl * Jl).sum(dim=0))))
        return Jl * self._gather_lm_x(jl_scale)[None], jl_scale

    def _lin_nullspace(self, cam_space, lm_p_h, Jp, Jl, r, pose_scale,
                       jl_scale) -> Lin2:
        """Tangent-space projection of the scaled blocks
        (linearize_nullspace, landmark_block.hpp:227-269): the Householder
        bases, and Jp_ns = Jp kernel_cam with kernel_cam [12, 11, N]
        gathered per observation by cam_gather (132 rows)."""
        sd = self.solve_dtype
        kernel_cam = linalg.nullspace_of_rowf(
            self._cam_table(cam_space, sd)
        )  # [12, 11, N]
        kernel_lm = linalg.nullspace_of_rowf(
            self._L_to_lm(self._lm_rows(lm_p_h)).to(sd)
        )  # [4, 3, M]
        Jp_ns = torch.einsum("ijo,jko->iko", Jp,
                             self._gather_cam_x(kernel_cam))
        Jl_ns = torch.einsum("ijo,jko->iko", Jl,
                             self._gather_lm_x(kernel_lm))
        return Lin2(Jp=Jp, Jl=Jl, r=r, Jp_ns=Jp_ns, Jl_ns=Jl_ns,
                    kernel_cam=kernel_cam, kernel_lm=kernel_lm,
                    pose_scale=pose_scale, jl_scale=jl_scale)

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

    def _damped_hll(self, lin: Lin2S, lam_s) -> torch.Tensor:
        """Tangent Hll + lam I (the bases are orthonormal, so the
        reference's Proj^T lam Proj damping is lam I)."""
        eye = torch.eye(3, dtype=lin.hll_raw.dtype, device=lin.hll_raw.device)
        return lin.hll_raw + lam_s * eye[:, :, None]

    def _prep_hll_s(self, lin: Lin2S, lam_s):
        """(hll_inv [3,3,L], hib_obs [3,O], b6 [6,O] = Jl_ns L rows) of
        the damped tangent landmark blocks."""
        hll_inv = linalg.inv3x3f(self._damped_hll(lin, lam_s))
        hib = mv(hll_inv, lin.bl_raw)
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

    def _hpp_b11(self, lin: Lin2S, hib_obs):
        """(hpp11 [11, 11, N] undamped, b11 [11, N]): the per-camera
        normal equations in the unprojected frame, folded by Kps."""
        hpp12, b12 = pose2_kernels.hppb2(
            self.obs.cam, lin.x4, lin.mm, lin.sw, lin.r_w, lin.jlns,
            hib_obs, self.n_cams,
        )
        return self._fold_kps(lin, self._psum(hpp12), self._psum(b12))

    def solve_power(self, lin, lam, ctl=None, span=fused
                    ) -> Tuple[torch.Tensor, int]:
        """RIPOBA: power series on the 11-dof tangent system
        (solve_joint, hpp:240-287). Spans: stage2, prepare,
        solve_reduced_system. Returns (inc [11, N] in the state dtype,
        num_terms)."""
        lam_s = self._solve_scalar(lam)
        if isinstance(lin, Lin2):
            hll_inv, hll_inv_bl = span("stage2", self._hll_inv_u, lin.Jl_ns,
                                       lin.r, lam_s)
            prep = span("prepare", self._power_prep_u, lin.Jp_ns, lin.Jl_ns,
                        lin.r, hll_inv, hll_inv_bl, lam_s)
            return span("solve_reduced_system", self._power_iterate_u, prep,
                        ctl)
        pieces = span("stage2", self._prep_hll_s, lin, lam_s)
        prep = span("prepare", self._power_prep_s, lin, lam_s, pieces)
        return span("solve_reduced_system", self._power_iterate_s, lin, prep,
                    ctl)

    def _power_prep_s(self, lin: Lin2S, lam_s, pieces):
        """(-b11, (Hpp11 + lam I)^-1, b6) of the structured power solve."""
        _hll_inv, hib_obs, b6 = pieces
        hpp11, b11 = self._hpp_b11(lin, hib_obs)
        eye = torch.eye(11, dtype=hpp11.dtype, device=hpp11.device)
        b_inv = linalg.inv_psd_smallf(hpp11 + lam_s * eye[:, :, None])
        return -b11, b_inv, b6

    def _power_iterate_s(self, lin: Lin2S, prep, ctl=None):
        """The structured power series from `_power_prep_s`'s operands."""
        neg_b11, b_inv, b6 = prep
        inc, n_iter = self._power_series(
            lambda v: mv(b_inv, v), self._e0_apply_s(lin, b6), neg_b11, ctl)
        return inc.to(self.dtype), n_iter

    def solve_pcg(self, lin, lam, ctl=None, span=fused
                  ) -> Tuple[torch.Tensor, int]:
        """RIPCG (linearizor_sc.cpp:245-325; `_solve_pcg` of the JAX
        package): PCG on the implicit tangent reduced camera system
        S x = b11, S = Hpp11 + lam I - E0, preconditioned per
        options.preconditioner_type. Spans: stage2, prepare,
        compute_preconditioner, solve_reduced_system. Returns (inc = -x
        [11, N] in the state dtype, CG iterations)."""
        lam_s = self._solve_scalar(lam)
        if isinstance(lin, Lin2):
            hll_inv, hll_inv_bl = span("stage2", self._hll_inv_u, lin.Jl_ns,
                                       lin.r, lam_s)
            b, hpp, w = span("prepare", self._pcg_prep_u, lin.Jp_ns,
                             lin.Jl_ns, lin.r, hll_inv, hll_inv_bl)
            pmats = span("compute_preconditioner", self._pcg_precond_u,
                         lin.Jp_ns, lin.Jl_ns, hll_inv, hpp, lam_s)
            return span("solve_reduced_system", self._pcg_iterate_u, b, hpp,
                        w, lam_s, pmats, ctl)
        _hll_inv, hib_obs, b6 = span("stage2", self._prep_hll_s, lin, lam_s)
        hpp11, b11 = span("prepare", self._hpp_b11, lin, hib_obs)
        pmats = span("compute_preconditioner", self._pcg_precond_s, lin,
                     lam_s, hpp11, b6)
        return span("solve_reduced_system", self._pcg_iterate_s, lin, lam_s,
                    b11, hpp11, b6, pmats, ctl)

    def _pcg_iterate_s(self, lin: Lin2S, lam_s, b11, hpp11, b6, pmats,
                       ctl=None):
        """The structured tangent CG iterations. Returns (inc = -x
        [11, N] in the state dtype, CG iterations)."""
        precond = self._precond_closure(pmats)
        e0 = self._e0_apply_s(lin, b6)

        def matvec(v):
            return mv(hpp11, v) + lam_s * v - e0(v)

        x, n_iter = self._cg(matvec, b11, precond, ctl)
        return (-x).to(self.dtype), n_iter

    def _pcg_precond_s(self, lin: Lin2S, lam_s, hpp11, b6):
        """Preconditioner materials (`_pcg_precond` of the JAX package,
        structured branch): the damped Hpp11 blocks less the folded
        schur_diag2 corrections; none for IDENTITY."""
        if self.opts.preconditioner_type == PreconditionerType.IDENTITY:
            return ()
        corr12 = self._psum(pose2_kernels.schur_diag2(
            self.obs.cam, lin.x4, lin.mm, lin.sw, b6, self.n_cams
        ))
        corr11, _ = self._fold_kps(lin, corr12, None)
        eye = torch.eye(11, dtype=hpp11.dtype, device=hpp11.device)
        return self._precond_mats(hpp11 + lam_s * eye[:, :, None] - corr11)

    def _e0_apply_s(self, lin: Lin2S, b6: torch.Tensor):
        """Matrix-free tangent E0 (right_mul_e0_joint, hpp:409-453)
        through the zt = Kps v table (stage2.py:1148-1185 of the JAX
        package): the fused term over the plan's narrow parts (one
        e0_term2_parts launch) plus the composed terms on its wide
        suffix, or, without a plan, the composed mat_dot2 -> slot
        reduce / re-expand -> scatter2 term."""
        cam = self.obs.cam
        plan = self.e0_plan

        if plan is not None:
            suffix = self._e0_suffix_s(lin, b6)

            def e0_fused(v11):
                zt = mv(lin.kps, v11)  # [12, N]
                out12 = pose2_kernels.e0_term2_parts(
                    cam, lin.x4, lin.mm, lin.sw, b6, zt, plan.parts,
                    self.n_cams,
                )
                if suffix is not None:
                    out12 = out12 + suffix(zt)
                return self._fold_kps(lin, None, self._psum(out12))[1]

            return e0_fused

        def e0(v11):
            zt = mv(lin.kps, v11)  # [12, N]
            u3 = pose2_kernels.mat_dot2(
                cam, lin.x4, lin.mm, lin.sw, b6, None, zt, add_r=False
            )
            sb = self._seg_lm_reexpand(u3)
            out12 = pose2_kernels.scatter2(
                cam, lin.x4, lin.mm, lin.sw, b6, sb, self.n_cams
            )
            return self._fold_kps(lin, None, self._psum(out12))[1]

        return e0

    def _e0_suffix_s(self, lin: Lin2S, b6: torch.Tensor):
        """The composed tangent E0 term on the plan's wide suffix
        [cut, O) (`_e0_suffix_apply2` of the JAX package) as a function
        of zt, or None without a suffix; its operands are sliced once
        per solve."""
        if self.e0_plan.suffix is None:
            return None
        cut, shapes = self.e0_plan.suffix
        cam_s = self.obs.cam[cut:]
        x4_s, mm_s, sw_s, b6_s = (
            t[:, cut:].contiguous() for t in (lin.x4, lin.mm, lin.sw, b6)
        )

        def apply(zt):
            u3 = pose2_kernels.mat_dot2(cam_s, x4_s, mm_s, sw_s, b6_s, None,
                                        zt, add_r=False)
            sb = slot_row_expand(slot_part_sums(u3, shapes), shapes)
            return pose2_kernels.scatter2(cam_s, x4_s, mm_s, sw_s, b6_s, sb,
                                          self.n_cams)

        return apply

    # ------------------------------------------------------------- apply

    def apply(self, cam_space, lm_p_h, lin, inc, lam, span=fused):
        """back_substitute_joint + apply_joint + retraction
        (landmark_block.hpp:574-623, linearizor_power_varproj.cpp:
        276-308, bal_bundle_adjustment.cpp:700-705). Spans:
        back_substitution, update_cameras. Returns (new_cam_space,
        new_lm_p_h, l_diff)."""
        back_sub = (self._back_sub if isinstance(lin, Lin2)
                    else self._back_sub_s)
        new_lm, l_diff = span("back_substitution", back_sub, lm_p_h, lin,
                              inc, lam)
        new_cam = span("update_cameras", self._update_cams, cam_space, lin,
                       inc)
        return new_cam, new_lm, l_diff

    def _back_sub(self, lm_p_h, lin: Lin2, inc, lam):
        """The unstructured damped tangent landmark step (`_back_sub` of
        the JAX package): from the stored blocks, lifted 3 -> 4 through
        kernel_lm, l_diff from the scaled Jl, then unscaled, added and
        dehomogenized. Returns (new_lm_p_h, l_diff)."""
        jp_inc, inc3 = self._damped_lm_step_u(
            lin.Jp_ns, lin.Jl_ns, lin.r, inc, self._solve_scalar(lam)
        )  # inc3 [3, M]
        inc_proj = mv(lin.kernel_lm, inc3)  # [4, M]
        j_inc = jp_inc + torch.einsum("ijo,jo->io", lin.Jl,
                                      self._gather_lm_x(inc_proj))
        new_lm = self._lm_add_u(lm_p_h, inc_proj * lin.jl_scale)
        if isinstance(new_lm, LmState):
            rows = new_lm.rows
            new_lm = LmState(rows=rows / rows[3:4, :])
        else:
            new_lm = new_lm / new_lm[:, 3:4]
        return new_lm, self._l_diff_u(j_inc, lin.r)

    def _back_sub_s(self, lm_p_h, lin: Lin2S, inc, lam):
        """Damped tangent landmark back-substitution, the lift 3 -> 4,
        the model cost decrease and the dehomogenizing landmark update.
        Returns (new_lm_p_h, l_diff) with l_diff a 0-d f64 tensor."""
        sd = self.solve_dtype
        lam_s = self._solve_scalar(lam)
        zt = mv(lin.kps, inc.to(sd))  # [12, N]
        cam = self.obs.cam
        t3_obs = pose2_kernels.mat_dot2(
            cam, lin.x4, lin.mm, lin.sw, lin.jlns, lin.r_w, zt, add_r=True
        )
        inc3 = -linalg.solve3x3f(self._damped_hll(lin, lam_s),
                                 self._seg_L(t3_obs))  # [3, L]
        inc_proj = mv(lin.kernel_lm, inc3)  # [4, L]
        neg_l_diff = pose2_kernels.ldiff2(
            cam, lin.x4, lin.mm, lin.sw, lin.r_w, lin.jls8,
            self._expand_L(inc_proj), zt,
        )
        neg_l_diff = self._psum(neg_l_diff)
        inc4 = (inc_proj * lin.jl_scale).to(self.dtype)
        if isinstance(lm_p_h, LmState):
            rows = lm_p_h.rows + inc4
            # dehomogenize per row (the pad row divides by its copy's w:
            # finite, and only dead observations see it)
            return LmState(rows=rows / rows[3:4, :]), -neg_l_diff
        new_lm_h = lm_p_h + self._L_to_lm(inc4).T
        return new_lm_h / new_lm_h[:, 3:4], -neg_l_diff

    def _update_cams(self, cam_space, lin, inc):
        """Camera tangent lift 11 -> 12 through kernel_cam, unscale, add,
        Frobenius-normalize retraction (apply_joint,
        linearizor_power_varproj.cpp:276-308)."""
        inc12 = mv(lin.kernel_cam, inc.to(self.solve_dtype))  # [12, N]
        inc12 = (inc12 * lin.pose_scale).to(self.dtype)
        new_cam = cam_space + inc12.T.reshape(self.n_cams, 3, 4)
        return linalg.frobenius_normalize(new_cam)

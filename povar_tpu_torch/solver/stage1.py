"""Step-1 pOSE VarProj linearization and the POWER_VARPROJ,
POWER_SCHUR_COMPLEMENT, PCG and CHOLESKY solves.

The counterpart of povar_tpu/solver/stage1.py on both of its layouts.
The structured one (`Lin1S`, the default): the pOSE Jacobians are never
materialized; every per-observation pass is one of the eleven kernels
of ops/pose_kernels.py (hand-written CUDA on the card, their plain
PyTorch versions on the CPU), and the landmark side is reshape-sums and
broadcasts over the slot layout (solver/segments.py). The unstructured
one (`Lin1`, with `pallas_kernels="off"`, and always for CHOLESKY and in
pure f64, as in the JAX package): explicit, weighted and Jacobi-scaled
Jacobians
Jp [4, 12, O] and Jl [4, 3, O] (ops/pose_math.py), per-camera sums and
gathers through the camera-table kernels of ops/cam_kernels.py, and
per-landmark tables in canonical landmark order. This module replaces:
  - LandmarkBlockSC pOSE storage + ops      (sc/landmark_block.hpp:58-760)
  - LinearizationPowerVarproj               (sc/linearization_power_varproj.hpp)
  - LinearizorPowerVarproj                  (solver/linearizor_power_varproj.cpp)
  - LinearizorSC's implicit PCG             (solver/linearizor_sc.cpp)
  - the dense direct solve of CHOLESKY      (sc/linearization_sc.hpp:236-245)

Layouts are the JAX package's, observation LAST: per-observation rows
[k, O], camera tables [12, N], per-landmark tables [.., L] in "L space"
(slot-row order), per-camera / per-landmark blocks batch-last
([12, 12, N], [3, 3, L]). The LM state (cameras [N, 3, 4], landmarks)
and the cost are f64 by default, or f32 (`dtype=torch.float32`, whose
cost gathers the cameras with the cam_gather kernel); linearization
storage and the inner solve are f32 (`solve_dtype`), except in pure f64
(`mixed_precision_solves=False` with an f64 state), which runs the
unstructured layout with f64 storage, solves and camera-table kernels,
and CHOLESKY's dense system in f64.

The ported configurations are the JAX package's defaults (POWER_VARPROJ
with the fused power term, or the composed one with
`fused_power_term=False`), POWER_SCHUR_COMPLEMENT (landmark damping and
the poBA apply), PCG with its three preconditioners, and CHOLESKY (the
dense reduced camera system, up to DENSE_CHOL_MAX = 1536 cameras), at
any camera count otherwise, on either layout where
the JAX package has it, in mixed precision or pure f64 on one device;
any other step-1 configuration raises
NotImplementedError naming its ROADMAP.md item instead of running
another path.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from povar_tpu_torch.ops import linalg, pose_kernels, pose_math
from povar_tpu_torch.options import (
    PreconditionerType,
    SolverOptions,
    SolverType,
)
from povar_tpu_torch.solver.segments import slot_part_sums, slot_row_expand
from povar_tpu_torch.solver.slots import (
    LmState, SlotSolver, mv, solve_dtype_of,
)

# largest camera count of the dense CHOLESKY solve (povar_tpu/solver/
# stage1.py DENSE_CHOL_MAX); past it the JAX package factors a banded
# system (povar_tpu/solver/band_chol.py), which the port has not yet
DENSE_CHOL_MAX = 1536
BANDED_CHOL = ("ROADMAP.md queue 1 item 12's remainder: the banded "
               "CHOLESKY, povar_tpu/solver/band_chol.py")


def dense_chol_bytes(n_cams: int, n_lms: int, dtype) -> int:
    """Bytes the dense CHOLESKY route holds at once (solve_cholesky): A
    [12N, 3M] (144 N M bytes in f32, 288 N M in f64) beside S [12N,
    12N]."""
    elem = torch.empty((), dtype=dtype).element_size()
    return elem * 12 * n_cams * (3 * n_lms + 12 * n_cams)


def dense_chol_unsupported(n_cams: int, n_lms: int, dtype,
                           capacity: Optional[int]) -> Optional[str]:
    """Why the dense CHOLESKY route cannot run N cameras and M landmarks
    in `dtype` on a device of `capacity` bytes (None: no limit, the
    host), or None."""
    if n_cams > DENSE_CHOL_MAX:
        return (f"CHOLESKY with {n_cams} cameras > {DENSE_CHOL_MAX} "
                f"({BANDED_CHOL})")
    need = dense_chol_bytes(n_cams, n_lms, dtype)
    if capacity is not None and need > capacity:
        return (f"CHOLESKY's dense system at {n_cams} cameras and {n_lms} "
                f"landmarks: A and S take {need / 1e9:.1f} GB in {dtype}, "
                f"past the device's {capacity / 1e9:.1f} GB ({BANDED_CHOL})")
    return None


class Lin1(NamedTuple):
    """Unstructured step-1 linearization point (all in the solve dtype,
    f32 or f64): the weighted
    storage after both Jacobi scalings. Landmark-axis fields are in
    canonical landmark order."""

    Jp: torch.Tensor  # [4, 12, O] scaled
    Jl: torch.Tensor  # [4, 3, O] scaled
    r: torch.Tensor  # [4, O] sqrt-weighted residuals
    pose_scale: torch.Tensor  # [12, N]
    jl_scale: torch.Tensor  # [3, M]


class Lin1S(NamedTuple):
    """Structured step-1 linearization point (all f32). hll_raw/bl_raw
    are the UNSCALED landmark normal-equation slot sums (w A~^T A~,
    w A~^T r); the Jacobi scales apply as outer products on [.., L] /
    [.., N] tables, never per observation."""

    ct: torch.Tensor  # [12, N] camera table (vec(P) rows) at lin point
    x: torch.Tensor  # [3, O] landmarks expanded to observations
    r_w: torch.Tensor  # [4, O] sqrt-weighted residuals
    sw: torch.Tensor  # [1, O] sqrt robust weight (0 on dead rows)
    hll_raw: torch.Tensor  # [3, 3, L]
    bl_raw: torch.Tensor  # [3, L]
    jl_scale: torch.Tensor  # [3, L]
    pose_scale: torch.Tensor  # [12, N]


class Stage1Solver(SlotSolver):
    """Step-1 solver bound to one problem's observations on `device`
    ("cuda", the default, launches the CUDA kernels; "cpu" runs their
    plain versions).

    Public API as in the JAX package: compute_error, initialize_varproj,
    linearize, solve_power, solve_pcg, solve_cholesky, solve, apply,
    apply_poba, trial, lm_pack, lm_unpack (there each is a jitted entry
    over a private method of the same name; here the public methods are
    the implementations, dispatching on the layout of `lin`). Landmark
    state may be passed canonical ([M, 3]) or packed (LmState); the
    unstructured layout keeps it canonical."""

    PATH = ("step 1 (POWER_VARPROJ, POWER_SCHUR_COMPLEMENT, PCG, CHOLESKY) "
            "on the structured and unstructured layouts")

    @staticmethod
    def uses_unstructured(options: SolverOptions, dtype) -> bool:
        """`pallas_kernels="off"`, pure f64 (SlotSolver.uses_unstructured),
        or CHOLESKY whatever `pallas_kernels` says: the dense direct solve
        needs the explicit per-observation blocks (JAX stage1.py:713-717)."""
        return (SlotSolver.uses_unstructured(options, dtype)
                or options.solver_type_step_1 == SolverType.CHOLESKY)

    def unsupported(self, options: SolverOptions, n_cams: int,
                    dtype) -> Optional[str]:
        # SlotSolver.__init__ has set n_lms and device before this call
        if options.solver_type_step_1 == SolverType.CHOLESKY:
            why = dense_chol_unsupported(
                n_cams, self.n_lms, solve_dtype_of(options, dtype),
                torch.cuda.get_device_properties(self.device).total_memory
                if self.device.type == "cuda" else None)
            if why is not None:
                return why
        return super().unsupported(options, n_cams, dtype)

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
        self.alpha = float(options.alpha)
        # reference quirk (stage1.py:664-674 of the JAX package): only
        # the power linearizor scales the Jl columns
        # (linearizor_power_varproj.cpp:64), for POWER_VARPROJ and
        # POWER_SCHUR_COMPLEMENT alike; PCG keeps them unscaled. The
        # solve is scale-invariant, but the back-substitution's
        # model-cost term is not, so the lambda schedule depends on it.
        self.poba = (
            options.solver_type_step_1 == SolverType.POWER_SCHUR_COMPLEMENT
        )
        self.scale_jl = options.solver_type_step_1 in (
            SolverType.POWER_VARPROJ, SolverType.POWER_SCHUR_COMPLEMENT,
        )

    @property
    def supports_trial(self) -> bool:
        """Whether the JAX package fuses this solver's trial, and so runs
        its LM loop on the device (`use_device_loop`): POWER_VARPROJ,
        POWER_SCHUR_COMPLEMENT and PCG; CHOLESKY stays on the host loop
        (povar_tpu/solver/stage1.py `supports_trial`). The port's
        `trial` runs every solver."""
        return self.opts.solver_type_step_1 != SolverType.CHOLESKY

    def solve(self, lin, lam, ctl=None) -> Tuple[torch.Tensor, int]:
        """Dispatch on solver_type_step_1 (linearizor.cpp:46-61
        factory): (inc [12, N] in scaled coordinates, state dtype;
        power terms, CG iterations, or 0 for the direct solve).
        POWER_SCHUR_COMPLEMENT is the power series with the landmark
        blocks damped. With a control object `ctl` (the device LM loop,
        a 0-d tensor `lam`) the inner loops run their device forms and
        the count is a 0-d tensor."""
        st = self.opts.solver_type_step_1
        if st == SolverType.PCG:
            return self.solve_pcg(lin, lam, ctl)
        if st == SolverType.CHOLESKY:
            return self.solve_cholesky(lin, lam)
        return self.solve_power(lin, lam, landmark_damping=self.poba,
                                ctl=ctl)

    def trial(self, cam_space, lm_p, lin, lam, ctl=None):
        """One LM backtracking trial: solve + apply + cost, with no host
        synchronisation except the inner solve's early-exit tests (none
        with `ctl`, the device LM loop's control object, and a 0-d tensor
        `lam`). POWER_SCHUR_COMPLEMENT applies through the poBA
        back-substitution with the trial's lambda (`apply_poba`), the
        others through the VarProj one (`apply`). CHOLESKY runs here too
        under the host loop: the JAX package stages it only for its jit
        boundaries, with the same decisions.

        Returns (new_cams, new_lms, inc_finite, num_inner_iters,
        l_diff, err_dict); inc_finite, l_diff and the err_dict entries
        stay on the device for the caller's one batched transfer. When
        the increment is non-finite the caller discards the trial state
        (the reference's NaN check, cpp:362-401)."""
        inc, n_iter = self.solve(lin, lam, ctl)
        inc_finite = torch.isfinite(inc).all()
        if self.poba:
            new_cams, new_lms, l_diff = self.apply_poba(
                cam_space, lm_p, lin, inc, lam
            )
        else:
            new_cams, new_lms, l_diff = self.apply(cam_space, lm_p, lin, inc)
        err = self.compute_error(new_cams, new_lms)
        return new_cams, new_lms, inc_finite, n_iter, l_diff, err

    def _hll_guard_L(self, hll: torch.Tensor) -> torch.Tensor:
        """Identity-guard the [3, 3, L] normal matrices of slot pad rows
        (their sums are exactly zero): inverting them would poison
        per-observation expansions with NaN (0 * NaN = NaN survives the
        sw=0 dead-row mask); their zero-rhs solves yield zero."""
        dg = hll[0, 0] + hll[1, 1] + hll[2, 2]
        f = (dg == 0).to(hll.dtype)
        eye = torch.eye(3, dtype=hll.dtype, device=hll.device)
        return hll + f * eye[:, :, None]

    # ------------------------------------------------------ error / init

    def compute_error(self, cam_space, lm_p) -> Dict[str, torch.Tensor]:
        """compute_error_pOSE (helper.cpp:116-154). An f64 state is
        evaluated in native f64 (the pose_error kernel, where the JAX
        package evaluates double-float on the TPU,
        stage1._compute_error_df32); an f32 state in f32 from the cameras
        the cam_gather kernel gathers, as the JAX package's
        `_compute_error` (stage1.py:1240-1259). pOSE projections are
        always valid (helper.cpp:263), so the valid bucket equals the
        live bucket."""
        if self.dtype == torch.float32:
            P = self._gather_cams(cam_space)
            x = self._expand_L(self._lm_rows(lm_p))  # [3, O]
            r = self._mask_rows(
                pose_math.pose_residual_t(P, x, self.obs.uv, self.alpha)
            )
            res_sq = (r * r).sum(dim=0)
            err, _w = pose_math.robust_error_and_weight(
                res_sq, self.robust, self.huber
            )
            return self._residual_info(
                err, res_sq, torch.ones_like(res_sq, dtype=torch.bool),
                torch.isfinite(r).all(dim=0),
            )
        ct = self._cam_table(cam_space, self.dtype)
        x = self._expand_L(self._lm_rows(lm_p).to(self.dtype))
        err, rn, bad = self._psum_scalars(*pose_kernels.pose_error(
            self.obs.cam, ct, x, self.obs.uv, self._mask1,
            alpha=self.alpha, robust=self.robust, huber=self.huber,
        ))
        return {
            "num_obs_all": self.n_obs_live,
            "error_all": err,
            "residual_sum_all": rn,
            "num_obs_valid": self.n_obs_live,
            "error_valid": err,
            "residual_sum_valid": rn,
            "is_numerically_valid": bad == 0,
        }

    def initialize_varproj(self, cam_space) -> torch.Tensor:
        """Closed-form VarProj landmark init v*(u0) = (G^T G)^-1 G^T z
        (helper.cpp:75-99 via normal equations). At x = 0 the pOSE
        residual is r = -z and A~[:, :3] = G, so one unweighted
        `prepare` pass with zero landmarks yields G^T G = ata and
        G^T z = -atr exactly. Returns lm_p [M, 3] in the state dtype.

        The unstructured layout solves the per-landmark normal equations
        in the state dtype from cameras gathered in it, as the JAX
        package's (stage1.py:1289-1293)."""
        if self.unstructured:
            P = self._gather_cams_state(cam_space)
            gtg, gtz = pose_math.varproj_init_normal_eq_t(
                P, self.obs.uv, self.alpha
            )
            return linalg.solve3x3f(
                self._seg_lm(self._mask_rows(gtg)),
                self._seg_lm(self._mask_rows(gtz)),
            ).T.contiguous()
        sd = self.solve_dtype
        ct = self._cam_table(cam_space, sd)
        zeros = torch.zeros(
            (3, self.obs.cam.shape[0]), dtype=sd, device=self.device
        )
        _rw, _sw, ata, atr, _jpsq = pose_kernels.prepare(
            self.obs.cam, ct, zeros, self._uv_s, self._mask1,
            alpha=self.alpha, robust=0, huber=1.0, weighted=False,
            sums=False,
        )
        gtg = self._hll_guard_L(self._seg_L(ata).reshape(3, 3, -1))
        gtz = -self._seg_L(atr)
        lm0 = self._lm_masked(self._L_to_lm(linalg.solve3x3f(gtg, gtz)))
        return lm0.T.to(self.dtype).contiguous()

    # -------------------------------------------------------- linearize

    def linearize(self, cam_space, lm_p):
        """Stage-1 linearization (linearizor_power_varproj.cpp:44-76).
        Structured (`_linearize_s` of the JAX package): one `prepare`
        pass, the landmark slot sums, and the Jacobi scales; unstructured
        (`_linearize`): the weighted Jacobians, scaled per landmark and
        per camera."""
        if self.unstructured:
            r, Jp, Jl = self._lin_core(cam_space, lm_p)
            Jl, jl_scale = self._lin_scale_jl(Jl)
            Jp, pose_scale = self._lin_scale_jp(Jp)
            return Lin1(Jp=Jp, Jl=Jl, r=r, pose_scale=pose_scale,
                        jl_scale=jl_scale)
        ct, x, r_w, sw, hll_raw, bl_raw, jpsq = self._lin_core_s(
            cam_space, lm_p
        )
        return Lin1S(
            ct=ct, x=x, r_w=r_w, sw=sw, hll_raw=hll_raw, bl_raw=bl_raw,
            jl_scale=self._lin_scale_jl_s(hll_raw),
            pose_scale=self._lin_scale_jp_s(jpsq),
        )

    def _lin_core(self, cam_space, lm_p):
        """The pOSE residual and Jacobians at the linearization point,
        pad rows zeroed, with sqrt robust weights applied."""
        x = self._expand_L(self._lm_rows(lm_p).to(self.solve_dtype))
        return self._weigh_u(*(
            self._mask_rows(t) for t in pose_math.pose_jacobians_t(
                self._gather_cams(cam_space), x, self._uv_s, self.alpha)))

    def _lin_scale_jl(self, Jl):
        """Landmark Jacobi column scaling 1 / (eps + col norm)
        (scale_Jl_cols_pOSE); ones where the solver keeps Jl unscaled."""
        jl_sq = self._seg_lm((Jl * Jl).sum(dim=0))  # [3, M]
        if not self.scale_jl:
            return Jl, torch.ones_like(jl_sq)
        jl_scale = 1.0 / (self.jacobi_eps + torch.sqrt(jl_sq))
        return Jl * self._gather_lm_x(jl_scale)[None], jl_scale

    def _lin_core_s(self, cam_space, lm_p):
        sd = self.solve_dtype
        ct = self._cam_table(cam_space, sd)
        x = self._expand_L(self._lm_rows(lm_p).to(sd))  # [3, O]
        r_w, sw, ata, atr, jpsq = pose_kernels.prepare(
            self.obs.cam, ct, x, self._uv_s, self._mask1,
            alpha=self.alpha, robust=self.robust, huber=self.huber,
        )
        hll_raw = self._seg_L(ata).reshape(3, 3, -1)
        bl_raw = self._seg_L(atr)
        return ct, x, r_w, sw, hll_raw, bl_raw, self._psum(jpsq)

    def _lin_scale_jl_s(self, hll_raw: torch.Tensor) -> torch.Tensor:
        """Landmark Jacobi scale 1 / (eps + col norm) from the raw Hll
        diagonal (scale_Jl_cols_pOSE, landmark_block.hpp:284-300); ones
        where the solver keeps Jl unscaled (PCG, see `scale_jl`)."""
        jl_sq = torch.stack([hll_raw[i, i] for i in range(3)])  # [3, L]
        if not self.scale_jl:
            return torch.ones_like(jl_sq)
        return 1.0 / (self.jacobi_eps + torch.sqrt(jl_sq))

    def _lin_scale_jp_s(self, jpsq: torch.Tensor) -> torch.Tensor:
        """Pose Jacobi scale from the per-camera Jp column norms
        (scale_Jp_cols_pOSE, landmark_block.hpp:324-334)."""
        return 1.0 / (self.jacobi_eps + torch.sqrt(jpsq))

    # ------------------------------------------------------------ solve

    def _scaled_hll(self, lin: Lin1S, lam_s=None):
        """The landmark blocks [3, 3, L] in the Jl-scaled coordinates,
        damped by lam_s I where given (poBA, set_landmark_damping,
        linearizor_power_varproj.cpp:199-201)."""
        d = lin.jl_scale
        hll = lin.hll_raw * (d[:, None, :] * d[None, :, :])
        if lam_s is not None:
            eye = torch.eye(3, dtype=hll.dtype, device=hll.device)
            hll = hll + lam_s * eye[:, :, None]
        return hll

    def _hll_pieces_s(self, lin: Lin1S, lam_s=None):
        """(hll_inv [3,3,L], hib_obs [3,O], jls_obs [3,O], lh_obs [9,O])
        from the raw slot sums: scale, damp by lam_s I where given
        (POWER_SCHUR_COMPLEMENT's landmark damping, before the pad-row
        guard as in the JAX package), invert, factor."""
        d = lin.jl_scale
        hll = self._scaled_hll(lin, lam_s)
        hll_inv = linalg.inv3x3f(self._hll_guard_L(hll))
        bl = d * lin.bl_raw
        hib = (hll_inv * bl[None]).sum(dim=1)  # [3, L]
        lh = linalg.cholesky_smallf(hll_inv)  # [3, 3, L] lower
        jls_obs = self._expand_L(d)
        hib_obs = self._expand_L(hib)
        lh_obs = self._expand_L(lh.reshape(9, lh.shape[-1]))
        return hll_inv, hib_obs, jls_obs, lh_obs

    def _hpp_b_s(self, lin: Lin1S, hib_obs, jls_obs):
        """(hpp [12,12,N] undamped, b [12,N]) with pose scales applied
        as outer products after the reduction."""
        hpp_raw, b_raw = pose_kernels.hpp_b_structured(
            self.obs.cam, lin.ct, lin.x, self._uv_s, lin.sw, lin.r_w,
            jls_obs, hib_obs, self.n_cams, alpha=self.alpha,
        )
        ps = lin.pose_scale
        hpp = self._psum(hpp_raw).reshape(12, 12, self.n_cams) * (
            ps[:, None, :] * ps[None, :, :]
        )
        return hpp, self._psum(b_raw) * ps

    def _h_factor_s(self, lin: Lin1S, jls_obs, lh_obs):
        return pose_kernels.e0_factor(
            self.obs.cam, lin.ct, self._uv_s, lin.sw * lin.sw, jls_obs,
            lh_obs, alpha=self.alpha,
        )

    def _e0_apply_s(self, lin: Lin1S, h: torch.Tensor):
        """Matrix-free structured E0 = W^T(seg_lm(W gather .))
        (stage1.py:1974-2002 of the JAX package): the fused term over the
        plan's narrow parts (one e0_term_parts launch) plus the composed
        terms on its wide suffix, or, without a plan, the composed
        e0_u -> slot reduce/re-expand -> e0_scatter term."""
        ps = lin.pose_scale
        cam = self.obs.cam
        plan = self.e0_plan

        if plan is not None:
            suffix = self._e0_suffix_s(lin, h)

            def e0_fused(v):
                z = ps * v
                out = pose_kernels.e0_term_parts(
                    cam, lin.x, h, z, plan.parts, self.n_cams
                )
                if suffix is not None:
                    out = out + suffix(z)
                return ps * self._psum(out)

            return e0_fused

        def e0(v):
            u = pose_kernels.e0_u_structured(cam, lin.x, h, ps * v)
            sb = self._seg_lm_reexpand(u)
            out = pose_kernels.e0_scatter_structured(
                cam, lin.x, h, sb, self.n_cams
            )
            return ps * self._psum(out)

        return e0

    def _e0_suffix_s(self, lin: Lin1S, h: torch.Tensor):
        """The composed E0 term on the plan's wide suffix [cut, O)
        (landmarks with more than E0_TERM_MAX_W observations;
        `_e0_suffix_apply` of the JAX package), as a function of the
        scaled table z, or None without a suffix. The suffix's operands
        are sliced once per solve."""
        if self.e0_plan.suffix is None:
            return None
        cut, shapes = self.e0_plan.suffix
        cam_s = self.obs.cam[cut:]
        x_s = lin.x[:, cut:].contiguous()
        h_s = h[:, cut:].contiguous()

        def apply(z):
            u = pose_kernels.e0_u_structured(cam_s, x_s, h_s, z)
            sb = slot_row_expand(slot_part_sums(u, shapes), shapes)
            return pose_kernels.e0_scatter_structured(
                cam_s, x_s, h_s, sb, self.n_cams
            )

        return apply

    def solve_power(self, lin, lam, landmark_damping: bool = False,
                    ctl=None) -> Tuple[torch.Tensor, int]:
        """POWER_VARPROJ (or, with `landmark_damping`, POWER_SCHUR_
        COMPLEMENT) solve (`_solve_power_s` of the JAX package):
        power-series expansion
        x = sum_i (B^-1 E0)^i B^-1 (-b)
        (linearizor_power_varproj.cpp:177-243 + hpp:191-237), with the
        landmark blocks damped by lam I for POWER_SCHUR_COMPLEMENT.
        Returns (inc [12, N] in scaled coordinates, state dtype;
        num_terms)."""
        lam_s = self._solve_scalar(lam)
        if isinstance(lin, Lin1):
            hll_inv, hll_inv_bl = self._hll_inv_u(
                lin.Jl, lin.r, lam_s if landmark_damping else None
            )
            hpp, b = self._hpp_b_u(lin.Jp, lin.Jl, lin.r, hll_inv_bl)
            return self._power_solve_u(
                b, hpp, self._e0_factor_u(lin.Jp, lin.Jl, hll_inv), lam_s,
                ctl)
        pieces = self._hll_pieces_s(lin, lam_s if landmark_damping else None)
        prep = self._power_prep_s(lin, lam_s, pieces)
        return self._power_iterate_s(lin, prep, ctl)

    def _power_prep_s(self, lin: Lin1S, lam_s, hll_pieces):
        _hll_inv, hib_obs, jls_obs, lh_obs = hll_pieces
        hpp, b = self._hpp_b_s(lin, hib_obs, jls_obs)
        eye = torch.eye(12, dtype=hpp.dtype, device=hpp.device)
        hpp = hpp + lam_s * eye[:, :, None]
        b_inv = linalg.inv_psd_smallf(hpp)
        h = self._h_factor_s(lin, jls_obs, lh_obs)
        return -b, b_inv, h

    def _power_iterate_s(self, lin: Lin1S, prep, ctl=None):
        nb, b_inv, h = prep
        inc, n_iter = self._power_series(
            lambda v: mv(b_inv, v), self._e0_apply_s(lin, h), nb, ctl)
        return inc.to(self.dtype), n_iter

    def solve_pcg(self, lin, lam, ctl=None) -> Tuple[torch.Tensor, int]:
        """PCG on the implicit reduced camera system S x = b,
        S = Hpp + lam I - E0 (`_solve_pcg_s` / `_solve_pcg` of the JAX
        package; linearizor_sc.cpp with conjugate_gradient.hpp),
        preconditioned per options.preconditioner_type. Returns (inc = -x
        [12, N] in scaled coordinates, state dtype; CG iterations)."""
        lam_s = self._solve_scalar(lam)
        if isinstance(lin, Lin1):
            hll_inv, hll_inv_bl = self._hll_inv_u(lin.Jl, lin.r, None)
            hpp, b = self._hpp_b_u(lin.Jp, lin.Jl, lin.r, hll_inv_bl)
            return self._pcg_solve_u(
                b, hpp, self._e0_factor_u(lin.Jp, lin.Jl, hll_inv), lam_s,
                lambda: self._schur_corr_u(lin.Jp, lin.Jl, hll_inv), ctl,
            )
        _hll_inv, hib_obs, jls_obs, lh_obs = self._hll_pieces_s(lin)
        hpp, b = self._hpp_b_s(lin, hib_obs, jls_obs)
        h = self._h_factor_s(lin, jls_obs, lh_obs)
        precond = self._precond_closure(
            self._pcg_precond_s(lin, lam_s, hpp, h)
        )
        e0 = self._e0_apply_s(lin, h)

        def matvec(v):
            return mv(hpp, v) + lam_s * v - e0(v)

        x, n_iter = self._cg(matvec, b, precond, ctl)
        return (-x).to(self.dtype), n_iter

    def _pcg_precond_s(self, lin: Lin1S, lam_s, hpp, h):
        """Preconditioner materials (`_pcg_precond_s` of the JAX
        package): the damped Hpp blocks less their Schur corrections,
        hpp + lam I - seg_cam((h^T h) (x) xh xh^T) . (ps ps^T), one
        schur_diag_structured pass; none for IDENTITY."""
        if self.opts.preconditioner_type == PreconditionerType.IDENTITY:
            return ()
        ps = lin.pose_scale
        corr = self._psum(pose_kernels.schur_diag_structured(
            self.obs.cam, lin.x, h, self.n_cams
        )).reshape(12, 12, self.n_cams) * (ps[:, None, :] * ps[None, :, :])
        eye = torch.eye(12, dtype=hpp.dtype, device=hpp.device)
        return self._precond_mats(hpp + lam_s * eye[:, :, None] - corr)

    def solve_cholesky(self, lin: Lin1, lam) -> Tuple[torch.Tensor, int]:
        """CHOLESKY (`_chol_solve` of the JAX package; solve_direct_pOSE,
        linearization_sc.hpp:236-245): the dense reduced camera system
        S = blockdiag(Hpp) + lam I - A A^T [12N, 12N], with A [12N, 3M]
        holding W_o hll_inv^(1/2) in block (cam(o), lm(o)), solved
        directly for S inc = -b, in the solve dtype (f64 in pure f64; A
        then takes 2.84 GB at venice-89, and A A^T is a DGEMM). A takes
        12 N x 3 M entries, 144 N M bytes in f32 (288 N M in f64), and S
        144 N^2 (288 N^2): the dense route runs up to DENSE_CHOL_MAX
        cameras and while both fit the device (dense_chol_unsupported),
        S's diagonal blocks and damping added in place. A not
        positive definite S (possible in f32: S is a difference) gives an
        all-NaN increment, which the LM loop rejects. Returns (inc [12, N]
        in scaled coordinates, state dtype; 0 linear-solver iterations,
        as the reference records)."""
        if not isinstance(lin, Lin1):
            raise TypeError("CHOLESKY runs on the unstructured layout: "
                            f"Lin1 expected, got {type(lin).__name__}")
        lam_s = self._solve_scalar(lam)
        n, m = self.n_cams, self.n_lms
        hll_inv, hll_inv_bl = self._hll_inv_u(lin.Jl, lin.r, None)
        hpp, b = self._hpp_b_u(lin.Jp, lin.Jl, lin.r, hll_inv_bl)
        w = torch.einsum("kio,kjo->ijo", lin.Jp, lin.Jl)  # [12, 3, O]
        wl = torch.einsum("ijo,jko->oik", w, self._gather_lm_x(
            linalg.cholesky_smallf(hll_inv)))  # [O, 12, 3]
        # flat index of entry (cam(o) 12 + i, lm(o) 3 + k) of A; a slot
        # pad row repeats a live row's (cam, lm) and adds zeros
        dev = wl.device
        rows = (self.obs.cam.long()[:, None, None] * 12
                + torch.arange(12, device=dev)[None, :, None])
        cols = (self.obs.lm.long()[:, None, None] * 3
                + torch.arange(3, device=dev)[None, None, :])
        a = torch.zeros(12 * n * 3 * m, dtype=wl.dtype, device=dev)
        a.index_put_(((rows * (3 * m) + cols).reshape(-1),),
                     wl.reshape(-1), accumulate=True)
        a = a.reshape(12 * n, 3 * m)
        s = torch.mm(a, a.T).neg_()
        del a
        cams = torch.arange(n, device=dev)
        s.view(n, 12, n, 12)[cams, :, cams, :] += hpp.permute(2, 0, 1)
        s.diagonal().add_(lam_s)
        inc = -linalg.solve_psd_dense(s, b.T.reshape(-1)).reshape(n, 12)
        return inc.T.to(self.dtype), 0

    # ------------------------------------------------------------- apply

    def apply(self, cam_space, lm_p, lin, inc_scaled):
        """Camera update + VarProj back-substitution
        (linearizor_power_varproj.cpp:245-263 `apply` +
        sc/landmark_block.hpp:670-707 back_substitute_pOSE).
        Returns (new_cam_space, new_lm_p, l_diff)."""
        new_cam = self._update_cams(cam_space, lin, inc_scaled)
        back_sub = (self._back_sub if isinstance(lin, Lin1)
                    else self._back_sub_s)
        new_lm, l_diff = back_sub(new_cam, lm_p, lin, inc_scaled)
        return new_cam, new_lm, l_diff

    def _update_cams(self, cam_space, lin, inc_scaled):
        """apply_inc_pose_pOSE (bal_problem.hpp:147-163): unscale the
        camera increment (in the storage dtype, as the JAX package
        does) and add it to the 3x4 matrices."""
        inc_phys = inc_scaled.to(lin.pose_scale.dtype) * lin.pose_scale
        return cam_space + inc_phys.to(self.dtype).T.reshape(
            self.n_cams, 3, 4
        )

    def _back_sub(self, new_cam, lm_p, lin: Lin1, inc_scaled):
        """The unstructured VarProj landmark step (`_back_sub` of the JAX
        package): fresh unweighted Jacobians at the updated cameras, the
        exact landmark step, and l_diff from the fresh Jp with the scaled
        increment and the stored scaled Jl with the landmark step.
        Returns (new_lm_p, l_diff) with l_diff a 0-d f64 tensor."""
        x = self._expand_L(self._lm_rows(lm_p).to(self.solve_dtype))
        r_new, Jp_new, Jl_new = (
            self._mask_rows(t) for t in pose_math.pose_jacobians_t(
                self._gather_cams(new_cam), x, self._uv_s, self.alpha))
        inc_lm = -linalg.solve3x3f(
            self._hll_u(Jl_new),
            self._seg_lm(torch.einsum("kio,ko->io", Jl_new, r_new)),
        )  # [3, M]
        j_inc = torch.einsum(
            "ijo,jo->io", Jp_new,
            self._gather_cam_x(inc_scaled.to(self.solve_dtype)),
        ) + torch.einsum("ijo,jo->io", lin.Jl, self._gather_lm_x(inc_lm))
        return self._lm_add_u(lm_p, inc_lm), self._l_diff_u(j_inc, lin.r)

    def _back_sub_s(self, new_cam, lm_p, lin: Lin1S, inc_scaled):
        """Exact VarProj landmark step from UNWEIGHTED fresh Jacobians
        at the updated cameras (helper.cpp:382-454), and the model cost
        decrease l_diff against the stored linearization. Returns
        (new_lm_p, l_diff) with l_diff a 0-d f64 tensor."""
        sd = self.solve_dtype
        inc_f = inc_scaled.to(sd).contiguous()
        ct_new = self._cam_table(new_cam, sd)
        _rw, _sw, ata, atr, _jpsq = pose_kernels.prepare(
            self.obs.cam, ct_new, lin.x, self._uv_s, self._mask1,
            alpha=self.alpha, robust=0, huber=1.0, weighted=False,
            sums=False,
        )
        hll_new = self._hll_guard_L(self._seg_L(ata).reshape(3, 3, -1))
        tmp = self._seg_L(atr)
        inc_lm = self._lm_masked_L(-linalg.solve3x3f(hll_new, tmp))  # [3, L]

        neg_l_diff = pose_kernels.apply_ldiff(
            self.obs.cam, lin.x, self._uv_s, lin.sw, lin.r_w,
            self._expand_L(lin.jl_scale), self._expand_L(inc_lm),
            lin.ct, inc_f, alpha=self.alpha,
        )
        return self._add_lm(lm_p, inc_lm), -self._psum(neg_l_diff)

    def _add_lm(self, lm_p, inc_lm: torch.Tensor):
        """The landmark state plus an L-space increment [3, L], in the
        state dtype and the state's representation."""
        if isinstance(lm_p, LmState):
            return LmState(rows=lm_p.rows + inc_lm.to(self.dtype))
        return lm_p + self._L_to_lm(inc_lm).to(self.dtype).T

    def apply_poba(self, cam_space, lm_p, lin, inc_scaled, lam):
        """POWER_SCHUR_COMPLEMENT apply (`_apply_poba` of the JAX
        package): the camera update, then the classical LM back-
        substitution from the STORED scaled Jacobians with the landmark
        blocks damped by lam (back_substitute_poBA,
        sc/landmark_block.hpp:625-668). Returns (new_cam_space, new_lm_p,
        l_diff)."""
        new_cam = self._update_cams(cam_space, lin, inc_scaled)
        back_sub = (self._back_sub_poba if isinstance(lin, Lin1)
                    else self._back_sub_poba_s)
        new_lm, l_diff = back_sub(lm_p, lin, inc_scaled, lam)
        return new_cam, new_lm, l_diff

    def _back_sub_poba(self, lm_p, lin: Lin1, inc_scaled, lam):
        """The unstructured poBA landmark step (`_back_sub_poba` of the
        JAX package): inc_lm = -(Hll_s + lam I)^-1 seg_lm(Jl_s^T (r +
        Jp_s inc)) from the stored scaled Jacobians, l_diff from them, and
        only then the Jl column unscaling. Returns (new_lm_p, l_diff)."""
        jp_inc, inc_lm = self._damped_lm_step_u(
            lin.Jp, lin.Jl, lin.r, inc_scaled, self._solve_scalar(lam)
        )  # inc_lm [3, M], scaled
        j_inc = jp_inc + torch.einsum("ijo,jo->io", lin.Jl,
                                      self._gather_lm_x(inc_lm))
        return (self._lm_add_u(lm_p, inc_lm * lin.jl_scale),
                self._l_diff_u(j_inc, lin.r))

    def _back_sub_poba_s(self, lm_p, lin: Lin1S, inc_scaled, lam):
        """poBA landmark step (stage1.py:2169-2211 of the JAX package):
        inc_lm = -(Hll_s + lam I)^-1 seg_lm(Jl_s^T (r_w + Jp_s inc)) in
        the scaled coordinates, one poba_t3 pass; the model cost decrease
        from the stored Jacobians, one apply_ldiff_stored pass; only
        then is inc_lm unscaled by the Jl column scale
        (landmark_block.hpp:664-666). Returns (new_lm_p, l_diff) with
        l_diff a 0-d f64 tensor."""
        lam_s = self._solve_scalar(lam)
        d = lin.jl_scale
        jls_obs = self._expand_L(d)
        z_table = lin.pose_scale * inc_scaled.to(self.solve_dtype)
        t3 = pose_kernels.poba_t3(
            self.obs.cam, lin.ct, lin.x, self._uv_s, lin.sw, lin.r_w,
            jls_obs, z_table, alpha=self.alpha,
        )
        inc_lm_scaled = self._lm_masked_L(-linalg.solve3x3f(
            self._scaled_hll(lin, lam_s), self._seg_L(t3)
        ))  # [3, L]
        neg_l_diff = pose_kernels.apply_ldiff_stored(
            self.obs.cam, lin.x, self._uv_s, lin.sw, lin.r_w, jls_obs,
            self._expand_L(inc_lm_scaled), lin.ct, z_table,
            alpha=self.alpha,
        )
        return (self._add_lm(lm_p, inc_lm_scaled * d),
                -self._psum(neg_l_diff))

"""Analytic FLOP-count models for the solver variants.

Equivalent of scripts/num_ops/compute_num_ops.py: closed-form operation
counts parameterized on (n_poses, n_landmarks, n_obs) for comparing
Schur-complement, power-series, and CG strategies, extended with the
pOSE VarProj dimensions of this framework (4-dim residual, 12-dof
poses, 3-dim landmarks; step-2: 2-dim residual, 11-dof tangent).

A copy of povar_tpu/tools/num_ops.py with its imports rewritten to this
package, which never imports jax or povar_tpu.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ProblemDims:
    n_poses: int
    n_landmarks: int
    n_obs: int


def pose_varproj_linearize_flops(d: ProblemDims) -> float:
    """pOSE residual + Jp/Jl evaluation + robust weighting + scaling."""
    per_obs = (
        4 * 4 * 2  # A~ rows
        + 4 * 4 * 2  # residual
        + 4 * 12  # Jp fill (scaled copies)
        + 4 * (12 + 3 + 1)  # weighting
        + 2 * 4 * (12 + 3)  # column-norm accumulation + scaling
    )
    return float(d.n_obs * per_obs)


def schur_prepare_flops(d: ProblemDims) -> float:
    """Hll (3x3) + Hpp diag (12x12) + gradient assembly."""
    per_obs = 2 * 4 * 9 + 2 * 4 * 144 + 2 * 4 * (12 + 3) * 2
    per_lm = 42  # 3x3 inverse
    per_pose = 12**3 / 3 * 2  # 12x12 Cholesky inverse
    return float(
        d.n_obs * per_obs + d.n_landmarks * per_lm + d.n_poses * per_pose
    )


def power_term_flops(d: ProblemDims) -> float:
    """One power-series term: E0 matvec + block-diagonal B^-1 apply."""
    e0 = d.n_obs * 2 * 4 * (12 + 3) * 2 + d.n_landmarks * 18
    b_inv = d.n_poses * 2 * 144
    return float(e0 + b_inv)


def cg_iteration_flops(d: ProblemDims) -> float:
    """One implicit-SC CG iteration: one S matvec + preconditioner +
    vector ops."""
    matvec = power_term_flops(d) + d.n_poses * 2 * 144
    precond = d.n_poses * 2 * 144
    vecs = 6 * d.n_poses * 12
    return float(matvec + precond + vecs)


def explicit_sc_assembly_flops(d: ProblemDims, obs_per_lm: float) -> float:
    """Explicit RCS assembly is quadratic in per-landmark observation
    count (all camera-pair blocks; add_Hb_pOSE in the reference)."""
    pair_cost = 2 * 12 * 3 * 12 + 2 * 12 * 12 * 3
    return float(d.n_landmarks * obs_per_lm**2 * pair_cost)


def solve_flops(
    d: ProblemDims,
    method: str = "power_varproj",
    power_terms: int = 10,
    cg_iterations: int = 100,
) -> float:
    """Total FLOPs for one LM iteration under the given linear solver."""
    base = pose_varproj_linearize_flops(d) + schur_prepare_flops(d)
    if method == "power_varproj":
        return base + power_terms * power_term_flops(d)
    if method == "pcg":
        return base + cg_iterations * cg_iteration_flops(d)
    if method == "cholesky":
        n = d.n_poses * 12
        return base + explicit_sc_assembly_flops(
            d, d.n_obs / d.n_landmarks
        ) + 2.0 / 3.0 * n**3
    raise ValueError(method)


# ---------------------------------------------------------------------
# step 2 (Riemannian joint refinement): 2-dim homogeneous residual,
# 11-dof camera tangent (12-vector Householder nullspace), 3-dim
# landmark tangent (4-vector Householder nullspace). Counts mirror the
# reference's joint path (landmark_block.hpp linearize_landmark_joint
# + get_Hll_inv_add_Hpp_b_joint + back_substitute_joint).


def stage2_linearize_flops(d: ProblemDims) -> float:
    """Homogeneous residual + Jp (2x12) / Jl (2x4) + tangent
    projections through the camera/landmark nullspace kernels +
    column scaling."""
    per_obs = (
        3 * 8 * 2  # P @ xh projection (3x4 @ 4)
        + 2 * 4  # residual + w normalization
        + 2 * 12 * 2 + 2 * 4 * 2  # Jp / Jl fill
        + 2 * 12 * 11 * 2  # Jp @ kernel_cam (tangent lift)
        + 2 * 4 * 3 * 2  # Jl @ kernel_lm
        + 2 * (11 + 3) * 2  # column-norm accumulation + scaling
    )
    per_pose = 12 * 11 * 4  # Householder kernel of the 12-vector
    per_lm = 4 * 3 * 4  # Householder kernel of the 4-vector
    return float(
        d.n_obs * per_obs + d.n_poses * per_pose + d.n_landmarks * per_lm
    )


def stage2_prepare_flops(d: ProblemDims) -> float:
    """Hll (3x3) + Hpp diag (11x11) + gradient + factorizations."""
    per_obs = 2 * 2 * 9 + 2 * 2 * 121 + 2 * 2 * (11 + 3) * 2
    per_lm = 42  # damped 3x3 inverse
    per_pose = 11**3 / 3 * 2  # 11x11 Cholesky inverse
    return float(
        d.n_obs * per_obs + d.n_landmarks * per_lm + d.n_poses * per_pose
    )


def stage2_power_term_flops(d: ProblemDims) -> float:
    """One RIPOBA power-series term on the tangent system."""
    e0 = d.n_obs * 2 * 2 * (11 + 3) * 2 + d.n_landmarks * 18
    b_inv = d.n_poses * 2 * 121
    return float(e0 + b_inv)


def stage2_cg_iteration_flops(d: ProblemDims) -> float:
    """One RIPCG iteration: implicit tangent-SC matvec +
    SCHUR_JACOBI preconditioner + vector ops."""
    matvec = stage2_power_term_flops(d) + d.n_poses * 2 * 121
    precond = d.n_poses * 2 * 121
    vecs = 6 * d.n_poses * 11
    return float(matvec + precond + vecs)


def stage2_backsub_flops(d: ProblemDims) -> float:
    """Landmark tangent back-substitution + 4/12-lift + retraction
    (Frobenius normalization, dehomogenization) + model decrease."""
    per_obs = 2 * 2 * (11 + 3) * 2
    per_lm = 18 + 4 * 3 * 2 + 12
    per_pose = 12 * 11 * 2 + 3 * 12
    return float(
        d.n_obs * per_obs + d.n_landmarks * per_lm + d.n_poses * per_pose
    )


def stage2_cost_flops(d: ProblemDims) -> float:
    """Per-trial homogeneous cost evaluation (accept/reject gate)."""
    return float(d.n_obs * (3 * 8 * 2 + 2 * 4 + 6))


def stage2_solve_flops(
    d: ProblemDims,
    method: str = "ripoba",
    power_terms: int = 10,
    cg_iterations: int = 100,
    relinearize: bool = True,
) -> float:
    """Total FLOPs for one step-2 LM iteration (one backtracking
    trial): optional relinearization (skipped by the reference after
    a rejected step) + prepare + inner solve + back-substitution +
    cost evaluation."""
    total = stage2_prepare_flops(d) + stage2_backsub_flops(d)
    total += stage2_cost_flops(d)
    if relinearize:
        total += stage2_linearize_flops(d)
    if method == "ripoba":
        return total + power_terms * stage2_power_term_flops(d)
    if method == "ripcg":
        return total + cg_iterations * stage2_cg_iteration_flops(d)
    raise ValueError(method)


def stage1_trial_flops(
    d: ProblemDims,
    method: str = "power_varproj",
    inner_iterations: int = 10,
    relinearize: bool = True,
) -> float:
    """Total FLOPs for one step-1 LM backtracking trial: optional
    relinearization + prepare + inner solve + back-substitution +
    the per-trial cost evaluation. The reference relinearizes only
    after an accepted step (bal_bundle_adjustment.cpp:337-448)."""
    dl, dp, r = 3, 12, 4
    total = schur_prepare_flops(d)
    if relinearize:
        total += pose_varproj_linearize_flops(d)
    # back-substitution + camera update + model decrease
    total += d.n_obs * (2 * r * dl * 2 + 2 * r * dp) + d.n_landmarks * 60
    # per-trial pOSE cost evaluation
    total += d.n_obs * (2 * r * r + 12)
    if method == "power_varproj":
        return total + inner_iterations * power_term_flops(d)
    if method == "pcg":
        return total + inner_iterations * cg_iteration_flops(d)
    raise ValueError(method)


if __name__ == "__main__":
    # venice-1778 scale, matching the reference script's example numbers
    d = ProblemDims(n_poses=1778, n_landmarks=993923, n_obs=5001946)
    for m in ("power_varproj", "pcg", "cholesky"):
        print(f"{m:16s} {solve_flops(d, m):.3e} flops/LM-iteration")

"""Per-observation residuals, Jacobians and robust weights of both
steps, observation last.

The counterpart of the observation-last ("_t") half of
povar_tpu/ops/pose_math.py: the pOSE residual and Jacobians of step 1
and the closed-form VarProj normal equations, the homogeneous
reprojection residual and Jacobians of step 2 with its projection-
validity test, and the robust cost. The f32 LM state's cost and the
unstructured layout (`Lin1` / `Lin2` of solver/stage1.py and stage2.py)
use them. Layouts are the JAX package's transposed ones: gathered
cameras P [3, 4, O], landmarks [3, O] or [4, O], measurements uv [2, O];
Jacobians [k, n, O]. Every function runs in the dtype of its inputs;
scalar constants are rounded to that dtype first, as JAX rounds its
weakly typed constants.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

# robust norm codes (BalResidualOptions::RobustNorm,
# bal_residual_options.hpp)
ROBUST_NONE, ROBUST_HUBER, ROBUST_CAUCHY = 0, 1, 2


def _scalar(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype`, as a Python float."""
    return float(torch.tensor(value, dtype=torch.float64).to(dtype))


def sophus_eps_sqrt(dtype: torch.dtype) -> float:
    """Sophus::Constants<Scalar>::epsilonSqrt(): sqrt(1e-10) = 1e-5 for
    double, sqrt(1e-5f) for float, the |z| projection-validity threshold
    of step 2 (bal_camera.hpp:147). It depends on the dtype: an f32 state
    holds a projection valid from |z| >= 3.16e-3 on, an f64 one from
    1e-5. Not the machine epsilon."""
    if dtype == torch.float32:
        return float(torch.sqrt(torch.tensor(1e-5, dtype=torch.float32)))
    return float(torch.sqrt(torch.tensor(1e-10, dtype=dtype)))


def robust_error_and_weight(
    res_sq: torch.Tensor, robust: int, huber: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-observation robust cost and IRLS weight (compute_error_weight,
    helper.cpp:50-74):
      NONE:   error = 0.5 r^2,                weight = 1
      HUBER:  w = 1 if r^2 < t^2 else t/|r|;  error = 0.5 (2 - w) w r^2
      CAUCHY: error = log(1 + r^2),           weight = 1"""
    if robust == ROBUST_HUBER:
        w = torch.where(
            res_sq < huber * huber,
            torch.ones_like(res_sq),
            huber / torch.sqrt(res_sq),
        )
        return 0.5 * (2.0 - w) * w * res_sq, w
    if robust == ROBUST_CAUCHY:
        return torch.log1p(res_sq), torch.ones_like(res_sq)
    return 0.5 * res_sq, torch.ones_like(res_sq)


def pose_matrix_tilde_t(
    P: torch.Tensor, uv: torch.Tensor, alpha: float
) -> torch.Tensor:
    """The pOSE mixing matrix A~ [4, 4, O] from P [3, 4, O] and uv [2, O]
    (helper.cpp:250-254):
      0: sqrt(1-a) (P0 - u P2)    1: sqrt(1-a) (P1 - v P2)
      2: sqrt(a)   P0             3: sqrt(a)   P1"""
    sp = _scalar(math.sqrt(1.0 - alpha), P.dtype)
    sa = _scalar(math.sqrt(alpha), P.dtype)
    u, v = uv[0][None], uv[1][None]  # [1, O]
    return torch.stack([
        sp * (P[0] - u * P[2]),
        sp * (P[1] - v * P[2]),
        sa * P[0],
        sa * P[1],
    ])


def pose_residual_t(
    P: torch.Tensor, x: torch.Tensor, uv: torch.Tensor, alpha: float
) -> torch.Tensor:
    """pOSE residual r [4, O] = A~ [x, 1] - [0, 0, sa u, sa v]."""
    A = pose_matrix_tilde_t(P, uv, alpha)
    xh = torch.cat([x, torch.ones_like(x[:1])])  # [4, O]
    r = (A * xh[None]).sum(dim=1)
    sa = _scalar(math.sqrt(alpha), P.dtype)
    return r - torch.cat([torch.zeros_like(uv), sa * uv])


def homogeneous_residual_t(
    P: torch.Tensor, xh: torch.Tensor, uv: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(r [2, O], valid [O]) of the homogeneous projection from P
    [3, 4, O], xh [4, O], uv [2, O]: r = (p0, p1) / p2 - uv with p = P xh,
    valid where |p2| >= sophus_eps_sqrt of the dtype."""
    p = (P * xh[None]).sum(dim=1)  # [3, O]
    z = p[2]
    return p[:2] / z[None] - uv, z.abs() >= sophus_eps_sqrt(xh.dtype)


def pose_jacobians_t(
    P: torch.Tensor, x: torch.Tensor, uv: torch.Tensor, alpha: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(r [4, O], Jp [4, 12, O], Jl [4, 3, O]) of the pOSE residual: Jp
    is d r / d vec(P) in the row-major 12-vector layout
    (helper.cpp:269-306), Jl = A~[:, :3] (helper.cpp:308-311). The
    residual is affine in the landmark, which makes the VarProj closed
    form exact."""
    A = pose_matrix_tilde_t(P, uv, alpha)
    r = pose_residual_t(P, x, uv, alpha)
    sp = _scalar(math.sqrt(1.0 - alpha), P.dtype)
    sa = _scalar(math.sqrt(alpha), P.dtype)
    xh = torch.cat([x, torch.ones_like(x[:1])])  # [4, O]
    u, v = uv[0][None], uv[1][None]
    zero4 = torch.zeros_like(xh)
    Jp = torch.stack([
        sp * torch.cat([xh, zero4, -u * xh]),
        sp * torch.cat([zero4, xh, -v * xh]),
        sa * torch.cat([xh, zero4, zero4]),
        sa * torch.cat([zero4, xh, zero4]),
    ])
    return r, Jp, A[:, :3]


def varproj_init_normal_eq_t(
    P: torch.Tensor, uv: torch.Tensor, alpha: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(G^T G [3, 3, O], G^T z [3, O]) per observation for the closed-form
    landmark init v*(u0) = (G^T G)^-1 G^T z (helper.cpp:75-99), with
    G = A~[:, :3] and z = [0, 0, sa u, sa v] - A~[:, 3], so that
    r(x) = G x - z."""
    A = pose_matrix_tilde_t(P, uv, alpha)
    G = A[:, :3]  # [4, 3, O]
    sa = _scalar(math.sqrt(alpha), P.dtype)
    z = torch.cat([torch.zeros_like(uv), sa * uv]) - A[:, 3]  # [4, O]
    gtg = (G[:, :, None] * G[:, None, :]).sum(dim=0)
    gtz = (G * z[:, None]).sum(dim=0)
    return gtg, gtz


def homogeneous_jacobians_t(
    P: torch.Tensor, xh: torch.Tensor, uv: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(r [2, O], Jp [2, 12, O], Jl [2, 4, O], valid [O]) of the
    homogeneous projection (helper.cpp:315-377): with p = P xh,
    d proj / d p = [[1/z, 0, -x/z^2], [0, 1/z, -y/z^2]], Jp its product
    with d p / d vec(P) and Jl its product with P; valid where
    |z| >= sophus_eps_sqrt of the dtype."""
    p = (P * xh[None]).sum(dim=1)  # [3, O]
    x_, y_, z_ = p[0], p[1], p[2]
    inv_z = 1.0 / z_
    r = torch.stack([x_ * inv_z, y_ * inv_z]) - uv
    valid = z_.abs() >= sophus_eps_sqrt(xh.dtype)
    xh_z = xh * inv_z[None]  # [4, O]
    xz2 = (x_ * inv_z * inv_z)[None] * xh
    yz2 = (y_ * inv_z * inv_z)[None] * xh
    zero4 = torch.zeros_like(xh)
    Jp = torch.stack([
        torch.cat([xh_z, zero4, -xz2]),
        torch.cat([zero4, xh_z, -yz2]),
    ])
    zero = torch.zeros_like(inv_z)
    dproj = torch.stack([
        torch.stack([inv_z, zero, -x_ * inv_z * inv_z]),
        torch.stack([zero, inv_z, -y_ * inv_z * inv_z]),
    ])  # [2, 3, O]
    Jl = (dproj[:, :, None] * P[None]).sum(dim=1)  # [2, 4, O]
    return r, Jp, Jl, valid

"""Plain PyTorch versions of the eleven step-1 structured kernels.

The counterpart of povar_tpu/ops/xla_pose.py:64-296 (the dtype-generic
mirrors of the Pallas bodies in povar_tpu/ops/pallas_pose.py) plus the
pOSE cost of `stage1._compute_error` (stage1.py:1240-1259). Each
function computes, term for term and in the same operation order, what
its hand-written CUDA kernel in csrc/pose1.cu computes:

  prepare                residual, robust weight, landmark normal-
                         equation terms, per-camera Jp column norms^2
  e0_factor              the 9-value E0 factor h
  hpp_b_structured       per-camera raw Hpp and b
  e0_u_structured        u = h (xh . z[:, cam])
  e0_scatter_structured  per-camera sums of (h^T sb) (x) xh
  e0_term_parts          the fused power-series term: e0_u, the per-
                         landmark slot sum and e0_scatter in one pass
  schur_diag_structured  per-camera Schur-Jacobi corrections (h^T h) (x)
                         xh xh^T
  apply_ldiff            -l_diff, the model-cost decrease of the apply
  poba_t3                Jl_s^T (r_w + Jp_s inc), the right-hand side of
                         the POWER_SCHUR_COMPLEMENT landmark system
  apply_ldiff_stored     -l_diff of the POWER_SCHUR_COMPLEMENT apply
  pose_error             pOSE cost, residual-norm sum, non-finite count

ops/pose_kernels.py calls these for tensors on the CPU (the tests) and
chip_smoke.py holds each CUDA kernel against them on the card. Per-
camera sums are `index_add_` over the camera index; the camera-table
gathers are plain indexing. Layouts are the JAX package's, observation
last: camera tables [12, N] (row-major vec(P) per camera), per-
observation rows [k, O].

The pOSE residual (bal_bundle_adjustment_helper.cpp:243-313) has
Kronecker structure:

  A~ rows:  A0 = sp (P0 - u P2), A1 = sp (P1 - v P2),
            A2 = sa P0,          A3 = sa P1          (sp^2 + sa^2 = 1)
  r  = A~ xh - [0, 0, sa u, sa v],   xh = [x, 1]
  Jl = A~[:, :3],  Jp[k, 4a+j] = C[k, a] xh_j  with C from (u, v) only
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from povar_tpu_torch.ops import pose_math
from povar_tpu_torch.ops.pose_math import ROBUST_HUBER


class PoseConsts(NamedTuple):
    """Scalar constants as the kernels see them, rounded to the working
    dtype the way the Pallas kernels round them: sp = sqrt(1 - alpha),
    sa = sqrt(alpha), sp2 = sp * sp (a product in the working dtype,
    hpp_b_structured), sp2h = 1 - alpha (e0_factor)."""

    sp: float
    sa: float
    sp2: float
    sp2h: float


def pose_consts(alpha: float, dtype: torch.dtype) -> PoseConsts:
    if dtype == torch.float32:
        sp = np.float32(np.sqrt(1.0 - alpha))
        sa = np.float32(np.sqrt(alpha))
        return PoseConsts(
            float(sp), float(sa), float(sp * sp), float(np.float32(1.0 - alpha))
        )
    sp = float(np.sqrt(1.0 - alpha))
    return PoseConsts(sp, float(np.sqrt(alpha)), sp * sp, 1.0 - alpha)


def _a_tilde(P, u, v, sp, sa):
    """A~ [4][4] rows as lists of [O] vectors from P [12, O] rows."""
    A = [[None] * 4 for _ in range(4)]
    for c in range(4):
        p0, p1, p2 = P[c], P[4 + c], P[8 + c]
        A[0][c] = sp * (p0 - u * p2)
        A[1][c] = sp * (p1 - v * p2)
        A[2][c] = sa * p0
        A[3][c] = sa * p1
    return A


def _residual(A, xh, u, v, sa):
    """pOSE residual rows [4][O] = A~ xh - [0,0,sa u, sa v]."""
    r = []
    for k in range(4):
        acc = A[k][0] * xh[0]
        for c in range(1, 4):
            acc = acc + A[k][c] * xh[c]
        r.append(acc)
    r[2] = r[2] - sa * u
    r[3] = r[3] - sa * v
    return r


def _robust_w(res_sq, robust: int, huber: float):
    """IRLS weight (helper.cpp:50-74); error term not needed here."""
    if robust == ROBUST_HUBER:
        h2 = float(torch.tensor(huber * huber, dtype=res_sq.dtype))
        return torch.where(
            res_sq < h2,
            torch.ones_like(res_sq),
            huber / torch.sqrt(torch.clamp(res_sq, min=1e-30)),
        )
    return torch.ones_like(res_sq)


def _scatter(rows: torch.Tensor, cam: torch.Tensor, n_cams: int):
    """rows [R, O] -> per-camera sums [R, N]."""
    out = torch.zeros(
        (rows.shape[0], n_cams), dtype=rows.dtype, device=rows.device
    )
    return out.index_add_(1, cam.long(), rows)


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=x.dtype, device=x.device)


def prepare(cam, cam_table, x, uv, mask, *, alpha, robust, huber,
            weighted=True, sums=True):
    """Linearization-point pass. Returns (r_w [4,O], sw [1,O],
    ata [9,O], atr [3,O], jpsq [12,N]); `weighted=False` skips the
    robust weight (the unweighted fresh-Jacobian pass of the VarProj
    back-substitution, helper.cpp:382-454); `sums=False` returns None in
    place of r_w, sw and jpsq (ata and atr are the same either way).
    jpsq's rows 4-7 are its rows 0-3: diag K = [1, 1, kd2], so 8 of its
    12 per-camera sums are distinct."""
    c = pose_consts(alpha, x.dtype)
    P = cam_table[:, cam.long()]
    u, v = uv[0], uv[1]
    xh = [x[0], x[1], x[2], torch.ones_like(u)]
    live = mask[0] > 0
    zero = _zero(x)

    A = _a_tilde(P, u, v, c.sp, c.sa)
    r = _residual(A, xh, u, v, c.sa)
    r = [torch.where(live, rk, zero) for rk in r]
    res_sq = r[0] * r[0] + r[1] * r[1] + r[2] * r[2] + r[3] * r[3]
    w = _robust_w(res_sq, robust, huber) if weighted else (
        torch.ones_like(res_sq)
    )
    w = torch.where(live, w, zero)

    ata = []
    for i in range(3):
        for j in range(3):
            acc = A[0][i] * A[0][j]
            for k in range(1, 4):
                acc = acc + A[k][i] * A[k][j]
            ata.append(w * acc)
    atr = []
    for i in range(3):
        acc = A[0][i] * r[0]
        for k in range(1, 4):
            acc = acc + A[k][i] * r[k]
        atr.append(w * acc)
    if not sums:
        return None, None, torch.stack(ata), torch.stack(atr), None
    sw = torch.sqrt(w)
    r_w = torch.stack([rk * sw for rk in r])
    rows = [wk * xh[j] * xh[j]
            for wk in (w, w * (c.sp2 * (u * u + v * v))) for j in range(4)]
    jp8 = _scatter(torch.stack(rows), cam, cam_table.shape[-1])
    jpsq = torch.cat([jp8[:4], jp8])
    return r_w, sw.reshape(1, -1), torch.stack(ata), torch.stack(atr), jpsq


def e0_factor(cam, cam_table, uv, w, jls, lh, *, alpha):
    """h [9, O] (layout c*3+a) = w L^T D_jl g: w [1,O] robust weight
    (not sqrt), jls [3,O] landmark scale and lh [9,O] the Cholesky
    factor of Hll^-1 (row-major i*3+c), both expanded to observations."""
    sp2 = pose_consts(alpha, cam_table.dtype).sp2h
    P = cam_table[:, cam.long()]
    u, v = uv[0], uv[1]
    wv = w[0]
    g = [[None] * 3 for _ in range(3)]
    for i in range(3):
        p0, p1, p2 = P[i], P[4 + i], P[8 + i]
        g[i][0] = p0 - sp2 * u * p2
        g[i][1] = p1 - sp2 * v * p2
        g[i][2] = sp2 * ((u * u + v * v) * p2 - u * p0 - v * p1)
    h = []
    for c in range(3):
        for a in range(3):
            acc = jls[0] * lh[c] * g[0][a]
            acc = acc + jls[1] * lh[3 + c] * g[1][a]
            acc = acc + jls[2] * lh[6 + c] * g[2][a]
            h.append(wv * acc)
    return torch.stack(h)


def hpp_b_structured(cam, cam_table, x, uv, sw_a, r_w, jls, hib, n_cams,
                     *, alpha):
    """(hpp_raw [144, N], b_raw [12, N]) per-camera sums BEFORE the
    pose-scale outer products (row layout (4a+i)*12 + (4b+j)):
      r~      = r_w - Jl_s (Hll^-1 bl)
      b_raw   = seg_cam( rho (x) xh ),  rho from (r~, u, v)
      hpp_raw = seg_cam( w K (x) xh xh^T )"""
    c = pose_consts(alpha, x.dtype)
    P = cam_table[:, cam.long()]
    u, v = uv[0], uv[1]
    sw = sw_a[0]
    xh = [x[0], x[1], x[2], torch.ones_like(u)]

    A = _a_tilde(P, u, v, c.sp, c.sa)
    rt = []
    for k in range(4):
        corr = A[k][0] * jls[0] * hib[0]
        corr = corr + A[k][1] * jls[1] * hib[1]
        corr = corr + A[k][2] * jls[2] * hib[2]
        rt.append(r_w[k] - sw * corr)
    rho = [
        sw * (c.sp * rt[0] + c.sa * rt[2]),
        sw * (c.sp * rt[1] + c.sa * rt[3]),
        sw * (-c.sp * (u * rt[0] + v * rt[1])),
    ]
    b = _scatter(
        torch.stack([rho[a] * xh[j] for a in range(3) for j in range(4)]),
        cam, n_cams,
    )
    w = sw * sw
    one, zero = torch.ones_like(u), torch.zeros_like(u)
    K = [[one, zero, -c.sp2 * u],
         [zero, one, -c.sp2 * v],
         [-c.sp2 * u, -c.sp2 * v, c.sp2 * (u * u + v * v)]]
    rows = []
    for a in range(3):
        for i in range(4):
            wk = w * xh[i]
            for bb in range(3):
                for j in range(4):
                    rows.append(wk * K[a][bb] * xh[j])
    hpp = _scatter(torch.stack(rows), cam, n_cams)
    return hpp, b


def e0_u_structured(cam, x, h, z_table):
    """u [3, O] = W_o . z[:, cam(o)] with z_table = ps . xvec [12, N]."""
    zc = z_table[:, cam.long()]
    y = []
    for a in range(3):
        acc = zc[4 * a + 3]
        for j in range(3):
            acc = acc + x[j] * zc[4 * a + j]
        y.append(acc)
    return torch.stack([
        h[c * 3 + 0] * y[0] + h[c * 3 + 1] * y[1] + h[c * 3 + 2] * y[2]
        for c in range(3)
    ])


def e0_scatter_structured(cam, x, h, sb, n_cams):
    """out_raw [12, N] = seg_cam( (h^T sb) (x) xh ); the caller
    multiplies by the pose scale."""
    tt = []
    for a in range(3):
        acc = h[a] * sb[0]
        acc = acc + h[3 + a] * sb[1]
        acc = acc + h[6 + a] * sb[2]
        tt.append(acc)
    rows = torch.stack([
        tt[a] if j == 3 else tt[a] * x[j]
        for a in range(3) for j in range(4)
    ])
    return _scatter(rows, cam, n_cams)


def e0_term_parts(cam, x, h, z_table, parts, n_cams):
    """The fused power-series term: out_raw [12, N] = seg_cam( (h^T sb)
    (x) xh ) with sb = seg_lm( h (xh . z[:, cam]) ), over the slot parts
    `parts` ((ofs, g, w) each: g landmarks of slot width w from
    observation ofs on, slot element j of landmark l at observation
    ofs + j * g + l). sb sums over j = 0..w-1 in order, as the Pallas
    kernel's pass A does; the caller multiplies by the pose scale."""
    rows, cams = [], []
    for ofs, g, w in parts:
        sl = slice(ofs, ofs + g * w)
        c2 = cam[sl].long()
        x2 = x[:, sl].reshape(3, w, g)
        h2 = h[:, sl].reshape(9, w, g)
        zc = z_table[:, c2].reshape(12, w, g)
        y = []
        for a in range(3):
            acc = zc[4 * a + 3]
            for i in range(3):
                acc = acc + x2[i] * zc[4 * a + i]
            y.append(acc)
        u = [h2[c * 3 + 0] * y[0] + h2[c * 3 + 1] * y[1] + h2[c * 3 + 2] * y[2]
             for c in range(3)]
        sb = []
        for c in range(3):
            acc = u[c][0]
            for j in range(1, w):
                acc = acc + u[c][j]
            sb.append(acc)
        tt = [h2[a] * sb[0] + h2[3 + a] * sb[1] + h2[6 + a] * sb[2]
              for a in range(3)]
        rows.append(torch.stack([
            tt[a] if i == 3 else tt[a] * x2[i]
            for a in range(3) for i in range(4)
        ]).reshape(12, g * w))
        cams.append(c2)
    return _scatter(torch.cat(rows, dim=1), torch.cat(cams), n_cams)


def schur_diag_structured(cam, x, h, n_cams):
    """corr_raw [144, N] = seg_cam( (h^T h) (x) xh xh^T ), rows
    ((a*4+i)*3+b)*4+j; the caller applies the pose-scale outer product
    and subtracts it from the damped Hpp (the Schur-Jacobi diagonal
    blocks of PCG)."""
    xh = [x[0], x[1], x[2], None]
    hth = [[None] * 3 for _ in range(3)]
    for a in range(3):
        for b in range(a + 1):
            acc = h[a] * h[b]
            acc = acc + h[3 + a] * h[3 + b]
            acc = acc + h[6 + a] * h[6 + b]
            hth[a][b] = hth[b][a] = acc
    rows = []
    for a in range(3):
        for i in range(4):
            for b in range(3):
                for j in range(4):
                    r = hth[a][b]
                    if xh[i] is not None:
                        r = r * xh[i]
                    if xh[j] is not None:
                        r = r * xh[j]
                    rows.append(r)
    return _scatter(torch.stack(rows), cam, n_cams)


def apply_ldiff(cam, x, uv, sw_a, r_w, jls, inc_lm_obs, cam_table_old,
                inc_table, *, alpha):
    """-l_diff (f64 scalar): the model-cost decrease of the VarProj
    apply (back_substitute_pOSE, sc/landmark_block.hpp:670-707),
      j_inc  = Jp(new cams) inc_gathered + Jl_stored inc_lm
      -l_diff = sum j_inc . (0.5 j_inc + r_w)
    with per-observation terms in the working dtype and the sum in f64.
    The fresh Jp at the updated cameras depends only on (xh, u, v)."""
    c = pose_consts(alpha, x.dtype)
    cl = cam.long()
    q = inc_table[:, cl]
    Po = cam_table_old[:, cl]
    u, v = uv[0], uv[1]
    sw = sw_a[0]
    qt = []
    for a in range(3):
        acc = q[4 * a + 3]
        for j in range(3):
            acc = acc + x[j] * q[4 * a + j]
        qt.append(acc)
    live = sw > 0
    jp_inc = [
        c.sp * (qt[0] - u * qt[2]),
        c.sp * (qt[1] - v * qt[2]),
        c.sa * qt[0],
        c.sa * qt[1],
    ]
    Ao = _a_tilde(Po, u, v, c.sp, c.sa)
    zero = _zero(x)
    ld = torch.zeros_like(u)
    for k in range(4):
        jl_inc = (Ao[k][0] * jls[0] * inc_lm_obs[0]
                  + Ao[k][1] * jls[1] * inc_lm_obs[1]
                  + Ao[k][2] * jls[2] * inc_lm_obs[2]) * sw
        j_inc = torch.where(live, jp_inc[k] + jl_inc, zero)
        ld = ld + j_inc * (0.5 * j_inc + r_w[k])
    return ld.sum(dtype=torch.float64)


def _jp_inc_stored(q, x, u, v, sw, c):
    """Jp_s inc [4][O] from the STORED scaled Jacobians, q = (ps . inc)
    gathered per observation [12, O]: sw [sp (q~0 - u q~2),
    sp (q~1 - v q~2), sa q~0, sa q~1] with q~a = sum_j q[4a+j] xh_j."""
    qt = []
    for a in range(3):
        acc = q[4 * a + 3]
        for j in range(3):
            acc = acc + x[j] * q[4 * a + j]
        qt.append(acc)
    return [
        sw * c.sp * (qt[0] - u * qt[2]),
        sw * c.sp * (qt[1] - v * qt[2]),
        sw * c.sa * qt[0],
        sw * c.sa * qt[1],
    ]


def poba_t3(cam, cam_table, x, uv, sw_a, r_w, jls, z_table, *, alpha):
    """t3 [3, O] = Jl_s^T (r_w + Jp_s inc): the per-observation right-
    hand side of the POWER_SCHUR_COMPLEMENT landmark system
    (back_substitute_poBA, sc/landmark_block.hpp:625-668), slot-summed by
    the caller. z_table [12, N] = pose_scale . inc, the scaled camera
    increment; jls [3, O] the landmark Jacobi scale."""
    c = pose_consts(alpha, x.dtype)
    cl = cam.long()
    u, v = uv[0], uv[1]
    sw = sw_a[0]
    jp_inc = _jp_inc_stored(z_table[:, cl], x, u, v, sw, c)
    A = _a_tilde(cam_table[:, cl], u, v, c.sp, c.sa)
    rows = []
    for i in range(3):
        acc = A[0][i] * (r_w[0] + jp_inc[0])
        for k in range(1, 4):
            acc = acc + A[k][i] * (r_w[k] + jp_inc[k])
        rows.append(acc * sw * jls[i])
    return torch.stack(rows)


def apply_ldiff_stored(cam, x, uv, sw_a, r_w, jls, inc_lm_obs, cam_table_old,
                       z_table, *, alpha):
    """-l_diff (f64 scalar) of the POWER_SCHUR_COMPLEMENT apply, from the
    STORED scaled Jacobians (back_substitute_poBA):
      j_inc  = Jp_s inc + Jl_s inc_lm_scaled
      -l_diff = sum j_inc . (0.5 j_inc + r_w)
    with z_table = pose_scale . inc and inc_lm_obs the SCALED landmark
    increment expanded to observations. Unlike `apply_ldiff` there is no
    live mask: a dead row (sw = 0) has zero Jacobians and contributes
    zero through them."""
    c = pose_consts(alpha, x.dtype)
    cl = cam.long()
    u, v = uv[0], uv[1]
    sw = sw_a[0]
    jp_inc = _jp_inc_stored(z_table[:, cl], x, u, v, sw, c)
    Ao = _a_tilde(cam_table_old[:, cl], u, v, c.sp, c.sa)
    ld = torch.zeros_like(u)
    for k in range(4):
        jl_inc = (Ao[k][0] * jls[0] * inc_lm_obs[0]
                  + Ao[k][1] * jls[1] * inc_lm_obs[1]
                  + Ao[k][2] * jls[2] * inc_lm_obs[2]) * sw
        j_inc = jp_inc[k] + jl_inc
        ld = ld + j_inc * (0.5 * j_inc + r_w[k])
    return ld.sum(dtype=torch.float64)


def robust_error(res_sq, robust: int, huber: float):
    """Per-observation robust cost (compute_error_weight,
    helper.cpp:50-74): NONE 0.5 r^2; HUBER 0.5 (2 - w) w r^2 with
    w = 1 if r^2 < t^2 else t/|r|; CAUCHY log(1 + r^2)."""
    return pose_math.robust_error_and_weight(res_sq, robust, huber)[0]


def pose_error(cam, cam_table, x, uv, mask, *, alpha, robust, huber):
    """pOSE cost (compute_error_pOSE, helper.cpp:116-154) in the dtype
    of the inputs (f64 on the solver's path). Returns 0-d tensors
    (sum of robust costs, sum of residual norms, non-finite row count
    as int32) over live rows (mask [1, O] > 0)."""
    c = pose_consts(alpha, x.dtype)
    P = cam_table[:, cam.long()]
    u, v = uv[0], uv[1]
    xh = [x[0], x[1], x[2], torch.ones_like(u)]
    live = mask[0] > 0
    zero = _zero(x)
    r = _residual(_a_tilde(P, u, v, c.sp, c.sa), xh, u, v, c.sa)
    r = [torch.where(live, rk, zero) for rk in r]
    finite = torch.stack([torch.isfinite(rk) for rk in r]).all(dim=0)
    res_sq = r[0] * r[0] + r[1] * r[1] + r[2] * r[2] + r[3] * r[3]
    err = torch.where(live, robust_error(res_sq, robust, huber), zero)
    return (
        err.sum(),
        torch.sqrt(res_sq).sum(),
        (~finite).sum().to(torch.int32),
    )

"""Plain PyTorch versions of the eight step-2 structured kernels.

The counterpart of the step-2 half of povar_tpu/ops/xla_pose.py (the
dtype-generic mirrors of the Pallas bodies in povar_tpu/ops/
pallas_pose2.py) plus the homogeneous cost of `stage2._compute_error`'s
f64 path (stage2.py:461-494). Each function computes, term for term and
in the Pallas body's operation order, what its hand-written CUDA kernel
in csrc/pose2.cu computes:

  prepare2     projection, residual, robust weight, the projection cache
               mm = (mx, my, 1/p2), weighted raw Jl rows and their column
               norms^2, per-camera Jp column norms^2
  hppb2        per-camera raw Hpp12 and b12 in the unprojected frame
  mat_dot2     M^T (jp_x (+ r_w)) per observation through the zt table
  scatter2     per-camera sums of sw/p2 (C^T (M sb)) (x) x4
  e0_term2_parts  the fused tangent power-series term: mat_dot2, the
               per-landmark slot sum and scatter2 in one pass
  schur_diag2  per-camera tangent Schur-Jacobi corrections
               (sw/p2)^2 C^T B B^T C (x) x4 x4^T
  ldiff2       -l_diff, the model-cost decrease of the step-2 apply
  pose_error2  the homogeneous cost: all and valid buckets, counts

ops/pose2_kernels.py calls these for tensors on the CPU (the tests) and
chip_smoke.py holds each CUDA kernel against them on the card. Layouts
are the JAX package's, observation last: camera tables [12, N]
(row-major vec(P) per camera), per-observation rows [k, O].

The homogeneous residual (bal_bundle_adjustment_helper.cpp:315-380) has
Kronecker structure:

  p  = P x4,  m = (p0/p2, p1/p2),  r = m - uv
  Jp = (1/p2) C (x) x4^T,   C = [[1, 0, -mx], [0, 1, -my]]
  Jl = (1/p2) [P0 - mx P2; P1 - my P2]

so every per-observation quantity derives from the camera row P, the
homogeneous landmark x4 and the cached mm. Projection validity is
|p2| >= 1e-5 (Sophus epsilonSqrt of the f64 solve, bal_camera.hpp:147).
"""

from __future__ import annotations

from typing import Dict

import torch

from povar_tpu_torch.ops.pose_math import ROBUST_HUBER
from povar_tpu_torch.ops.pose_ref import (
    _scatter,
    _zero,
    robust_error,
)

# projection validity threshold |p2| >= EPS_SQRT, and the magnitude
# below which 1/p2 is taken at +-TINY instead (pallas_pose2.py:99-109)
EPS_SQRT = 1e-5
TINY = 1e-30


def _x4_rows(x4):
    return [x4[0], x4[1], x4[2], x4[3]]


def _q_tilde(zc, x4):
    """q~_a = sum_c x4_c zc[4a+c] (zc: a [12, N] table gathered to
    observations)."""
    q = []
    for a in range(3):
        acc = zc[4 * a] * x4[0]
        for c in range(1, 4):
            acc = acc + zc[4 * a + c] * x4[c]
        q.append(acc)
    return q


def prepare2(cam, cam_table, x4_a, uv, mask, *, use_valid, robust, huber):
    """Linearization-point pass. Returns (r_w [2,O], sw [1,O], mm [3,O]
    = (mx, my, 1/p2) on live rows, jlw [8,O] weighted unscaled Jl rows
    (r*4+c), jlsq [4,O] Jl column norms^2, jpsq [12,N] per-camera Jp
    column norms^2). `use_valid` drops projection-invalid rows as dead
    rows (landmark_block.hpp:203-222)."""
    dt = x4_a.dtype
    P = cam_table[:, cam.long()]
    u, v = uv[0], uv[1]
    x4 = _x4_rows(x4_a)
    m = mask[0] > 0

    p = []
    for r in range(3):
        acc = P[4 * r] * x4[0]
        for c in range(1, 4):
            acc = acc + P[4 * r + c] * x4[c]
        p.append(acc)
    valid = p[2].abs() >= EPS_SQRT
    tiny = torch.tensor(TINY, dtype=dt, device=x4_a.device)
    zinv = 1.0 / torch.where(
        p[2].abs() < TINY, torch.where(p[2] < 0, -tiny, tiny), p[2]
    )
    mx = p[0] * zinv
    my = p[1] * zinv
    r0 = mx - u
    r1 = my - v
    live = m if not use_valid else (m & valid)
    livef = live.to(dt)

    res_sq = r0 * r0 + r1 * r1
    if robust == ROBUST_HUBER:
        h2 = float(torch.tensor(huber * huber, dtype=dt))
        w = torch.where(
            res_sq < h2,
            torch.ones_like(res_sq),
            huber / torch.sqrt(torch.clamp(res_sq, min=1e-30)),
        )
    else:
        w = torch.ones_like(res_sq)
    w = w * livef
    sw = torch.sqrt(w)

    r_w = torch.stack([r0 * sw, r1 * sw])
    mm = torch.stack([mx * livef, my * livef, zinv * livef])
    j0s, j1s, jlsq = [], [], []
    for c in range(4):
        j0 = sw * zinv * (P[c] - mx * P[8 + c])
        j1 = sw * zinv * (P[4 + c] - my * P[8 + c])
        j0s.append(j0)
        j1s.append(j1)
        jlsq.append(j0 * j0 + j1 * j1)

    # diag K = [1, 1, kd2]: rows 4-7 of jpsq are its rows 0-3, so 8 of
    # its 12 per-camera sums are distinct. On the card they are summed in
    # f64 and rounded once, as the kernel's block sums are: there an f32
    # index_add_ adds by atomics in a run-dependent order and loses the
    # low bits of each add to the camera's running sum. On the CPU they
    # stay f32 sums in row order, as the JAX package's.
    wz2 = w * zinv * zinv
    rows = [wk * x4[c] * x4[c]
            for wk in (wz2, wz2 * (mx * mx + my * my)) for c in range(4)]
    acc = torch.float64 if x4_a.is_cuda else dt
    jp8 = _scatter(torch.stack(rows).to(acc), cam,
                   cam_table.shape[-1]).to(dt)
    jpsq = torch.cat([jp8[:4], jp8])
    return (r_w, sw.reshape(1, -1), mm, torch.stack(j0s + j1s),
            torch.stack(jlsq), jpsq)


def hppb2(cam, x4_a, mm, sw_a, r_w, jlns, hib, n_cams):
    """(hpp12_raw [144, N], b12_raw [12, N]) in the unprojected 12-dof
    frame (rows (4a+i)*12 + 4b+j and 4a+c); the caller folds Kps:
      rt       = r_w - Jl_ns hib           (jlns [6,O] rows r*3+i)
      b12_raw  = seg_cam( sw/p2 (C^T rt) (x) x4 )
      hpp12raw = seg_cam( w/p2^2 K3 (x) x4 x4^T ),
    K3 = [[1, 0, -mx], [0, 1, -my], [-mx, -my, mx^2 + my^2]]."""
    mx, my, zinv = mm[0], mm[1], mm[2]
    sw = sw_a[0]
    x4 = _x4_rows(x4_a)
    rt = []
    for r in range(2):
        corr = (jlns[r * 3 + 0] * hib[0] + jlns[r * 3 + 1] * hib[1]
                + jlns[r * 3 + 2] * hib[2])
        rt.append(r_w[r] - corr)
    swz = sw * zinv
    ctr = [rt[0], rt[1], -(mx * rt[0] + my * rt[1])]
    b = _scatter(
        torch.stack([swz * ctr[a] * x4[c] for a in range(3) for c in range(4)]),
        cam, n_cams,
    )
    wz2 = swz * swz
    one, zero = torch.ones_like(mx), torch.zeros_like(mx)
    K3 = [[one, zero, -mx],
          [zero, one, -my],
          [-mx, -my, mx * mx + my * my]]
    rows = []
    for a in range(3):
        for i in range(4):
            wk = wz2 * x4[i]
            for bb in range(3):
                for j in range(4):
                    rows.append(wk * K3[a][bb] * x4[j])
    hpp = _scatter(torch.stack(rows), cam, n_cams)
    return hpp, b


def mat_dot2(cam, x4_a, mm, sw_a, mat6, r_w, zt, *, add_r):
    """[3, O] = M^T (jp_x (+ r_w)) with M [2, 3] per observation (mat6
    rows r*3+i), jp_x = sw/p2 [q~0 - mx q~2, q~1 - my q~2] and
    q~_a = sum_c x4_c zt[4a+c, cam]. r_w is read only when add_r."""
    zc = zt[:, cam.long()]
    mx, my, zinv = mm[0], mm[1], mm[2]
    sw = sw_a[0]
    q = _q_tilde(zc, _x4_rows(x4_a))
    swz = sw * zinv
    jx0 = swz * (q[0] - mx * q[2])
    jx1 = swz * (q[1] - my * q[2])
    if add_r:
        jx0 = jx0 + r_w[0]
        jx1 = jx1 + r_w[1]
    return torch.stack([mat6[i] * jx0 + mat6[3 + i] * jx1 for i in range(3)])


def scatter2(cam, x4_a, mm, sw_a, mat6, sb, n_cams):
    """[12, N] raw per-camera sums of sw/p2 (C^T (M sb)) (x) x4; the
    caller folds Kps^T."""
    mx, my, zinv = mm[0], mm[1], mm[2]
    sw = sw_a[0]
    x4 = _x4_rows(x4_a)
    v0 = mat6[0] * sb[0] + mat6[1] * sb[1] + mat6[2] * sb[2]
    v1 = mat6[3] * sb[0] + mat6[4] * sb[1] + mat6[5] * sb[2]
    swz = sw * zinv
    ctv = [swz * v0, swz * v1, -swz * (mx * v0 + my * v1)]
    rows = torch.stack([ctv[a] * x4[c] for a in range(3) for c in range(4)])
    return _scatter(rows, cam, n_cams)


def e0_term2_parts(cam, x4_a, mm, sw_a, mat6, zt, parts, n_cams):
    """The fused tangent power-series term: [12, N] raw per-camera sums
    of sw/p2 (C^T (M sb)) (x) x4 with sb = seg_lm( M^T jp_x ), jp_x =
    sw/p2 [q~0 - mx q~2, q~1 - my q~2] through the zt table, over the
    slot parts `parts` (layout as pose_ref.e0_term_parts). sb sums over
    j = 0..w-1 in order; the caller folds Kps^T."""
    rows, cams = [], []
    for ofs, g, w in parts:
        sl = slice(ofs, ofs + g * w)
        c2 = cam[sl].long()
        x4 = list(x4_a[:, sl].reshape(4, w, g))
        mx, my, zinv = mm[:, sl].reshape(3, w, g)
        mat = mat6[:, sl].reshape(6, w, g)
        swz = sw_a[0, sl].reshape(w, g) * zinv
        q = _q_tilde(zt[:, c2].reshape(12, w, g), x4)
        jx0 = swz * (q[0] - mx * q[2])
        jx1 = swz * (q[1] - my * q[2])
        u = [mat[i] * jx0 + mat[3 + i] * jx1 for i in range(3)]
        sb = []
        for i in range(3):
            acc = u[i][0]
            for j in range(1, w):
                acc = acc + u[i][j]
            sb.append(acc)
        v0 = mat[0] * sb[0] + mat[1] * sb[1] + mat[2] * sb[2]
        v1 = mat[3] * sb[0] + mat[4] * sb[1] + mat[5] * sb[2]
        ctv = [swz * v0, swz * v1, -swz * (mx * v0 + my * v1)]
        rows.append(torch.stack([
            ctv[a] * x4[c] for a in range(3) for c in range(4)
        ]).reshape(12, g * w))
        cams.append(c2)
    return _scatter(torch.cat(rows, dim=1), torch.cat(cams), n_cams)


def schur_diag2(cam, x4_a, mm, sw_a, mat6, n_cams):
    """corr12_raw [144, N] = seg_cam( H (x) x4 x4^T ), rows
    ((a*4+i)*3+b)*4+j, H = (sw/p2)^2 C^T (B B^T) C with B [2, 3] per
    observation in mat6 (rows r*3+i) and C = [[1, 0, -mx], [0, 1, -my]]:
    the tangent Schur-Jacobi corrections of RIPCG; the caller folds
    Kps^T . Kps and subtracts them from the damped Hpp."""
    mx, my, zinv = mm[0], mm[1], mm[2]
    sw = sw_a[0]
    m = mat6
    x4 = _x4_rows(x4_a)
    g00 = m[0] * m[0] + m[1] * m[1] + m[2] * m[2]
    g11 = m[3] * m[3] + m[4] * m[4] + m[5] * m[5]
    g01 = m[0] * m[3] + m[1] * m[4] + m[2] * m[5]
    swz = sw * zinv
    wz2 = swz * swz
    cg = [[g00, g01], [g01, g11],
          [-(mx * g00 + my * g01), -(mx * g01 + my * g11)]]
    one, zero = torch.ones_like(mx), torch.zeros_like(mx)
    cc = [[one, zero], [zero, one], [-mx, -my]]
    H = [[wz2 * (cg[a][0] * cc[b][0] + cg[a][1] * cc[b][1])
          for b in range(3)] for a in range(3)]
    rows = [H[a][b] * x4[i] * x4[j]
            for a in range(3) for i in range(4)
            for b in range(3) for j in range(4)]
    return _scatter(torch.stack(rows), cam, n_cams)


def ldiff2(cam, x4_a, mm, sw_a, r_w, jls8, ilm4, zt):
    """-l_diff (f64 scalar) of the joint apply (back_substitute_joint,
    landmark_block.hpp:574-623):
      j_inc   = Jp_ns inc + Jl_s inc_proj   (zt = Kps inc per camera)
      -l_diff = sum j_inc . (0.5 j_inc + r_w)
    with per-observation terms in the working dtype and the sum in f64."""
    zc = zt[:, cam.long()]
    mx, my, zinv = mm[0], mm[1], mm[2]
    sw = sw_a[0]
    q = _q_tilde(zc, _x4_rows(x4_a))
    swz = sw * zinv
    jp = [swz * (q[0] - mx * q[2]), swz * (q[1] - my * q[2])]
    ld = torch.zeros_like(mx)
    for r in range(2):
        jl_inc = (jls8[r * 4 + 0] * ilm4[0] + jls8[r * 4 + 1] * ilm4[1]
                  + jls8[r * 4 + 2] * ilm4[2] + jls8[r * 4 + 3] * ilm4[3])
        j_inc = jp[r] + jl_inc
        ld = ld + j_inc * (0.5 * j_inc + r_w[r])
    return ld.sum(dtype=torch.float64)


def pose_error2(cam, cam_table, x4_a, uv, mask, *, robust, huber
                ) -> Dict[str, torch.Tensor]:
    """compute_error_projective_space_homogeneous (helper.cpp:156-196)
    in the dtype of the inputs (f64 on the solver's path), as
    `stage2._compute_error` evaluates it without double-float. Returns
    the seven keys of a ResidualInfo dict as 0-d tensors: rows with
    mask [1, O] <= 0 are dead (zero residual, never invalid or
    non-finite); `valid` is |p2| >= 1e-5 on live rows."""
    P = cam_table[:, cam.long()]
    x4 = _x4_rows(x4_a)
    live = mask[0] > 0
    zero = _zero(x4_a)
    p = []
    for r in range(3):
        acc = P[4 * r] * x4[0]
        for c in range(1, 4):
            acc = acc + P[4 * r + c] * x4[c]
        p.append(acc)
    r = [torch.where(live, p[0] / p[2] - uv[0], zero),
         torch.where(live, p[1] / p[2] - uv[1], zero)]
    valid = (p[2].abs() >= EPS_SQRT) & live
    finite = torch.isfinite(r[0]) & torch.isfinite(r[1])
    res_sq = r[0] * r[0] + r[1] * r[1]
    err = torch.where(live, robust_error(res_sq, robust, huber), zero)
    rn = torch.sqrt(res_sq)
    validf = valid.to(err.dtype)
    return {
        "num_obs_all": live.to(torch.int64).sum(),
        "error_all": err.sum(),
        "residual_sum_all": rn.sum(),
        "num_obs_valid": valid.to(torch.int64).sum(),
        "error_valid": (err * validf).sum(),
        "residual_sum_valid": (rn * validf).sum(),
        "is_numerically_valid": (~finite).sum() == 0,
    }


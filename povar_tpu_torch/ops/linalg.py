"""Small batched linear algebra on batch-last tensors.

The counterpart of the front-indexed ("batch-last") half of
povar_tpu/ops/linalg.py: matrix dims are the FIRST two axes, the batch
axis is last ([3, 3, M] landmark blocks, [12, 12, N] camera blocks).
Every function is the same elementwise algorithm as its JAX
counterpart, written out over [batch] vectors, so both packages round
the same operations in the same order.

These replace, in the reference implementation:
  - Eigen `Mat3::inverse()` (adjugate)      -> inv3x3f
  - per-camera 12x12 `selfadjointView<Upper>().llt().solve(I)`
    (sc/linearization_power_varproj.hpp:141-188) -> cholesky_smallf /
    inv_psd_smallf
  - the dense reduced camera system's direct solve of CHOLESKY
    (linearization_sc.hpp:236-245) -> solve_psd_dense (a library
    Cholesky: the JAX package computes it outside any Pallas kernel)
  - the step-2 tangent bases `kernel_COD` (sc/landmark_block.hpp:
    227-269) -> nullspace_of_rowf
  - Eigen `Matrix::normalize()` of the step-2 camera retraction
    (bal_bundle_adjustment.cpp:700-702) -> frobenius_normalize
"""

from __future__ import annotations

import torch


def _pow2_norm(s: torch.Tensor) -> torch.Tensor:
    """Exact power-of-two magnitude normalizer: 2^floor(log2(s)), or 1
    where s is zero/non-finite. Dividing a matrix by it is EXACT in
    IEEE arithmetic (mantissas unchanged), so prescaling the adjugate
    inverse below changes no bits in the normal range — it only
    prevents the cofactor (~|m|^2) and determinant (~|m|^3) products
    from overflowing the f32 exponent when the matrix carries a huge
    LM damping term (lambda > ~1.8e19 => lambda^2 > f32 max; the
    post-convergence backtracking spiral reaches lambda ~ 1e32 before
    the trust-region floor terminates, bal_bundle_adjustment.cpp
    min radius 1e-32). frexp gives s = m 2^e with m in [0.5, 1), so
    2^(e-1) is the normalizer without a rounded log2."""
    ok = torch.isfinite(s) & (s > 0)
    _m, e = torch.frexp(torch.where(ok, s, torch.ones_like(s)))
    p = torch.ldexp(torch.ones_like(s), e - 1)
    return torch.where(ok, p, torch.ones_like(s))


def inv3x3f(m: torch.Tensor) -> torch.Tensor:
    """Adjugate 3x3 inverse of m [3, 3, ...] -> [3, 3, ...], with
    exact power-of-two prescaling for f32 exponent headroom
    (see _pow2_norm)."""
    scale = _pow2_norm(m.abs().amax(dim=(0, 1)))
    m = m / scale[None, None]
    a, b, c = m[0, 0], m[0, 1], m[0, 2]
    d, e, f = m[1, 0], m[1, 1], m[1, 2]
    g, h, i = m[2, 0], m[2, 1], m[2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    inv_det = 1.0 / (a * co_a + b * co_b + c * co_c)
    adj = torch.stack(
        [
            torch.stack([co_a, c * h - b * i, b * f - c * e], dim=0),
            torch.stack([co_b, a * i - c * g, c * d - a * f], dim=0),
            torch.stack([co_c, b * g - a * h, a * e - b * d], dim=0),
        ],
        dim=0,
    )
    return adj * (inv_det / scale)[None, None]


def solve3x3f(m: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve m @ x = rhs with m [3,3,...], rhs [3,...] -> [3,...]."""
    return (inv3x3f(m) * rhs[None]).sum(dim=1)


def cholesky_smallf(a: torch.Tensor) -> torch.Tensor:
    """Cholesky of a [n, n, ...] SPD batch-last array, n static."""
    n = a.shape[0]
    zero = torch.zeros_like(a[0, 0])
    rows = [[zero] * n for _ in range(n)]
    for j in range(n):
        s = sum(rows[j][k] * rows[j][k] for k in range(j)) if j else 0.0
        d = torch.sqrt(a[j, j] - s)
        rows[j][j] = d
        for i in range(j + 1, n):
            s2 = sum(rows[i][k] * rows[j][k] for k in range(j)) if j else 0.0
            rows[i][j] = (a[i, j] - s2) / d
    return torch.stack([torch.stack(r, dim=0) for r in rows], dim=0)


def solve_lower_trif(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve l @ x = b with l [n,n,...] lower-tri, b [n,...]; b may
    carry extra leading right-hand-side axes after its first
    (broadcast against l's batch)."""
    n = l.shape[0]
    x = [None] * n
    for i in range(n):
        s = sum(l[i, k] * x[k] for k in range(i)) if i else 0.0
        x[i] = (b[i] - s) / l[i, i]
    return torch.stack(x, dim=0)


def solve_upper_from_lowerf(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve l.T @ x = b with l [n,n,...] lower-tri, b [n,...]."""
    n = l.shape[0]
    x = [None] * n
    for i in reversed(range(n)):
        s = (
            sum(l[k, i] * x[k] for k in range(i + 1, n))
            if i + 1 < n
            else 0.0
        )
        x[i] = (b[i] - s) / l[i, i]
    return torch.stack(x, dim=0)


def inv_psd_smallf(a: torch.Tensor) -> torch.Tensor:
    """SPD inverse of a [n, n, ...] batch-last array: one Cholesky and
    the two triangular solves against the identity. All n unit columns
    go through each solve at once (the right-hand sides ride the second
    axis); every element sees the same operations in the same order as
    the JAX package's column-by-column loop, in n times fewer launches."""
    n = a.shape[0]
    l = cholesky_smallf(a)
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    e = eye.reshape((n, n) + (1,) * (a.ndim - 2)).expand(a.shape)
    return solve_upper_from_lowerf(l, solve_lower_trif(l, e))


def solve_psd_dense(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a x = b for one dense SPD matrix a [n, n] and b [n] (the
    CHOLESKY path's reduced camera system; `solve_psd_small` of the JAX
    package, a hand-rolled Cholesky outside any Pallas kernel). A matrix
    that is not positive definite in its dtype yields an all-NaN x, as
    the JAX package's square root of a negative pivot does, so the LM
    loop rejects the step instead of failing."""
    l, info = torch.linalg.cholesky_ex(a)
    x = torch.cholesky_solve(b[:, None], l)[:, 0]
    return torch.where(info == 0, x, torch.full_like(x, float("nan")))


def nullspace_of_rowf(v: torch.Tensor) -> torch.Tensor:
    """Householder nullspace basis of v [n, ...] -> [n, n-1, ...]:
    columns 1..n-1 of I - beta w w^T with w = v + sign(v0) |v| e0 and
    beta = 2 / |w|^2. This exact basis (not merely the same subspace)
    is what the JAX package uses: another orthonormal basis changes the
    f32 rounding of every tangent quantity, and with it the step-2
    trajectory."""
    n = v.shape[0]
    norm = torch.sqrt((v * v).sum(dim=0, keepdim=True))
    one = torch.ones_like(v[:1])
    sign0 = torch.where(v[:1] >= 0, one, -one)
    w = torch.cat([v[:1] + sign0 * norm, v[1:]], dim=0)
    beta = 2.0 / (w * w).sum(dim=0)
    h_cols = -beta[None, None] * w[:, None] * w[None, 1:]
    eye_cols = torch.eye(n, dtype=v.dtype, device=v.device)[:, 1:].reshape(
        (n, n - 1) + (1,) * (v.ndim - 1)
    )
    return h_cols + eye_cols


def frobenius_normalize(m: torch.Tensor) -> torch.Tensor:
    """Normalize over the last two axes (the step-2 camera retraction:
    each [3, 4] matrix divided by its Frobenius norm)."""
    norm = torch.sqrt((m * m).sum(dim=(-2, -1), keepdim=True))
    return m / norm

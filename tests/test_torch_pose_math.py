"""The Jacobians of povar_tpu_torch/ops/pose_math.py: against the JAX
package's observation-last functions (povar_tpu/ops/pose_math.py) on the
same seeded numpy inputs, in f64 and f32, and the finite-difference and
consistency checks of tests/test_pose_math.py run on the port.

Tolerances: f64 1e-12 relative to each output's largest magnitude (the
same operations, another summation order in the 4-term contractions;
measured <= 2e-16), f32 1e-6 (measured <= 1.2e-7); the central
differences at the absolute tolerances of tests/test_pose_math.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from povar_tpu.ops import pose_math as jax_pose_math
from povar_tpu_torch.ops import pose_math

# one torch thread a test process: the CPU tests' tensors are small,
# and a parallel run's xdist workers share the host's cores
torch.set_num_threads(1)

ALPHA = 0.01
O = 257
TOLS = {np.float64: 1e-12, np.float32: 1e-6}


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _batch(dtype, seed=0):
    """Seeded observation-last inputs: P [3, 4, O], x [3, O], xh [4, O]
    with p2 = (P xh)[2] in [2, 6] (a well-conditioned projection), uv."""
    rng = np.random.default_rng(seed)
    P = rng.standard_normal((3, 4, O))
    x = rng.standard_normal((3, O))
    xh = np.concatenate([x, rng.uniform(0.5, 1.5, (1, O))])
    p2 = (P[2] * xh).sum(axis=0)
    P[2, 3] += (rng.uniform(2.0, 6.0, O) - p2) / xh[3]
    uv = rng.standard_normal((2, O))
    return [a.astype(dtype) for a in (P, x, xh, uv)]


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_pose_jacobians_match_jax(dtype):
    P, x, _xh, uv = _batch(dtype)
    got = pose_math.pose_jacobians_t(*map(torch.as_tensor, (P, x, uv)), ALPHA)
    want = jax_pose_math.pose_jacobians_t(*map(jnp.asarray, (P, x, uv)),
                                          ALPHA)
    for g, w in zip(got, want):
        assert g.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
        _close(g.numpy(), w, TOLS[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_varproj_init_normal_eq_matches_jax(dtype):
    P, _x, _xh, uv = _batch(dtype, seed=1)
    got = pose_math.varproj_init_normal_eq_t(torch.as_tensor(P),
                                             torch.as_tensor(uv), ALPHA)
    want = jax_pose_math.varproj_init_normal_eq_t(jnp.asarray(P),
                                                  jnp.asarray(uv), ALPHA)
    assert tuple(got[0].shape) == (3, 3, O) and tuple(got[1].shape) == (3, O)
    for g, w in zip(got, want):
        _close(g.numpy(), w, TOLS[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_homogeneous_jacobians_match_jax(dtype):
    P, _x, xh, uv = _batch(dtype, seed=2)
    got = pose_math.homogeneous_jacobians_t(*map(torch.as_tensor, (P, xh, uv)))
    want = jax_pose_math.homogeneous_jacobians_t(*map(jnp.asarray,
                                                      (P, xh, uv)))
    for g, w in zip(got[:3], want[:3]):
        _close(g.numpy(), w, TOLS[dtype])
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


# ---- tests/test_pose_math.py's checks on the port (one observation)


def _central_diff(f, x0, eps=1e-7):
    x0 = np.asarray(x0, dtype=np.float64)
    f0 = np.asarray(f(x0))
    jac = np.zeros(f0.shape + x0.shape)
    for idx in np.ndindex(x0.shape):
        xp, xm = x0.copy(), x0.copy()
        xp[idx] += eps
        xm[idx] -= eps
        jac[(...,) + idx] = (np.asarray(f(xp)) - np.asarray(f(xm))) / (2 * eps)
    return jac


def _setup(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((3, 4)), rng.standard_normal(3),
            rng.standard_normal(2))


def _t(P, v, uv):
    """One observation as observation-last f64 tensors."""
    return (torch.as_tensor(P)[..., None], torch.as_tensor(v)[:, None],
            torch.as_tensor(uv)[:, None])


def test_pose_jacobian_wrt_landmark():
    P, x, uv = _setup(0)
    _r, _jp, jl = pose_math.pose_jacobians_t(*_t(P, x, uv), ALPHA)
    num = _central_diff(
        lambda xx: pose_math.pose_residual_t(*_t(P, xx, uv), ALPHA)[:, 0], x
    )
    np.testing.assert_allclose(jl[..., 0].numpy(), num, atol=1e-6)


def test_pose_jacobian_wrt_camera():
    P, x, uv = _setup(1)
    _r, jp, _jl = pose_math.pose_jacobians_t(*_t(P, x, uv), ALPHA)
    num = _central_diff(
        lambda p12: pose_math.pose_residual_t(*_t(p12.reshape(3, 4), x, uv),
                                              ALPHA)[:, 0],
        P.reshape(12),
    )
    np.testing.assert_allclose(jp[..., 0].numpy(), num, atol=1e-6)


def test_pose_residual_affine_in_landmark():
    P, x, uv = _setup(2)
    x2 = x + np.array([0.3, -0.2, 0.7])
    r1, _jp, jl = pose_math.pose_jacobians_t(*_t(P, x, uv), ALPHA)
    r2 = pose_math.pose_residual_t(*_t(P, x2, uv), ALPHA)
    np.testing.assert_allclose(
        r2[:, 0].numpy(), r1[:, 0].numpy() + jl[..., 0].numpy() @ (x2 - x),
        atol=1e-12,
    )


def test_homogeneous_jacobian_wrt_landmark():
    P, x, uv = _setup(3)
    xh = np.append(x, 1.3)
    _r, _jp, jl, _v = pose_math.homogeneous_jacobians_t(*_t(P, xh, uv))
    num = _central_diff(
        lambda xx: pose_math.homogeneous_residual_t(*_t(P, xx, uv))[0][:, 0],
        xh,
    )
    np.testing.assert_allclose(jl[..., 0].numpy(), num, atol=1e-5)


def test_homogeneous_jacobian_wrt_camera():
    P, x, uv = _setup(4)
    xh = np.append(x, 0.8)
    _r, jp, _jl, _v = pose_math.homogeneous_jacobians_t(*_t(P, xh, uv))
    num = _central_diff(
        lambda p12: pose_math.homogeneous_residual_t(
            *_t(p12.reshape(3, 4), xh, uv))[0][:, 0],
        P.reshape(12),
    )
    np.testing.assert_allclose(jp[..., 0].numpy(), num, atol=1e-5)


def test_homogeneous_jacobians_validity():
    P = np.zeros((3, 4))
    P[2, 2] = 1e-12  # z ~ 0: an invalid projection
    *_rest, valid = pose_math.homogeneous_jacobians_t(
        *_t(P, np.ones(4), np.zeros(2)))
    assert not bool(valid[0])


def test_varproj_init_single_obs_consistency():
    """r(x) = G x - z with (G^T G, G^T z) from varproj_init_normal_eq_t."""
    P, x, uv = _setup(5)
    gtg, gtz = pose_math.varproj_init_normal_eq_t(
        torch.as_tensor(P)[..., None], torch.as_tensor(uv)[:, None], ALPHA
    )
    A = pose_math.pose_matrix_tilde_t(torch.as_tensor(P)[..., None],
                                      torch.as_tensor(uv)[:, None],
                                      ALPHA)[..., 0].numpy()
    G = A[:, :3]
    r = pose_math.pose_residual_t(*_t(P, x, uv), ALPHA)[:, 0].numpy()
    z = G @ x - r
    np.testing.assert_allclose(gtg[..., 0].numpy(), G.T @ G, atol=1e-12)
    np.testing.assert_allclose(gtz[..., 0].numpy(), G.T @ z, atol=1e-12)

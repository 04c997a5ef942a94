"""povar_tpu_torch.ops.linalg against povar_tpu.ops.linalg on seeded
batch-last batches (the same numpy inputs to both).

The two packages run the same elementwise algorithms in the same order;
what can differ is FMA contraction by XLA's CPU compiler. Tolerances per
function, relative to the largest output magnitude: 1e-13 in f64 and
2e-6 in f32 (a few ulps; measured on these inputs: at most 6e-16 in f64
and 3e-7 in f32, the largest for the 12x12 SPD inverse).
Badly scaled 3x3 blocks (entries from 1e-30 to 1e30, the LM damping
spiral of the JAX package's _pow2_norm note) must come out finite and
equal in both packages: the power-of-two prescaling is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from povar_tpu.ops import linalg as jl
from povar_tpu_torch.ops import linalg as tl

# one torch thread a test process: the CPU tests' tensors are small,
# and a parallel run's xdist workers share the host's cores
torch.set_num_threads(1)

BATCH = 257


def _spd(rng, n, dtype, scale=1.0):
    a = rng.standard_normal((BATCH, n, n))
    m = a @ a.transpose(0, 2, 1) + n * np.eye(n)
    return (scale * m).transpose(1, 2, 0).astype(dtype)  # [n, n, B]


def _lower(rng, n, dtype):
    m = np.tril(rng.standard_normal((BATCH, n, n)), -1)
    m += np.eye(n) * rng.uniform(1.0, 2.0, (BATCH, 1, 1))
    return m.transpose(1, 2, 0).astype(dtype)


def _close(got, want, rtol):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=rtol * np.abs(want).max()
    )


RTOL = {np.float64: 1e-13, np.float32: 2e-6}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_inv3x3f(dtype):
    rng = np.random.default_rng(0)
    m = _spd(rng, 3, dtype) + rng.standard_normal((3, 3, BATCH)).astype(dtype)
    _close(tl.inv3x3f(torch.as_tensor(m)).numpy(), jl.inv3x3f(jnp.asarray(m)),
           RTOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("scale", [1e-30, 1e-12, 1e12, 1e30])
def test_inv3x3f_badly_scaled(dtype, scale):
    """Uniformly scaled blocks and blocks with a huge damping term on the
    diagonal: without the power-of-two prescaling the f32 cofactors
    overflow (scale^2 > 3.4e38) or underflow."""
    rng = np.random.default_rng(1)
    m = _spd(rng, 3, np.float64)
    damped = m + scale * np.eye(3)[:, :, None]
    for blk in (scale * m, damped):
        blk = blk.astype(dtype)
        got = tl.inv3x3f(torch.as_tensor(blk)).numpy()
        want = np.asarray(jl.inv3x3f(jnp.asarray(blk)))
        assert np.isfinite(want).all()
        _close(got, want, RTOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_solve3x3f(dtype):
    rng = np.random.default_rng(2)
    m = _spd(rng, 3, dtype)
    rhs = rng.standard_normal((3, BATCH)).astype(dtype)
    got = tl.solve3x3f(torch.as_tensor(m), torch.as_tensor(rhs)).numpy()
    _close(got, jl.solve3x3f(jnp.asarray(m), jnp.asarray(rhs)), RTOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n", [3, 12])
def test_cholesky_smallf(dtype, n):
    rng = np.random.default_rng(3 + n)
    a = _spd(rng, n, dtype)
    got = tl.cholesky_smallf(torch.as_tensor(a)).numpy()
    _close(got, jl.cholesky_smallf(jnp.asarray(a)), RTOL[dtype])
    assert (np.triu(got.transpose(2, 0, 1), 1) == 0).all()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_inv_psd_smallf(dtype):
    rng = np.random.default_rng(4)
    a = _spd(rng, 12, dtype)
    got = tl.inv_psd_smallf(torch.as_tensor(a)).numpy()
    want = jl.inv_psd_smallf(jnp.asarray(a))
    _close(got, want, RTOL[dtype])
    if dtype == np.float64:
        eye = np.einsum("ijb,jkb->ikb", got, a.astype(np.float64))
        np.testing.assert_allclose(
            eye, np.broadcast_to(np.eye(12)[:, :, None], eye.shape),
            atol=1e-10,
        )


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n", [3, 12])
def test_triangular_solves(dtype, n):
    rng = np.random.default_rng(5 + n)
    lo = _lower(rng, n, dtype)
    b = rng.standard_normal((n, BATCH)).astype(dtype)
    tlo, tb = torch.as_tensor(lo), torch.as_tensor(b)
    jlo, jb = jnp.asarray(lo), jnp.asarray(b)
    _close(tl.solve_lower_trif(tlo, tb).numpy(),
           jl.solve_lower_trif(jlo, jb), RTOL[dtype])
    _close(tl.solve_upper_from_lowerf(tlo, tb).numpy(),
           jl.solve_upper_from_lowerf(jlo, jb), RTOL[dtype])

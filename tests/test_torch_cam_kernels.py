"""The camera-table functions of povar_tpu_torch (ops/cam_kernels.py on
CPU tensors, i.e. their plain versions in ops/cam_ref.py) against
povar_tpu/ops/pallas_cam.py's Pallas kernels in interpret mode, on the
same seeded numpy inputs: O = 8192 observations (one OBS_PAD), N = 7 and
89 cameras, `cam_scatter_add` at R = 12, 121 and 144 rows as drawn and
sorted by camera, both factorized-operand shapes (dl, dc) = (3, 12) of step 1
and (3, 11) of step 2, and both Jacobian shapes (k, d) = (4, 12) and
(2, 11) of `hpp_b`. About 5% of the rows are dead (zero operands, as the
solvers' slot pad rows are).

Tolerances, with the scales of povar_tpu_torch/tools/parity.py: the
elementwise `e0_u` 2e-6 entry by entry (both sum dc products in f32, in
different orders; measured <= 5.8e-7); per-camera sums 1e-5 camera by
camera (a camera sums ~1,200 observations at N = 7 in f32, the TPU
kernels per tile and the plain versions in observation order; measured
<= 1.4e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from povar_tpu.ops import pallas_cam
from povar_tpu_torch.ops import cam_kernels, launches
from povar_tpu_torch.tools.parity import scaled_error

# one torch thread a test process: the CPU tests' tensors are small,
# and a parallel run's xdist workers share the host's cores
torch.set_num_threads(1)

O = 8192
TOLS = {"elem": 2e-6, "cam": 1e-5}


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors go to the plain versions: no kernel launch counted."""
    launches.reset_launch_counts()
    yield
    counts = launches.launch_counts()
    assert len(counts) == 52 and not any(counts.values()), counts


def _inputs(n, rows, seed):
    """cam [O] over n cameras, a live mask, and `rows` seeded [r, O] f32
    operands (dead rows zeroed) plus an [r, N] table per entry of
    `rows` given as (r, 'n')."""
    rng = np.random.default_rng(seed)
    cam = rng.integers(0, n, O).astype(np.int32)
    live = (rng.uniform(size=O) > 0.05).astype(np.float32)
    out = []
    for r in rows:
        if isinstance(r, tuple):
            out.append(rng.standard_normal((r[0], n)).astype(np.float32))
        else:
            out.append((rng.standard_normal((r, O)) * live).astype(np.float32))
    return cam, out


def _check(got, want, kind):
    err = scaled_error(got, torch.as_tensor(np.array(want)), kind)
    assert err <= TOLS[kind], err


@pytest.mark.parametrize("n", [7, 89])
@pytest.mark.parametrize("r, order", [
    pytest.param(r, order, id=f"{r}" if order == "drawn" else f"{r}-{order}")
    for order in ("drawn", "by_camera") for r in (12, 144, 121)])
def test_cam_scatter_add(n, r, order):
    """The step-1 Jacobi norms' 12 rows and the Schur corrections' 144 /
    121, on the rows as drawn and sorted by camera."""
    cam, (v,) = _inputs(n, [r], seed=n + r)
    if order == "by_camera":
        rows = np.argsort(cam, kind="stable")
        cam, v = cam[rows], np.ascontiguousarray(v[:, rows])
    want = pallas_cam.cam_scatter_add(jnp.asarray(v), jnp.asarray(cam), n)
    got = cam_kernels.cam_scatter_add(torch.as_tensor(v), torch.as_tensor(cam),
                                      n)
    assert got.dtype == torch.float32 and tuple(got.shape) == (r, n)
    _check(got, want, "cam")


@pytest.mark.parametrize("n", [7, 89])
@pytest.mark.parametrize("dc", [12, 11])
def test_e0_u(n, dc):
    cam, (w, x) = _inputs(n, [3 * dc, (dc, "n")], seed=3 * n + dc)
    want = pallas_cam.e0_u(jnp.asarray(w), jnp.asarray(cam), jnp.asarray(x))
    got = cam_kernels.e0_u(torch.as_tensor(w), torch.as_tensor(cam),
                           torch.as_tensor(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, O)
    _check(got, want, "elem")
    # dead rows (W zero) give exactly zero
    dead = ~w.any(axis=0)
    assert dead.any() and not got.numpy()[:, dead].any()


@pytest.mark.parametrize("n", [7, 89])
@pytest.mark.parametrize("dc", [12, 11])
def test_e0_scatter(n, dc):
    cam, (w, sb) = _inputs(n, [3 * dc, 3], seed=5 * n + dc)
    want = pallas_cam.e0_scatter(jnp.asarray(w), jnp.asarray(cam),
                                 jnp.asarray(sb), n)
    got = cam_kernels.e0_scatter(torch.as_tensor(w), torch.as_tensor(cam),
                                 torch.as_tensor(sb), n)
    assert got.dtype == torch.float32 and tuple(got.shape) == (dc, n)
    _check(got, want, "cam")


@pytest.mark.parametrize("n", [7, 89])
@pytest.mark.parametrize("k, d", [(4, 12), (2, 11)])
def test_hpp_b(n, k, d):
    cam, (jp, rt) = _inputs(n, [k * d, k], seed=7 * n + d)
    want_h, want_b = pallas_cam.hpp_b(jnp.asarray(jp), jnp.asarray(rt),
                                      jnp.asarray(cam), n)
    got_h, got_b = cam_kernels.hpp_b(torch.as_tensor(jp), torch.as_tensor(rt),
                                     torch.as_tensor(cam), n)
    assert tuple(got_h.shape) == (d * d, n) and tuple(got_b.shape) == (d, n)
    _check(got_h, want_h, "cam")
    _check(got_b, want_b, "cam")
    # each camera's block is symmetric, bit for bit
    h = got_h.reshape(d, d, n)
    assert torch.equal(h, h.transpose(0, 1))


@pytest.mark.parametrize("r, n, elem, rows", [
    (12, 89, 4, 12), (12, 89, 8, 12), (132, 89, 8, 132), (12, 1024, 8, 12),
    (132, 1024, 4, 22), (132, 1024, 8, 12), (144, 1024, 4, 24),
    (13, 1024, 8, 7), (5, 20000, 8, 1)])
def test_gather_row_blocks(r, n, elem, rows):
    """The gather's row split: the fewest row blocks whose table rows
    fit _TABLE_BYTES (one row a block where not even one fits), all of
    one size but the last, which is not larger and not empty."""
    got = cam_kernels._rows_per_block(r, n, elem)
    assert got == rows
    blocks = -(-r // got)
    fit = max(1, cam_kernels._TABLE_BYTES // (elem * n))
    assert blocks == -(-r // fit)
    assert got <= fit and 0 < r - (blocks - 1) * got <= got


def test_shape_checks():
    cam = torch.zeros(O, dtype=torch.int32)
    with pytest.raises(ValueError):
        cam_kernels.cam_scatter_add(torch.zeros(3, O - 1), cam, 4)
    with pytest.raises(ValueError):
        cam_kernels.e0_u(torch.zeros(35, O), cam, torch.zeros(12, 4))
    with pytest.raises(ValueError):
        cam_kernels.hpp_b(torch.zeros(47, O), torch.zeros(4, O), cam, 4)

"""The plain `prepare2` (povar_tpu_torch/ops/pose2_ref.py) in f32 and f64
on the state of tests/test_torch_pose2_kernels.py's `state` fixture (8
cameras, 60 landmarks, O = 8192 slot rows, most of them dead pad rows):
its jpsq's rows 4-7 are rows 0-3 bit for bit (both are sums of
w/p2^2 x4_c^2, the contract the CUDA kernel's last block keeps by writing
both from one f64 sum), and jpsq is the JAX package's XLA mirror
`povar_tpu/ops/xla_pose.prepare2` (the SPMD window layout's pure-f64
path) within 1e-4 of its largest entry, the per-camera tolerance of
tests/test_torch_pose2_kernels.py's test_prepare2 (sums in another
order).
"""

import numpy as np
import pytest
import torch

from povar_tpu.ops import xla_pose
from povar_tpu_torch.ops import pose2_ref
from test_torch_pose2_kernels import HUBER, J, T, _close, state  # noqa: F401

# one torch thread a test process: the CPU tests' tensors are small,
# and a parallel run's xdist workers share the host's cores
torch.set_num_threads(1)

# the state's operands (cam, camera table, landmarks, uv, mask) by type
OPERANDS = {
    torch.float32: ("cam", "ct", "x4", "uv", "mask"),
    torch.float64: ("cam", "ct64", "x4_64", "uv64", "mask"),
}


@pytest.mark.parametrize("dtype", list(OPERANDS), ids=["f32", "f64"])
@pytest.mark.parametrize("use_valid", [True, False], ids=["valid", "all"])
@pytest.mark.parametrize("robust", [0, 1], ids=["none", "huber"])
def test_plain_prepare2_rows_and_xla(state, dtype, use_valid, robust):
    keys = OPERANDS[dtype]
    kw = dict(use_valid=use_valid, robust=robust, huber=HUBER)
    jpsq = pose2_ref.prepare2(*T(state, *keys), **kw)[5]
    assert jpsq.dtype == dtype and jpsq.shape == (12, state["n"])
    assert torch.equal(jpsq[4:8], jpsq[0:4])
    assert bool((jpsq[0:4] > 0).any())  # live rows reached the sums
    want = np.asarray(xla_pose.prepare2(*J(state, *keys), **kw)[5])
    assert want.dtype == np.dtype(str(dtype).removeprefix("torch."))
    _close(jpsq.numpy(), want, 1e-4)

"""Wrappers of the camera-table kernels.

The counterpart of povar_tpu/ops/pallas_cam.py: `cam_gather` with the
JAX function's name and signature. As in ops/pose_kernels.py, the
wrapper calls the plain PyTorch version (ops/cam_ref.py) when its
tensors lie on the CPU, and only then; otherwise it checks device,
dtype, shape and contiguity, allocates the output, launches the
hand-written CUDA kernel (csrc/cam.cu) on the current stream, raises if
the launch returned a CUDA error, and adds one to its launch counter
(`LAUNCHES`, read with the others by ops/launches.py). There is no
fallback from the card to the plain version.

The other four kernels of pallas_cam.py (cam_scatter_add, e0_u,
e0_scatter, hpp_b) serve the unstructured path (ROADMAP.md queue 2
items 21-24) and are not ported yet.
"""

from __future__ import annotations

from typing import Dict

import torch

from povar_tpu_torch.ops import _build, cam_ref
from povar_tpu_torch.ops.pose_kernels import (
    _cuda_checks,
    _launch,
    _on_cpu,
    _ptr,
    _stream,
)

KERNELS = ("cam_gather",)

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

# shared memory one block of the gather stages its table rows in: the
# default 48 KB per block, 12 rows up to N = 1024 cameras
_TABLE_BYTES = 48 * 1024


def cam_gather(table: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
    """table [R, N] f32, cam [O] i32 -> [R, O] (table[:, cam[o]]), exact.
    Every cam[o] must lie in [0, N): the solvers' observation layout
    checks that once (slots.make_obs)."""
    if table.dim() != 2 or cam.dim() != 1:
        raise ValueError(
            f"table [R, N] and cam [O] expected, got {tuple(table.shape)} "
            f"and {tuple(cam.shape)}"
        )
    (r, n), o = table.shape, cam.shape[0]
    if _on_cpu(table, cam):
        return cam_ref.cam_gather(table, cam)
    _cuda_checks(o, n, cam, f32=(("table", table),))
    rows_per_block = max(1, min(r, _TABLE_BYTES // (4 * n)))
    out = torch.empty((r, o), dtype=torch.float32, device=table.device)
    _launch("cam_gather", _build.library().povar_cam_gather,
            _ptr(cam), _ptr(table), _ptr(out), o, n, r, rows_per_block,
            _stream(table), counts=LAUNCHES)
    return out

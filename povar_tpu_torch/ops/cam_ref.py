"""Plain PyTorch versions of the camera-table kernels (csrc/cam.cu).

The counterpart of povar_tpu/ops/pallas_cam.py on the paths this
package runs: `cam_gather` alone (the f32 LM state's cost gathers the
camera matrices per observation with it). ops/cam_kernels.py calls it
for tensors on the CPU, and chip_smoke.py holds the CUDA kernel to it on
the card, bit for bit.
"""

from __future__ import annotations

import torch


def cam_gather(table: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
    """table [R, N], cam [O] -> [R, O] with column o = table[:, cam[o]]."""
    return table[:, cam.long()]

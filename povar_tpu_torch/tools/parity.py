"""A kernel's result against its plain version, scaled per entry.

A CUDA kernel and its plain PyTorch version (ops/pose_ref.py,
ops/pose2_ref.py) agree to f32 rounding, elementwise outputs exactly or
nearly so and sums up to the order of their atomic adds. A bound
relative to the largest magnitude of a whole output says nothing about
its typical entries where a few entries are huge: at step 2, landmarks
near a camera's principal plane give 1/p2 ~ 1e5 and per-camera sums of
~1e16. So every output is held to a scale of its own kind:

  elem    per-observation outputs [k, O]: each entry against its own
          |want| plus the median |want| of its row;
  cam     per-camera sums [k, N]: each camera (column) against the
          largest |want| of that camera;
  scalar  a 0-d sum: against |want|;
  exact   counts and flags: no difference at all.

chip_smoke.py and tests/test_torch_cuda.py compare on the card with it.
"""

from __future__ import annotations

import torch

KINDS = ("elem", "cam", "scalar", "exact")


def scaled_error(got: torch.Tensor, want: torch.Tensor, kind: str) -> float:
    """The largest |got - want| / scale over the output, the scale set by
    `kind` (see the module docstring); 0 where both agree exactly, inf
    where they differ on a zero scale. For `exact` the largest absolute
    difference. Raises ValueError on a shape mismatch or a non-finite
    entry of `got`."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; expected one of {KINDS}")
    g, w = got.detach().double(), want.detach().double()
    if g.shape != w.shape:
        raise ValueError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
    if not bool(torch.isfinite(g).all()):
        raise ValueError("non-finite entry")
    diff = (g - w).abs()
    if diff.numel() == 0:
        return 0.0
    if kind == "exact":
        return float(diff.max())
    a = w.abs()
    if kind == "elem":
        rows = a.reshape(-1, a.shape[-1])
        scale = (rows + rows.median(dim=1, keepdim=True).values).reshape(a.shape)
    elif kind == "cam":
        scale = a.amax(dim=0, keepdim=True) if a.dim() > 1 else a
    else:
        scale = a
    rel = torch.where(diff == 0, torch.zeros_like(diff), diff / scale)
    return float(rel.max())

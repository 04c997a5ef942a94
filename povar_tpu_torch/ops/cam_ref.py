"""Plain PyTorch versions of the camera-table kernels (csrc/cam.cu).

The counterpart of povar_tpu/ops/pallas_cam.py: the gather of a
per-camera table to observations, the per-camera scatter-add, the two
halves of the factorized power-series term (`e0_u`, `e0_scatter`) and
the fused per-camera normal equations (`hpp_b`). The f32 LM state's cost
uses `cam_gather`; the unstructured layout (solver/stage1.py `Lin1`,
solver/stage2.py `Lin2`) uses all five. ops/cam_kernels.py calls them
for tensors on the CPU, and chip_smoke.py holds the CUDA kernels to them
on the card: elementwise outputs sum their terms in the kernels' order,
so `cam_gather` and `e0_u` agree bit for bit; per-camera sums differ
only by the order of the kernels' atomics.
"""

from __future__ import annotations

from typing import Tuple

import torch


def cam_gather(table: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
    """table [R, N], cam [O] -> [R, O] with column o = table[:, cam[o]]."""
    return table[:, cam.long()]


def cam_scatter_add(v: torch.Tensor, cam: torch.Tensor,
                    n_cams: int) -> torch.Tensor:
    """v [R, O], cam [O] -> [R, N]: column c sums the columns of v whose
    observation sees camera c."""
    out = torch.zeros((v.shape[0], n_cams), dtype=v.dtype, device=v.device)
    return out.index_add_(1, cam.long(), v)


def e0_u(W: torch.Tensor, cam: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """u [dl, O] with u_i = sum_j W[i dc + j] x[j, cam(o)] (j in order),
    W [dl dc, O], x [dc, N]."""
    dc = x.shape[0]
    w3 = W.reshape(-1, dc, W.shape[-1])
    xc = x[:, cam.long()]
    u = w3[:, 0] * xc[0]
    for j in range(1, dc):
        u = u + w3[:, j] * xc[j]
    return u


def e0_scatter(W: torch.Tensor, cam: torch.Tensor, sb: torch.Tensor,
               n_cams: int) -> torch.Tensor:
    """[dc, N]: per camera, the sum over its observations of
    v_j = sum_i W[i dc + j] sb_i (i in order), W [dl dc, O], sb [dl, O]."""
    dl = sb.shape[0]
    w3 = W.reshape(dl, -1, W.shape[-1])
    v = w3[0] * sb[0]
    for i in range(1, dl):
        v = v + w3[i] * sb[i]
    return cam_scatter_add(v, cam, n_cams)


def hpp_b(Jp: torch.Tensor, r_tilde: torch.Tensor, cam: torch.Tensor,
          n_cams: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Jp [k d, O] (k residual rows of d pose columns), r_tilde [k, O] ->
    (hpp [d d, N], b [d, N]): per camera, the sums of
    sum_k Jp_k Jp_k^T and sum_k Jp_k r~_k (k in order)."""
    k = r_tilde.shape[0]
    jp = Jp.reshape(k, -1, Jp.shape[-1])
    d = jp.shape[1]
    outer = jp[0][:, None] * jp[0][None]
    jr = jp[0] * r_tilde[0]
    for kk in range(1, k):
        outer = outer + jp[kk][:, None] * jp[kk][None]
        jr = jr + jp[kk] * r_tilde[kk]
    return (cam_scatter_add(outer.reshape(d * d, -1), cam, n_cams),
            cam_scatter_add(jr, cam, n_cams))

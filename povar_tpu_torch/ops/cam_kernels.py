"""Wrappers of the camera-table kernels.

The counterpart of povar_tpu/ops/pallas_cam.py: `cam_gather`,
`cam_scatter_add`, `e0_u`, `e0_scatter` and `hpp_b` with the JAX
functions' names and signatures. As in ops/pose_kernels.py, each wrapper
calls the plain PyTorch version (ops/cam_ref.py) when its tensors lie on
the CPU, and only then; otherwise it checks device, dtype, shape and
contiguity, allocates the output, launches the hand-written CUDA kernel
(csrc/cam.cu) on the current stream, raises if the launch returned a
CUDA error, and adds one to its launch counter (`LAUNCHES`, read with
the others by ops/launches.py). There is no fallback from the card to
the plain version.

Each kernel has an f32 and an f64 instantiation (csrc/cam.cu); the
wrapper picks the entry point by its operands' dtype (f32 or f64, the
same for all of them: an f64 operand of an f32 call, or the reverse, is
a TypeError, never a cast) and counts the f64 launches apart, under the
kernel's name with `_f64` appended (F64_KERNELS). The f32 LM state's
cost runs `cam_gather`; the unstructured layout (`Lin1` / `Lin2`) runs
all five, in f32 under mixed-precision solves and in f64 under pure-f64
ones (`mixed_precision_solves=False`), whose landmark initialization
also gathers the f64 cameras through `cam_gather`. Every cam[o] must
lie in [0, N): the solvers' observation layout checks that once
(slots.make_obs). The per-observation operands of the three scatters
must be zero on slot pad rows, whose camera index is a real camera.

`cam_scatter_add`, `e0_scatter` and `hpp_b` meet their blocks'
per-camera sums (in f64, f64 and f32, csrc/cam.cu says why; all three in
f64 in the f64 instantiations) in a scratch
buffer of doubles that every call leaves zeroed: one per device and CUDA
stream (`pose_kernels._sums_scratch`, which the Schur-Jacobi kernels
share), zeroed once when it is made or grown, so a call is one device
operation.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from povar_tpu_torch.ops import _build, cam_ref
from povar_tpu_torch.ops.pose_kernels import (
    _check_shapes,
    _cuda_checks,
    _launch,
    _on_cpu,
    _ptr,
    _stream,
    _sums_scratch,
)

KERNELS = ("cam_gather", "cam_scatter_add", "e0_u", "e0_scatter", "hpp_b")
# the launch counters of the f64 instantiations
F64_KERNELS = tuple(f"{name}_f64" for name in KERNELS)

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS + F64_KERNELS}

# shared memory one block of the gather stages its table rows in: 96 KB,
# so that two blocks share an SM; the whole [R, N] table up to R N = 24576
# floats or 12288 doubles (R = 132 at N = 89 in f64, 12 rows at N = 1024)
_TABLE_BYTES = 96 * 1024
# the (k, d) shapes of hpp_b's Jacobian blocks that csrc/cam.cu
# instantiates: step 1's [4, 12] and step 2's tangent [2, 11]
_HPP_B_SHAPES = ((4, 12), (2, 11))


def _rows_per_block(r: int, n: int, elem: int = 4) -> int:
    """The table rows one block of the gather stages: the R rows cut into
    the fewest row blocks whose rows of N values of `elem` bytes fit
    _TABLE_BYTES (at least one row a block), all of one size but the
    last, which is never larger."""
    blocks = -(-r // max(1, _TABLE_BYTES // (elem * n)))
    return -(-r // blocks)


def _entry(name: str, o: int, n: int, cam, named):
    """(counter name, C entry point) of kernel `name` for its CUDA
    operands `named` ((name, tensor), ...): the f32 or the f64
    instantiation by the first operand's dtype, after `_cuda_checks`
    holds every operand to that dtype (a TypeError, never a cast)."""
    dtype = named[0][1].dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: {named[0][0]} is {dtype}; f32 or f64 "
                        "operands expected")
    f64 = dtype == torch.float64
    _cuda_checks(name, o, n, cam, **{"f64" if f64 else "f32": named})
    suffix = "_f64" if f64 else ""
    c_name = name if name.startswith("cam_") else f"cam_{name}"
    return (name + suffix,
            getattr(_build.library(), f"povar_{c_name}{suffix}"))


def cam_gather(table: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
    """table [R, N] f32 or f64, cam [O] i32 -> [R, O] (table[:, cam[o]]),
    exact (C1)."""
    if table.dim() != 2 or cam.dim() != 1:
        raise ValueError(
            f"table [R, N] and cam [O] expected, got {tuple(table.shape)} "
            f"and {tuple(cam.shape)}"
        )
    (r, n), o = table.shape, cam.shape[0]
    if _on_cpu(table, cam):
        return cam_ref.cam_gather(table, cam)
    label, fn = _entry("cam_gather", o, n, cam, (("table", table),))
    out = torch.empty((r, o), dtype=table.dtype, device=table.device)
    _launch(label, fn, _ptr(cam), _ptr(table), _ptr(out), o, n, r,
            _rows_per_block(r, n, table.element_size()), _stream(table),
            counts=LAUNCHES)
    return out


def cam_scatter_add(v: torch.Tensor, cam: torch.Tensor,
                    n_cams: int) -> torch.Tensor:
    """v [R, O] f32 or f64, cam [O] i32 -> [R, N] per-camera sums (C2)."""
    n = int(n_cams)
    if v.dim() != 2 or cam.dim() != 1:
        raise ValueError(
            f"v [R, O] and cam [O] expected, got {tuple(v.shape)} and "
            f"{tuple(cam.shape)}"
        )
    r, o = v.shape
    _check_shapes({"v": (v, r, "o")}, cam.shape[0], n)
    if _on_cpu(v, cam):
        return cam_ref.cam_scatter_add(v, cam, n)
    label, fn = _entry("cam_scatter_add", o, n, cam, (("v", v),))
    out = torch.empty((r, n), dtype=v.dtype, device=v.device)
    stream = _stream(v)
    # the R N sums and one ticket per row group (at most R groups)
    _launch(label, fn, _ptr(cam), _ptr(v), _ptr(out),
            _ptr(_sums_scratch(v.device, stream.value, r * (n + 1))), o, n,
            r, stream, counts=LAUNCHES)
    return out


def _e0_dims(W: torch.Tensor, cam: torch.Tensor, dc: int, dl: int = 0):
    """(dl, dc, O) of the factorized operand W [dl dc, O]; dl is inferred
    from W where it is not given."""
    if W.dim() != 2 or cam.dim() != 1:
        raise ValueError(
            f"W [dl*dc, O] and cam [O] expected, got {tuple(W.shape)} and "
            f"{tuple(cam.shape)}"
        )
    dl = dl or W.shape[0] // dc
    if W.shape[0] != dl * dc:
        raise ValueError(f"W: {W.shape[0]} rows, not dl * dc = {dl} * {dc}")
    return dl, dc, W.shape[1]


def e0_u(W: torch.Tensor, cam: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """u [dl, O] = W_o . x[:, cam(o)] with W [dl*dc, O] ([dl, dc, O]
    flat: dl the landmark tangent dimension, dc the camera's), x [dc, N],
    both f32 or both f64 (C3)."""
    dc, n = x.shape
    dl, dc, o = _e0_dims(W, cam, dc)
    _check_shapes({"cam": (cam[None], 1, "o")}, o, n)
    if _on_cpu(W, cam, x):
        return cam_ref.e0_u(W, cam, x)
    label, fn = _entry("e0_u", o, n, cam, (("W", W), ("x", x)))
    u = torch.empty((dl, o), dtype=W.dtype, device=W.device)
    _launch(label, fn, _ptr(cam), _ptr(W), _ptr(x), _ptr(u), o, n, dl, dc,
            _stream(W), counts=LAUNCHES)
    return u


def e0_scatter(W: torch.Tensor, cam: torch.Tensor, sb: torch.Tensor,
               n_cams: int) -> torch.Tensor:
    """out [dc, N] = sum_o onehot(cam(o)) (W_o^T sb_o) with sb [dl, O],
    the per-landmark values already expanded to observations; W and sb
    both f32 or both f64 (C4)."""
    n = int(n_cams)
    dl = sb.shape[0]
    dl, dc, o = _e0_dims(W, cam, W.shape[0] // max(dl, 1), dl)
    _check_shapes({"sb": (sb, dl, "o"), "cam": (cam[None], 1, "o")}, o, n)
    if _on_cpu(W, cam, sb):
        return cam_ref.e0_scatter(W, cam, sb, n)
    label, fn = _entry("e0_scatter", o, n, cam, (("W", W), ("sb", sb)))
    out = torch.empty((dc, n), dtype=W.dtype, device=W.device)
    stream = _stream(W)
    _launch(label, fn, _ptr(cam), _ptr(W), _ptr(sb), _ptr(out),
            _ptr(_sums_scratch(W.device, stream.value, dc * n + 1)), o, n,
            dl, dc, stream, counts=LAUNCHES)
    return out


def hpp_b(Jp: torch.Tensor, r_tilde: torch.Tensor, cam: torch.Tensor,
          n_cams: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Jp [k*d, O] ([k, d, O] flat: k residual rows, d pose dimensions),
    r_tilde [k, O] -> (hpp [d*d, N], b [d, N]): per-camera sums of
    Jp^T Jp and Jp^T r~ (C5), Jp and r_tilde both f32 or both f64. On
    the card (k, d) is (4, 12) or (2, 11), and hpp is symmetric bit for
    bit."""
    n = int(n_cams)
    if Jp.dim() != 2 or r_tilde.dim() != 2 or cam.dim() != 1:
        raise ValueError(
            f"Jp [k*d, O], r_tilde [k, O] and cam [O] expected, got "
            f"{tuple(Jp.shape)}, {tuple(r_tilde.shape)}, {tuple(cam.shape)}"
        )
    k, o = r_tilde.shape
    d = Jp.shape[0] // k
    _check_shapes({"Jp": (Jp, k * d, "o"), "cam": (cam[None], 1, "o")}, o, n)
    if _on_cpu(Jp, r_tilde, cam):
        return cam_ref.hpp_b(Jp, r_tilde, cam, n)
    if (k, d) not in _HPP_B_SHAPES:
        raise ValueError(f"hpp_b: (k, d) = {(k, d)} is none of "
                         f"{_HPP_B_SHAPES}")
    label, fn = _entry("hpp_b", o, n, cam,
                       (("Jp", Jp), ("r_tilde", r_tilde)))
    hpp = torch.empty((d * d, n), dtype=Jp.dtype, device=Jp.device)
    b = torch.empty((d, n), dtype=Jp.dtype, device=Jp.device)
    stream = _stream(Jp)
    sums = (d + d * (d + 1) // 2) * n + 1  # b, the upper triangle, ticket
    _launch(label, fn, _ptr(cam), _ptr(Jp), _ptr(r_tilde), _ptr(hpp),
            _ptr(b),
            _ptr(_sums_scratch(Jp.device, stream.value, sums)), o, n, k, d,
            stream, counts=LAUNCHES)
    return hpp, b

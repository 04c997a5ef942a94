"""Wrappers of the step-2 structured homogeneous-projective kernels.

The counterpart of povar_tpu/ops/pallas_pose2.py on the RIPOBA and
RIPCG paths: one function per kernel, with the JAX function's name and
signature minus `win` (the camera-window layout is TPU-only);
`e0_term2_parts` takes the full per-observation arrays and the part
list, as ops/pose_kernels.e0_term_parts does. Each wrapper, as in
ops/pose_kernels.py,

- calls the plain PyTorch version (ops/pose2_ref.py) when its tensors
  lie on the CPU, and only then;
- otherwise checks device, dtype, shape and contiguity, allocates the
  outputs, launches the hand-written CUDA kernel (csrc/pose2.cu) on the
  current stream, raises if the launch returned a CUDA error, and adds
  one to its launch counter.

There is no fallback from the card to the plain version. The kernels
are f32 except `pose_error2`, which runs in native f64 where the TPU ran
double-float (`error2_df32`); all but it and `e0_term2_parts` also have
an f64 instantiation (csrc/pose2.cu), which f64 operands take, counted
under the name with `_f64` appended, as in ops/pose_kernels.py (the
SPMD window layout's pure f64). Two changes of return shape against the
Pallas kernels: `ldiff2` returns the f64 sum of its per-block partials
instead of 128 f32 lane partials, and `pose_error2` returns the
ResidualInfo dict of the cost (as 0-d tensors, its kernel's own totals)
instead of [10, 128] double-float partials.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from povar_tpu_torch.ops import _build, pose2_ref
from povar_tpu_torch.ops.pose_kernels import (
    _THREADS,
    E0_TILE_THREADS,
    SCATTER_VALUES,
    SCHUR_MOMENTS,
    _check_shapes,
    _cuda_checks,
    _entry,
    _huber2,
    _launch,
    _on_cpu,
    _ptr,
    _stream,
    _sums_scratch,
    check_parts,
    e0_tile_table,
    moment_expand_table,
    schur_expand_table,
)
from povar_tpu_torch.ops.pose_math import ROBUST_HUBER

KERNELS = (
    "prepare2",
    "hppb2",
    "mat_dot2",
    "scatter2",
    "ldiff2",
    "pose_error2",
    "e0_term2_parts",
    "schur_diag2",
)

# launches per kernel; ops/launches.py zeroes and reads them with the
# step-1 kernels' counts
# the launch counters of the f64 instantiations: every kernel but the
# cost (native f64 in both) and the fused term (no f64 path runs it)
F64_KERNELS = tuple(f"{name}_f64" for name in KERNELS
                    if name not in ("pose_error2", "e0_term2_parts"))

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS + F64_KERNELS}


def _out(rows: int, cols: int, like: torch.Tensor, zero=False):
    """A new [rows, cols] tensor of `like`'s dtype and device."""
    make = torch.zeros if zero else torch.empty
    return make((rows, cols), dtype=like.dtype, device=like.device)


def _entry2(name: str, o: int, n: int, cam, named, f32=()):
    """ops/pose_kernels._entry for the step-2 kernels (C symbol
    povar_<name>)."""
    return _entry(name, name, o, n, cam, named, f32=f32)


def prepare2(cam, cam_table, x4, uv, mask, *, use_valid, robust, huber):
    """Linearization-point pass (S1). Inputs: cam [O] i32, cam_table
    [12, N], x4 [4, O] homogeneous landmarks expanded to observations,
    uv [2, O], mask [1, O] (> 0 = live row). Returns (r_w [2,O],
    sw [1,O], mm [3,O], jlw [8,O], jlsq [4,O], jpsq [12,N])."""
    o, n = cam.shape[0], cam_table.shape[-1]
    _check_shapes({
        "cam_table": (cam_table, 12, "n"), "x4": (x4, 4, "o"),
        "uv": (uv, 2, "o"), "mask": (mask, 1, "o"),
    }, o, n)
    if _on_cpu(cam, cam_table, x4, uv, mask):
        return pose2_ref.prepare2(
            cam, cam_table, x4, uv, mask, use_valid=use_valid,
            robust=robust, huber=huber,
        )
    label, fn, dt = _entry2("prepare2", o, n, cam, (
        ("cam_table", cam_table), ("x4", x4), ("uv", uv),
    ), f32=(("mask", mask),))
    rw, sw, mm = _out(2, o, x4), _out(1, o, x4), _out(3, o, x4)
    jlw, jlsq, jpsq = _out(8, o, x4), _out(4, o, x4), _out(12, n, x4)
    stream = _stream(x4)
    # the blocks' f64 sums (8 rows of jpsq's 12) and their ticket, which
    # the kernel leaves zeroed: a call is one device operation
    _launch(label, fn,
            _ptr(cam), _ptr(cam_table), _ptr(x4), _ptr(uv), _ptr(mask),
            _ptr(rw), _ptr(sw), _ptr(mm), _ptr(jlw), _ptr(jlsq), _ptr(jpsq),
            _ptr(_sums_scratch(x4.device, stream.value, 8 * n + 1)),
            o, n, int(bool(use_valid)), int(robust == ROBUST_HUBER),
            float(huber), _huber2(huber, dt), stream, counts=LAUNCHES)
    return rw, sw, mm, jlw, jlsq, jpsq


def hppb2(cam, x4, mm, sw, r_w, jlns, hib, n_cams):
    """(hpp12_raw [144, N], b12_raw [12, N]) per-camera sums in the
    unprojected frame (S2); the caller applies the Kps folds. jlns
    [6, O] tangent-projected Jl rows, hib [3, O] the landmark solve
    Hll^-1 bl expanded to observations."""
    o, n = cam.shape[0], int(n_cams)
    _check_shapes({
        "x4": (x4, 4, "o"), "mm": (mm, 3, "o"), "sw": (sw, 1, "o"),
        "r_w": (r_w, 2, "o"), "jlns": (jlns, 6, "o"), "hib": (hib, 3, "o"),
    }, o, n)
    if _on_cpu(cam, x4, mm, sw, r_w, jlns, hib):
        return pose2_ref.hppb2(cam, x4, mm, sw, r_w, jlns, hib, n)
    label, fn, dt = _entry2("hppb2", o, n, cam, (
        ("x4", x4), ("mm", mm), ("sw", sw), ("r_w", r_w), ("jlns", jlns),
        ("hib", hib),
    ))
    # one zeroed buffer of the operands' dtype: b12 (returned as a view),
    # the 40 moment rows the kernel expands into hpp, and its ticket
    # counter
    acc = torch.zeros(52 * n + 1, dtype=dt, device=x4.device)
    hpp = _out(144, n, x4)
    _launch(label, fn,
            _ptr(cam), _ptr(x4), _ptr(mm), _ptr(sw), _ptr(r_w), _ptr(jlns),
            _ptr(hib), _ptr(moment_expand_table(x4.device)), _ptr(hpp),
            _ptr(acc), o, n, _stream(x4), counts=LAUNCHES)
    return hpp, acc[:12 * n].view(12, n)


def mat_dot2(cam, x4, mm, sw, mat6, r_w, zt, *, add_r):
    """[3, O] = M^T (jp_x (+ r_w)) (S3), M [2, 3] per observation in
    mat6 [6, O] (rows r*3+i), jp_x through the per-camera table
    zt [12, N]. r_w [2, O] is an operand only when add_r (pass None
    otherwise)."""
    o, n = cam.shape[0], zt.shape[-1]
    named = {
        "x4": (x4, 4, "o"), "mm": (mm, 3, "o"), "sw": (sw, 1, "o"),
        "mat6": (mat6, 6, "o"), "zt": (zt, 12, "n"),
    }
    if add_r:
        if r_w is None:
            raise ValueError("mat_dot2: add_r=True needs r_w")
        named["r_w"] = (r_w, 2, "o")
    _check_shapes(named, o, n)
    ops = [t for t, _r, _a in named.values()]
    if _on_cpu(cam, *ops):
        return pose2_ref.mat_dot2(cam, x4, mm, sw, mat6, r_w, zt,
                                  add_r=add_r)
    label, fn, _dt = _entry2("mat_dot2", o, n, cam, tuple(
        (k, t) for k, (t, _r, _a) in named.items()))
    out = _out(3, o, x4)
    # NULL for the residual the kernel does not read without add_r
    rw_ptr = _ptr(r_w) if add_r else ctypes.c_void_p(None)
    _launch(label, fn,
            _ptr(cam), _ptr(x4), _ptr(mm), _ptr(sw), _ptr(mat6), rw_ptr,
            _ptr(zt), _ptr(out), o, n, int(bool(add_r)), _stream(x4),
            counts=LAUNCHES)
    return out


def scatter2(cam, x4, mm, sw, mat6, sb, n_cams):
    """[12, N] raw per-camera sums of sw/p2 (C^T (M sb)) (x) x4 (S4); the
    caller folds Kps^T. sb [3, O] is the per-landmark sum re-expanded to
    observations."""
    o, n = cam.shape[0], int(n_cams)
    _check_shapes({
        "x4": (x4, 4, "o"), "mm": (mm, 3, "o"), "sw": (sw, 1, "o"),
        "mat6": (mat6, 6, "o"), "sb": (sb, 3, "o"),
    }, o, n)
    if _on_cpu(cam, x4, mm, sw, mat6, sb):
        return pose2_ref.scatter2(cam, x4, mm, sw, mat6, sb, n)
    label, fn, _dt = _entry2("scatter2", o, n, cam, (
        ("x4", x4), ("mm", mm), ("sw", sw), ("mat6", mat6), ("sb", sb),
    ))
    # every entry written by the kernel's last block (as e0_scatter_
    # structured's)
    out = _out(12, n, x4)
    stream = _stream(x4)
    _launch(label, fn,
            _ptr(cam), _ptr(x4), _ptr(mm), _ptr(sw), _ptr(mat6), _ptr(sb),
            _ptr(out),
            _ptr(_sums_scratch(x4.device, stream.value,
                               SCATTER_VALUES * n + 1)),
            o, n, stream, counts=LAUNCHES)
    return out


def e0_term2_parts(cam, x4, mm, sw, mat6, zt, parts, n_cams):
    """The fused tangent power-series term (S7): [12, N] raw per-camera
    sums of sw/p2 (C^T (M sb)) (x) x4, sb = seg_lm( M^T jp_x ) through
    the per-term table zt [12, N] = Kps v11, over the slot parts
    ((ofs, g, w) each) in one launch; the caller folds Kps^T."""
    o, n = cam.shape[0], int(n_cams)
    _check_shapes({
        "x4": (x4, 4, "o"), "mm": (mm, 3, "o"), "sw": (sw, 1, "o"),
        "mat6": (mat6, 6, "o"), "zt": (zt, 12, "n"),
    }, o, n)
    check_parts(parts, o)
    if _on_cpu(cam, x4, mm, sw, mat6, zt):
        return pose2_ref.e0_term2_parts(cam, x4, mm, sw, mat6, zt, parts, n)
    _cuda_checks("e0_term2_parts", o, n, cam, f32=(
        ("x4", x4), ("mm", mm), ("sw", sw), ("mat6", mat6), ("zt", zt),
    ))
    table, tiles = e0_tile_table(tuple(parts), x4.device)
    out = _out(12, n, x4, zero=True)
    _launch("e0_term2_parts", _build.library().povar_e0_term2,
            _ptr(cam), _ptr(x4), _ptr(mm), _ptr(sw), _ptr(mat6), _ptr(zt),
            _ptr(table), _ptr(out), len(parts), tiles, o, n,
            E0_TILE_THREADS, _stream(x4), counts=LAUNCHES)
    return out


def schur_diag2(cam, x4, mm, sw, mat6, n_cams):
    """corr12_raw [144, N] (S8): per-camera sums of (sw/p2)^2 C^T B B^T C
    (x) x4 x4^T, B [2, 3] per observation in mat6 [6, O] (rows r*3+i);
    the caller folds Kps^T . Kps and subtracts from the damped Hpp."""
    o, n = cam.shape[0], int(n_cams)
    _check_shapes({
        "x4": (x4, 4, "o"), "mm": (mm, 3, "o"), "sw": (sw, 1, "o"),
        "mat6": (mat6, 6, "o"),
    }, o, n)
    if _on_cpu(cam, x4, mm, sw, mat6):
        return pose2_ref.schur_diag2(cam, x4, mm, sw, mat6, n)
    label, fn, _dt = _entry2("schur_diag2", o, n, cam, (
        ("x4", x4), ("mm", mm), ("sw", sw), ("mat6", mat6),
    ))
    out = _out(144, n, x4)
    stream = _stream(x4)
    _launch(label, fn,
            _ptr(cam), _ptr(x4), _ptr(mm), _ptr(sw), _ptr(mat6),
            _ptr(schur_expand_table(x4.device)), _ptr(out),
            _ptr(_sums_scratch(x4.device, stream.value,
                               SCHUR_MOMENTS * n + 1)),
            o, n, stream, counts=LAUNCHES)
    return out


def ldiff2(cam, x4, mm, sw, r_w, jls8, ilm4, zt):
    """-l_diff as a 0-d f64 tensor (S5): per-observation terms and per-
    block partials in the operands' dtype, summed in f64. zt [12, N] =
    Kps inc per
    camera; jls8 [8, O] the weighted scaled Jl rows; ilm4 [4, O] the
    lifted landmark increment expanded to observations."""
    o, n = cam.shape[0], zt.shape[-1]
    _check_shapes({
        "x4": (x4, 4, "o"), "mm": (mm, 3, "o"), "sw": (sw, 1, "o"),
        "r_w": (r_w, 2, "o"), "jls8": (jls8, 8, "o"),
        "ilm4": (ilm4, 4, "o"), "zt": (zt, 12, "n"),
    }, o, n)
    if _on_cpu(cam, x4, mm, sw, r_w, jls8, ilm4, zt):
        return pose2_ref.ldiff2(cam, x4, mm, sw, r_w, jls8, ilm4, zt)
    label, fn, dt = _entry2("ldiff2", o, n, cam, (
        ("x4", x4), ("mm", mm), ("sw", sw), ("r_w", r_w), ("jls8", jls8),
        ("ilm4", ilm4), ("zt", zt),
    ))
    part = torch.zeros(-(-o // _THREADS), dtype=dt, device=x4.device)
    _launch(label, fn,
            _ptr(cam), _ptr(x4), _ptr(mm), _ptr(sw), _ptr(r_w), _ptr(jls8),
            _ptr(ilm4), _ptr(zt), _ptr(part), o, n, _stream(x4),
            counts=LAUNCHES)
    return part.sum(dtype=torch.float64)


@functools.lru_cache(maxsize=None)
def _error_ticket(device: torch.device, stream: int) -> torch.Tensor:
    """pose_error2's ticket on `device` for calls on CUDA stream `stream`
    (one zeroing when first made; every call's last block resets it,
    and calls on one stream run one after another)."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def pose_error2(cam, cam_table, x4, uv, mask, *, robust, huber
                ) -> Dict[str, torch.Tensor]:
    """Homogeneous step-2 cost (S6) as the ResidualInfo dict of 0-d
    tensors (num_obs_all, error_all, residual_sum_all, num_obs_valid,
    error_valid, residual_sum_valid, is_numerically_valid). cam_table
    [12, N], x4 [4, O] and uv [2, O] are f64; mask [1, O] f32. On the
    card this is native f64 where the TPU ran double-float
    (pallas_pose2.error2_df32), one launch and no other device operation:
    the kernel sums its blocks' partials in a fixed order and writes the
    dict's tensors itself."""
    o, n = cam.shape[0], cam_table.shape[-1]
    _check_shapes({
        "cam_table": (cam_table, 12, "n"), "x4": (x4, 4, "o"),
        "uv": (uv, 2, "o"), "mask": (mask, 1, "o"),
    }, o, n)
    if _on_cpu(cam, cam_table, x4, uv, mask):
        return pose2_ref.pose_error2(cam, cam_table, x4, uv, mask,
                                     robust=robust, huber=huber)
    _cuda_checks(
        "pose_error2", o, n, cam, f32=(("mask", mask),),
        f64=(("cam_table", cam_table), ("x4", x4), ("uv", uv)),
    )
    n_part = -(-o // _THREADS)
    dev = x4.device
    part = torch.empty((7, n_part), dtype=torch.float64, device=dev)
    sums = torch.empty(4, dtype=torch.float64, device=dev)
    counts = torch.empty(2, dtype=torch.int64, device=dev)
    ok = torch.empty((), dtype=torch.bool, device=dev)
    stream = _stream(x4)
    _launch("pose_error2", _build.library().povar_pose_error2,
            _ptr(cam), _ptr(cam_table), _ptr(x4), _ptr(uv), _ptr(mask),
            _ptr(part), _ptr(_error_ticket(dev, stream.value)), _ptr(sums),
            _ptr(counts), _ptr(ok), n_part, o, n, int(robust),
            float(huber), stream, counts=LAUNCHES)
    return {
        "num_obs_all": counts[0],
        "error_all": sums[0],
        "residual_sum_all": sums[1],
        "num_obs_valid": counts[1],
        "error_valid": sums[2],
        "residual_sum_valid": sums[3],
        "is_numerically_valid": ok,
    }

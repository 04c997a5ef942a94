"""Wrappers of the step-1 structured pOSE kernels.

The counterpart of povar_tpu/ops/pallas_pose.py: one function per
kernel, with the JAX function's name and signature minus `win` (the
camera-window layout is TPU-only); `e0_term_parts` takes the full
per-observation arrays and the part list ((ofs, g, w) per slot part)
where the JAX function takes per-part reshaped copies. It also defines
what both steps' moment kernels and fused terms are handed (the moment
-> Hpp row map, the (part, tile) table). Each wrapper

- calls the plain PyTorch version (ops/pose_ref.py) when its tensors
  lie on the CPU, and only then;
- otherwise checks device, dtype, shape and contiguity, allocates the
  outputs, launches the hand-written CUDA kernel (csrc/pose1.cu) on
  the current stream, raises if the launch returned a CUDA error, and
  adds one to its launch counter.

There is no fallback from the card to the plain version: a kernel that
does not build or does not launch raises. The kernels are f32 except
`pose_error`, which runs in native f64 where the TPU ran double-float
(`pose_error_df32`). Apart from that one change of route the results
are those of the Pallas kernels, with two changes of return shape:
`apply_ldiff` and `apply_ldiff_stored` return the f64 sum of their per-
block partials instead of 128 f32 lane partials, and `pose_error`
returns (err, rn, bad) 0-d tensors instead of [5, 128] double-float
partials.

Launch counts (`LAUNCHES`, plain integers per kernel) let a run show
that its main path went through the kernels; ops/launches.py zeroes and
reads them with the step-2 kernels' counts.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

import torch

from povar_tpu_torch.ops import _build, pose_ref
from povar_tpu_torch.ops.pose_math import ROBUST_HUBER

KERNELS = (
    "prepare",
    "e0_factor",
    "hpp_b_structured",
    "e0_u_structured",
    "e0_scatter_structured",
    "apply_ldiff",
    "pose_error",
    "e0_term_parts",
    "schur_diag_structured",
    "poba_t3",
    "apply_ldiff_stored",
)

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

# per-block partials of the scalar reductions: one slot per block of
# the kernels' 256 threads, at most ceil(O / 256) blocks
_THREADS = 256


# The moment form of hpp_b_structured and hppb2 (csrc/pose_common.cuh):
# per camera the four weighted moment matrices sum w k_t xh xh^T, each as
# the 10 upper-triangle entries MOMENT_PAIRS[p] of xh xh^T: moment
# 10 t + p (step 1: k = (1, sp2 u, sp2 v, sp2 (u^2 + v^2)), xh = [x, 1];
# step 2: k = (1, mx, my, mx^2 + my^2) / p2^2, xh = x4)
MOMENT_PAIRS = tuple((i, j) for i in range(4) for j in range(i, 4))
# K[a][b] as (weight t, sign), None for its structural zeros:
# K = [[1, 0, -k1], [0, 1, -k2], [-k1, -k2, k3]]
_K = (((0, 1), None, (1, -1)),
      (None, (0, 1), (2, -1)),
      ((1, -1), (2, -1), (3, 1)))


def moment_expand_map() -> List[Optional[Tuple[int, int]]]:
    """For each row (4a+i)*12 + 4b+j of a raw Hpp [144, N], the
    (moment, sign) whose per-camera sum it is, or None where K[a][b] is
    0."""
    out = []
    for a in range(3):
        for i in range(4):
            for b in range(3):
                for j in range(4):
                    term = _K[a][b]
                    pair = MOMENT_PAIRS.index((min(i, j), max(i, j)))
                    out.append(None if term is None
                               else (10 * term[0] + pair, term[1]))
    return out


@functools.lru_cache(maxsize=8)
def moment_expand_table(device) -> torch.Tensor:
    """The kernels' int32 [144] form of moment_expand_map on `device`:
    sign * (moment + 1), 0 for a structural zero (one host-to-device copy
    per device)."""
    return torch.tensor([0 if e is None else e[1] * (e[0] + 1)
                         for e in moment_expand_map()],
                        dtype=torch.int32, device=device)


# The moment form of schur_diag_structured and schur_diag2
# (csrc/pose_common.cuh, schur_pass): per camera the sums of H_s xx_p for
# the upper-triangle entries SCHUR_PAIRS[s] of the symmetric 3x3 H and
# MOMENT_PAIRS[p] of xh xh^T: moment 10 s + p
SCHUR_PAIRS = tuple((a, b) for a in range(3) for b in range(a, 3))
SCHUR_MOMENTS = len(SCHUR_PAIRS) * len(MOMENT_PAIRS)


def schur_expand_map() -> List[int]:
    """For each row ((a*4+i)*3+b)*4+j = (4a+i)*12 + 4b+j of a Schur-Jacobi
    correction [144, N], the moment whose per-camera sum it is: H[a][b]
    xh_i xh_j with both pairs in upper-triangle order (no sign, no
    structural zero; a row and its mirror share one moment)."""
    return [10 * SCHUR_PAIRS.index((min(a, b), max(a, b)))
            + MOMENT_PAIRS.index((min(i, j), max(i, j)))
            for a in range(3) for i in range(4)
            for b in range(3) for j in range(4)]


@functools.lru_cache(maxsize=8)
def schur_expand_table(device) -> torch.Tensor:
    """The kernels' int32 [144] form of schur_expand_map on `device`:
    moment + 1, moment_expand_table's encoding (one host-to-device copy
    per device)."""
    return torch.tensor([m + 1 for m in schur_expand_map()],
                        dtype=torch.int32, device=device)


# values a live row adds per camera in the composed terms' scatters
# (e0_scatter_structured, pose2_kernels.scatter2; csrc/pose_common.cuh
# kScatterValues)
SCATTER_VALUES = 12

# (device, stream) -> the f64 buffer where the blocks' per-camera sums of
# the Schur-Jacobi kernels, of the composed terms' scatters and of
# cam_kernels' e0_scatter / hpp_b meet
_SUMS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _sums_scratch(device: torch.device, stream: int,
                  n: int) -> torch.Tensor:
    """A zero f64 buffer of at least `n` entries for a kernel launched on
    CUDA stream `stream`: the kernel's last block zeroes what it used
    (its sums and ticket), and calls on one stream run one after
    another."""
    buf = _SUMS.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(n, dtype=torch.float64, device=device)
        _SUMS[(device, stream)] = buf
    return buf


# threads per block of the fused terms (csrc/pose_common.cuh kE0Threads);
# a tile holds E0_TILE_THREADS // w landmarks x all w slot rows of its part
E0_TILE_THREADS = 512
TILE_FIELDS = ("ofs", "g", "w", "t", "tile0")


def tile_rows(parts, threads: int) -> Tuple[List[int], int]:
    """The fused terms' (part, tile) table for blocks of `threads`
    threads: per part (ofs, g, w) its TILE_FIELDS, t = threads // w
    landmarks per tile and tile0 the tiles of the parts before it (the
    last tile of a part may be ragged). Returns (flat int list, tiles)."""
    rows, tiles = [], 0
    for ofs, g, w in parts:
        t = threads // w
        if t < 1:
            raise ValueError(f"parts: width {w} exceeds the fused term's "
                             f"{threads} threads per tile")
        rows += [ofs, g, w, t, tiles]
        tiles += -(-g // t)
    return rows, tiles


@functools.lru_cache(maxsize=64)
def e0_tile_table(parts, device) -> Tuple[torch.Tensor, int]:
    """tile_rows of `parts` for the kernels as an int32 tensor on
    `device`, made once per part list (one host-to-device copy per solver,
    not one per power term). Returns (table, tiles)."""
    rows, tiles = tile_rows(parts, E0_TILE_THREADS)
    return torch.tensor(rows, dtype=torch.int32, device=device), tiles


def _on_cpu(*tensors: torch.Tensor) -> bool:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(
        "kernel inputs must all lie on the CPU or all on one CUDA device, "
        f"got {sorted(str(t.device) for t in tensors)}"
    )


def _check_shapes(named, o: int, n: int) -> None:
    """Shape checks shared by both routes; `named` maps a name to
    (tensor, rows, axis) with axis 'o' (observations) or 'n' (cameras)."""
    for name, (t, rows, axis) in named.items():
        want = (rows, o if axis == "o" else n)
        if tuple(t.shape) != want:
            raise ValueError(
                f"{name}: expected shape {want}, got {tuple(t.shape)}"
            )


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _ptr_or_null(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None) if t is None else _ptr(t)


def _launch(name: str, fn, *args, counts: Dict[str, int] = LAUNCHES) -> None:
    """Call a kernel's C entry point; raise on a nonzero cudaError_t,
    else add one to the kernel's launch count in `counts`."""
    rc = fn(*args)
    if rc != 0:
        msg = _build.library().povar_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {msg} ({rc})")
    counts[name] += 1


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


# The kernels' C interface takes O and N as int32, and their per-camera
# tables index [144, N] entries (the Schur-Jacobi and moment outputs) in
# int32; every [R, O] offset is 64-bit (csrc/pose_common.cuh)
MAX_KERNEL_OBS = 2**31 - 1
MAX_KERNEL_CAMERAS = (2**31 - 1) // 144


def _index_limits(name: str, o: int, n: int) -> None:
    """Raise before kernel `name` launches where O or N is past what the
    kernels' int32 C interface takes."""
    if o > MAX_KERNEL_OBS:
        raise ValueError(
            f"{name}: O = {o} observations past int32 ({MAX_KERNEL_OBS}), "
            "the largest the kernels' C interface takes")
    if n > MAX_KERNEL_CAMERAS:
        raise ValueError(
            f"{name}: N = {n} cameras past {MAX_KERNEL_CAMERAS}, the "
            "largest whose [144, N] per-camera tables the kernels index in "
            "int32")


def _cuda_checks(name: str, o: int, n: int, cam, f32=(), f64=()) -> None:
    """O and N within the index limits of kernel `name`, then dtype and
    contiguity of its CUDA operands (shapes are checked by
    _check_shapes)."""
    _index_limits(name, o, n)
    if o <= 0 or n <= 0:
        raise ValueError(f"empty problem (O={o}, N={n})")
    if cam.shape != (o,):
        raise ValueError(f"cam: expected shape {(o,)}, got {tuple(cam.shape)}")
    named = [("cam", cam, torch.int32)]
    named += [(k, t, torch.float32) for k, t in f32]
    named += [(k, t, torch.float64) for k, t in f64]
    for name, t, dtype in named:
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor must be contiguous")


def prepare(cam, cam_table, x, uv, mask, *, alpha, robust, huber,
            weighted=True, sums=True):
    """Linearization-point pass (K1). Inputs: cam [O] i32, cam_table
    [12, N] (row-major vec(P) per camera), x [3, O] (landmarks expanded
    to observations), uv [2, O], mask [1, O] (>0 = live row). Returns
    (r_w [4,O], sw [1,O], ata [9,O], atr [3,O], jpsq [12,N]).
    `weighted=False` skips the robust weight; `sums=False` skips the
    per-camera sums and the r_w / sw stores (callers that read ata and
    atr alone) and returns None in place of r_w, sw and jpsq."""
    o, n = cam.shape[0], cam_table.shape[-1]
    _check_shapes({
        "cam_table": (cam_table, 12, "n"), "x": (x, 3, "o"),
        "uv": (uv, 2, "o"), "mask": (mask, 1, "o"),
    }, o, n)
    if _on_cpu(cam, cam_table, x, uv, mask):
        return pose_ref.prepare(
            cam, cam_table, x, uv, mask, alpha=alpha, robust=robust,
            huber=huber, weighted=weighted, sums=sums,
        )
    _cuda_checks("prepare", o, n, cam, f32=(
        ("cam_table", cam_table), ("x", x),
        ("uv", uv), ("mask", mask),
    ))
    c = pose_ref.pose_consts(alpha, torch.float32)
    opts = dict(dtype=torch.float32, device=x.device)
    ata = torch.empty((9, o), **opts)
    atr = torch.empty((3, o), **opts)
    rw = sw = jpsq = acc = None
    if sums:
        rw = torch.empty((4, o), **opts)
        sw = torch.empty((1, o), **opts)
        jpsq = torch.empty((12, n), **opts)
        # the blocks' f64 sums (8 rows of jpsq's 12) and the ticket
        acc = torch.zeros(8 * n + 1, dtype=torch.float64, device=x.device)
    huber_on = bool(weighted) and robust == ROBUST_HUBER
    _launch("prepare", _build.library().povar_prepare,
            _ptr(cam), _ptr(cam_table), _ptr(x), _ptr(uv), _ptr(mask),
            *map(_ptr_or_null, (rw, sw)), _ptr(ata), _ptr(atr),
            *map(_ptr_or_null, (jpsq, acc)), o, n, c.sp, c.sa, c.sp2,
            int(huber_on), float(huber),
            float(torch.tensor(huber * huber, dtype=torch.float32)),
            int(bool(sums)), _stream(x))
    return rw, sw, ata, atr, jpsq


def e0_factor(cam, cam_table, uv, w, jls, lh, *, alpha):
    """h [9, O] (layout c*3+a) (K2). Inputs: w [1,O] robust weight (not
    sqrt), jls [3,O] landmark scale expanded to obs, lh [9,O] chol of
    Hll^-1 expanded to obs (row-major i*3+c)."""
    o, n = cam.shape[0], cam_table.shape[-1]
    _check_shapes({
        "cam_table": (cam_table, 12, "n"), "uv": (uv, 2, "o"),
        "w": (w, 1, "o"), "jls": (jls, 3, "o"), "lh": (lh, 9, "o"),
    }, o, n)
    if _on_cpu(cam, cam_table, uv, w, jls, lh):
        return pose_ref.e0_factor(cam, cam_table, uv, w, jls, lh, alpha=alpha)
    _cuda_checks("e0_factor", o, n, cam, f32=(
        ("cam_table", cam_table), ("uv", uv),
        ("w", w), ("jls", jls), ("lh", lh),
    ))
    h = torch.empty((9, o), dtype=torch.float32, device=uv.device)
    _launch("e0_factor", _build.library().povar_e0_factor,
            _ptr(cam), _ptr(cam_table), _ptr(uv), _ptr(w), _ptr(jls),
            _ptr(lh), _ptr(h), o, n,
            pose_ref.pose_consts(alpha, torch.float32).sp2h, _stream(uv))
    return h


def hpp_b_structured(cam, cam_table, x, uv, sw, r_w, jls, hib, n_cams, *,
                     alpha):
    """(hpp_raw [144, N], b_raw [12, N]) per-camera sums BEFORE the
    pose-scale outer products (row layout (4a+i)*12 + (4b+j)) (K3)."""
    o, n = cam.shape[0], int(n_cams)
    _check_shapes({
        "cam_table": (cam_table, 12, "n"), "x": (x, 3, "o"),
        "uv": (uv, 2, "o"), "sw": (sw, 1, "o"), "r_w": (r_w, 4, "o"),
        "jls": (jls, 3, "o"), "hib": (hib, 3, "o"),
    }, o, n)
    if _on_cpu(cam, cam_table, x, uv, sw, r_w, jls, hib):
        return pose_ref.hpp_b_structured(
            cam, cam_table, x, uv, sw, r_w, jls, hib, n, alpha=alpha
        )
    _cuda_checks("hpp_b_structured", o, n, cam, f32=(
        ("cam_table", cam_table), ("x", x),
        ("uv", uv), ("sw", sw), ("r_w", r_w),
        ("jls", jls), ("hib", hib),
    ))
    c = pose_ref.pose_consts(alpha, torch.float32)
    # one zeroed f64 buffer where the blocks' sums meet: b, the 40 moment
    # rows, the ticket counter; the kernel writes hpp and b from it
    acc = torch.zeros(52 * n + 1, dtype=torch.float64, device=x.device)
    hpp = torch.empty((144, n), dtype=torch.float32, device=x.device)
    b = torch.empty((12, n), dtype=torch.float32, device=x.device)
    _launch("hpp_b_structured", _build.library().povar_hpp_b,
            _ptr(cam), _ptr(cam_table), _ptr(x), _ptr(uv), _ptr(sw),
            _ptr(r_w), _ptr(jls), _ptr(hib),
            _ptr(moment_expand_table(x.device)), _ptr(hpp), _ptr(b),
            _ptr(acc), o, n, c.sp, c.sa, c.sp2, _stream(x))
    return hpp, b


def e0_u_structured(cam, x, h, z_table):
    """u [3, O] = W_o . z[:, cam(o)] with z_table = ps . xvec [12, N]
    (K4)."""
    o, n = cam.shape[0], z_table.shape[-1]
    _check_shapes({
        "x": (x, 3, "o"), "h": (h, 9, "o"), "z_table": (z_table, 12, "n"),
    }, o, n)
    if _on_cpu(cam, x, h, z_table):
        return pose_ref.e0_u_structured(cam, x, h, z_table)
    _cuda_checks("e0_u_structured", o, n, cam, f32=(
        ("x", x), ("h", h), ("z_table", z_table),
    ))
    u = torch.empty((3, o), dtype=torch.float32, device=x.device)
    _launch("e0_u_structured", _build.library().povar_e0_u,
            _ptr(cam), _ptr(x), _ptr(h), _ptr(z_table), _ptr(u), o, n,
            _stream(x))
    return u


def e0_scatter_structured(cam, x, h, sb, n_cams):
    """out_raw [12, N] = seg_cam( (h^T sb) (x) xh ) (K5); the caller
    multiplies by the pose scale."""
    o, n = cam.shape[0], int(n_cams)
    _check_shapes({
        "x": (x, 3, "o"), "h": (h, 9, "o"), "sb": (sb, 3, "o"),
    }, o, n)
    if _on_cpu(cam, x, h, sb):
        return pose_ref.e0_scatter_structured(cam, x, h, sb, n)
    _cuda_checks("e0_scatter_structured", o, n, cam, f32=(
        ("x", x), ("h", h), ("sb", sb),
    ))
    # every entry written by the kernel's last block, from the blocks'
    # f64 sums in the shared scratch (left zeroed)
    out = torch.empty((12, n), dtype=torch.float32, device=x.device)
    stream = _stream(x)
    _launch("e0_scatter_structured", _build.library().povar_e0_scatter,
            _ptr(cam), _ptr(x), _ptr(h), _ptr(sb), _ptr(out),
            _ptr(_sums_scratch(x.device, stream.value,
                               SCATTER_VALUES * n + 1)),
            o, n, stream)
    return out


def check_parts(parts, o: int) -> None:
    """Validate a fused-term part list ((ofs, g, w) each, as
    solver/slots.plan_e0_fused makes it) against O observations."""
    if not parts:
        raise ValueError("parts: the fused term needs at least one part")
    for ofs, g, w in parts:
        if g < 1 or w < 1 or ofs < 0 or ofs + g * w > o:
            raise ValueError(f"parts: ({ofs}, {g}, {w}) outside O = {o}")


def e0_term_parts(cam, x, h, z_table, parts, n_cams):
    """The fused power-series term (K8): out_raw [12, N] = seg_cam(
    (h^T sb) (x) xh ), sb = seg_lm( h (xh . z[:, cam]) ), over the slot
    parts ((ofs, g, w) each) in one launch; the caller multiplies by the
    pose scale."""
    o, n = cam.shape[0], int(n_cams)
    _check_shapes({
        "x": (x, 3, "o"), "h": (h, 9, "o"), "z_table": (z_table, 12, "n"),
    }, o, n)
    check_parts(parts, o)
    if _on_cpu(cam, x, h, z_table):
        return pose_ref.e0_term_parts(cam, x, h, z_table, parts, n)
    _cuda_checks("e0_term_parts", o, n, cam, f32=(
        ("x", x), ("h", h), ("z_table", z_table),
    ))
    table, tiles = e0_tile_table(tuple(parts), x.device)
    out = torch.zeros((12, n), dtype=torch.float32, device=x.device)
    _launch("e0_term_parts", _build.library().povar_e0_term,
            _ptr(cam), _ptr(x), _ptr(h), _ptr(z_table), _ptr(table),
            _ptr(out), len(parts), tiles, o, n, E0_TILE_THREADS, _stream(x))
    return out


def schur_diag_structured(cam, x, h, n_cams):
    """corr_raw [144, N] = seg_cam( (h^T h) (x) xh xh^T ) (K9), rows
    ((a*4+i)*3+b)*4+j; the caller applies the pose-scale outer product
    and subtracts it from the damped Hpp."""
    o, n = cam.shape[0], int(n_cams)
    _check_shapes({"x": (x, 3, "o"), "h": (h, 9, "o")}, o, n)
    if _on_cpu(cam, x, h):
        return pose_ref.schur_diag_structured(cam, x, h, n)
    _cuda_checks("schur_diag_structured", o, n, cam, f32=(("x", x), ("h", h)))
    out = torch.empty((144, n), dtype=torch.float32, device=x.device)
    stream = _stream(x)
    _launch("schur_diag_structured", _build.library().povar_schur_diag,
            _ptr(cam), _ptr(x), _ptr(h), _ptr(schur_expand_table(x.device)),
            _ptr(out),
            _ptr(_sums_scratch(x.device, stream.value, SCHUR_MOMENTS * n + 1)),
            o, n, stream)
    return out


def apply_ldiff(cam, x, uv, sw, r_w, jls, inc_lm_obs, cam_table_old,
                inc_table, *, alpha):
    """-l_diff as a 0-d f64 tensor (K6): f32 per-observation terms,
    per-block f32 partials, summed in f64. inc_table [12, N] is the
    scaled camera increment; inc_lm_obs [3, O] the landmark increment
    expanded to observations."""
    o, n = cam.shape[0], cam_table_old.shape[-1]
    _check_shapes({
        "x": (x, 3, "o"), "uv": (uv, 2, "o"), "sw": (sw, 1, "o"),
        "r_w": (r_w, 4, "o"), "jls": (jls, 3, "o"),
        "inc_lm_obs": (inc_lm_obs, 3, "o"),
        "cam_table_old": (cam_table_old, 12, "n"),
        "inc_table": (inc_table, 12, "n"),
    }, o, n)
    if _on_cpu(cam, x, uv, sw, r_w, jls, inc_lm_obs, cam_table_old,
               inc_table):
        return pose_ref.apply_ldiff(
            cam, x, uv, sw, r_w, jls, inc_lm_obs, cam_table_old,
            inc_table, alpha=alpha,
        )
    _cuda_checks("apply_ldiff", o, n, cam, f32=(
        ("x", x), ("uv", uv), ("sw", sw),
        ("r_w", r_w), ("jls", jls),
        ("inc_lm_obs", inc_lm_obs),
        ("cam_table_old", cam_table_old),
        ("inc_table", inc_table),
    ))
    c = pose_ref.pose_consts(alpha, torch.float32)
    part = torch.zeros(
        -(-o // _THREADS), dtype=torch.float32, device=x.device
    )
    _launch("apply_ldiff", _build.library().povar_apply_ldiff,
            _ptr(cam), _ptr(x), _ptr(uv), _ptr(sw), _ptr(r_w), _ptr(jls),
            _ptr(inc_lm_obs), _ptr(cam_table_old), _ptr(inc_table),
            _ptr(part), o, n, c.sp, c.sa, _stream(x))
    return part.sum(dtype=torch.float64)


def _stored_inputs(name, cam, cam_table, x, uv, sw, r_w, jls, z_table,
                   extra=()):
    """Shape checks of the POWER_SCHUR_COMPLEMENT apply's operands (the
    stored linearization and the z table); True when they lie on the
    CPU, else their CUDA checks passed. `extra`: (name, tensor) pairs of
    further [3, O] operands."""
    o, n = cam.shape[0], cam_table.shape[-1]
    _check_shapes({
        "cam_table": (cam_table, 12, "n"), "x": (x, 3, "o"),
        "uv": (uv, 2, "o"), "sw": (sw, 1, "o"), "r_w": (r_w, 4, "o"),
        "jls": (jls, 3, "o"), "z_table": (z_table, 12, "n"),
        **{k: (t, 3, "o") for k, t in extra},
    }, o, n)
    tensors = (cam, cam_table, x, uv, sw, r_w, jls, z_table,
               *(t for _k, t in extra))
    if _on_cpu(*tensors):
        return True
    _cuda_checks(name, o, n, cam, f32=(
        ("cam_table", cam_table), ("x", x), ("uv", uv), ("sw", sw),
        ("r_w", r_w), ("jls", jls), ("z_table", z_table), *extra,
    ))
    return False


def poba_t3(cam, cam_table, x, uv, sw, r_w, jls, z_table, *, alpha):
    """t3 [3, O] = Jl_s^T (r_w + Jp_s inc) (K10): the per-observation
    right-hand side of the POWER_SCHUR_COMPLEMENT landmark system, slot-
    summed by the caller. z_table [12, N] = pose_scale . inc."""
    if _stored_inputs("poba_t3", cam, cam_table, x, uv, sw, r_w, jls,
                      z_table):
        return pose_ref.poba_t3(cam, cam_table, x, uv, sw, r_w, jls, z_table,
                                alpha=alpha)
    o, n = cam.shape[0], cam_table.shape[-1]
    c = pose_ref.pose_consts(alpha, torch.float32)
    t3 = torch.empty((3, o), dtype=torch.float32, device=x.device)
    _launch("poba_t3", _build.library().povar_poba_t3,
            _ptr(cam), _ptr(cam_table), _ptr(x), _ptr(uv), _ptr(sw),
            _ptr(r_w), _ptr(jls), _ptr(z_table), _ptr(t3), o, n, c.sp, c.sa,
            _stream(x))
    return t3


def apply_ldiff_stored(cam, x, uv, sw, r_w, jls, inc_lm_obs, cam_table_old,
                       z_table, *, alpha):
    """-l_diff of the POWER_SCHUR_COMPLEMENT apply as a 0-d f64 tensor
    (K11), from the stored scaled Jacobians: f32 per-observation terms,
    per-block f32 partials, summed in f64. z_table [12, N] = pose_scale .
    inc; inc_lm_obs [3, O] the scaled landmark increment expanded to
    observations."""
    if _stored_inputs("apply_ldiff_stored", cam, cam_table_old, x, uv, sw,
                      r_w, jls, z_table, extra=(("inc_lm_obs", inc_lm_obs),)):
        return pose_ref.apply_ldiff_stored(
            cam, x, uv, sw, r_w, jls, inc_lm_obs, cam_table_old, z_table,
            alpha=alpha,
        )
    o, n = cam.shape[0], cam_table_old.shape[-1]
    c = pose_ref.pose_consts(alpha, torch.float32)
    part = torch.zeros(
        -(-o // _THREADS), dtype=torch.float32, device=x.device
    )
    _launch("apply_ldiff_stored", _build.library().povar_apply_ldiff_stored,
            _ptr(cam), _ptr(x), _ptr(uv), _ptr(sw), _ptr(r_w), _ptr(jls),
            _ptr(inc_lm_obs), _ptr(cam_table_old), _ptr(z_table),
            _ptr(part), o, n, c.sp, c.sa, _stream(x))
    return part.sum(dtype=torch.float64)


def pose_error(cam, cam_table, x, uv, mask, *, alpha, robust, huber
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """pOSE cost (K7): (sum of robust costs, sum of residual norms, the
    count of live rows with a non-finite residual) as 0-d tensors (f64,
    f64, int32). cam_table [12, N], x [3, O] and uv [2, O] are f64;
    mask [1, O] f32. On the card this is native f64 where the TPU ran
    double-float (pallas_pose.pose_error_df32)."""
    o, n = cam.shape[0], cam_table.shape[-1]
    _check_shapes({
        "cam_table": (cam_table, 12, "n"), "x": (x, 3, "o"),
        "uv": (uv, 2, "o"), "mask": (mask, 1, "o"),
    }, o, n)
    if _on_cpu(cam, cam_table, x, uv, mask):
        return pose_ref.pose_error(
            cam, cam_table, x, uv, mask, alpha=alpha, robust=robust,
            huber=huber,
        )
    _cuda_checks(
        "pose_error", o, n, cam, f32=(("mask", mask),),
        f64=(("cam_table", cam_table), ("x", x),
             ("uv", uv)),
    )
    c = pose_ref.pose_consts(alpha, torch.float64)
    n_part = -(-o // _THREADS)
    part = torch.zeros((3, n_part), dtype=torch.float64, device=x.device)
    _launch("pose_error", _build.library().povar_pose_error,
            _ptr(cam), _ptr(cam_table), _ptr(x), _ptr(uv), _ptr(mask),
            _ptr(part), n_part, o, n, c.sp, c.sa, int(robust),
            float(huber), _stream(x))
    tot = part.sum(dim=1)
    return tot[0], tot[1], tot[2].to(torch.int32)

"""The nine step-1 kernels of povar_tpu_torch against the JAX package's
Pallas kernels (interpret mode on the CPU, as tests/test_pallas_pose.py
runs them), on the fixture of that file: O = 1024 observations, N = 13
cameras, M = 64 landmarks, ~5% dead rows, every operand seeded numpy.
The fused term runs over two slot parts of widths 4 and 16 (the widest
the fused term takes) that cover all O rows (PARTS) and over the first
alone (a narrow prefix, as beside a composed suffix); the JAX kernel
takes those parts as the landmark-major [rows * w, G] copies its solver
makes (`jax_parts`).

On CPU tensors the port's wrappers run the plain PyTorch versions
(ops/pose_ref.py), so these tests hold the plain versions to the TPU
kernels; the CUDA kernels are held to the plain versions on the card by
tests/test_torch_cuda.py (and by chip_smoke.py).

Tolerances (mirroring tests/test_pallas_pose.py:349-356), each relative
to the largest magnitude of the output compared:
  - elementwise outputs (r_w, sw, ata, atr, h, u): 1e-5;
  - per-camera sums (jpsq, hpp, b, the E0 scatter, the fused term, the
    Schur-Jacobi corrections) and l_diff: 1e-4 (measured <= 2.7e-7 for
    the fused term and the corrections);
  - the f64 cost against pose_error_df32 (~47-bit double-float): 1e-12
    for NONE; 1e-8 for HUBER, whose double-float kernel takes the Huber
    weight in f32 from the leading component of |r|^2 (measured 1.5e-9
    here), and 1e-12 against the JAX package's f64 cost expression
    (pose_math.pose_residual_t + robust_error_and_weight) for both;
  - the residual-norm sum: 1e-7 (one f32 sqrt per row in double-float).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from povar_tpu.ops import pallas_pose as pp
from povar_tpu.ops import pose_math
from povar_tpu_torch.ops import launches
from povar_tpu_torch.ops import pose_kernels as pk
from povar_tpu_torch.ops import pose_ref

# one torch thread a test process: the CPU tests' tensors are small,
# and a parallel run's xdist workers share the host's cores
torch.set_num_threads(1)

ALPHA = 0.01
O, N, M = 1024, 13, 64
# fused-term slot parts (ofs, g, w): all O rows, and a narrow prefix
PARTS = ((0, 64, 4), (256, 48, 16))
PREFIX = PARTS[:1]


def jax_parts(parts, n, rows_per_lane, cam, *rows):
    """The JAX fused kernels' part operands: per part the [w, G] camera
    block and each [k, O] operand as its [k * w, G] landmark-major view,
    padded to G = a whole number of e0_term_geometry tiles (pad lanes
    are zero: camera 0, zero weight), then w and the tile."""
    out = []
    for ofs, g, w in parts:
        gt, gp = pp.e0_term_geometry(w, g, n, rows_per_lane=rows_per_lane)
        sl = slice(ofs, ofs + g * w)
        views = [cam[sl].reshape(w, g)] + [
            r[:, sl].reshape(r.shape[0] * w, g) for r in rows
        ]
        out.append(tuple(jnp.asarray(np.pad(v, ((0, 0), (0, gp - g))))
                         for v in views) + (w, gt))
    return tuple(out)


@pytest.fixture(scope="module")
def prob():
    """tests/test_pallas_pose.py's fixture plus the per-observation
    operands of the later kernels."""
    rng = np.random.default_rng(7)
    cam = rng.integers(0, N, O).astype(np.int32)
    lm = np.repeat(np.arange(M), O // M).astype(np.int32)
    cams = rng.standard_normal((N, 3, 4)).astype(np.float32)
    lms = rng.standard_normal((M, 3)).astype(np.float32)
    uv = rng.standard_normal((2, O)).astype(np.float32)
    mask = (rng.uniform(size=O) > 0.05).astype(np.float32)
    x = lms[lm].T.copy()
    f = np.float32
    d = dict(
        cam=cam, ct=cams.reshape(N, 12).T.copy(), x=x, uv=uv,
        mask=mask.reshape(1, O),
        sw=(rng.uniform(0.5, 1.0, (1, O)) * mask).astype(f),
        r_w=(rng.standard_normal((4, O)) * mask).astype(f),
        jls=rng.uniform(0.1, 1.0, (3, O)).astype(f),
        hib=rng.standard_normal((3, O)).astype(f),
        lh=rng.standard_normal((9, O)).astype(f),
        h=(rng.standard_normal((9, O)) * mask).astype(f),
        z=rng.standard_normal((12, N)).astype(f),
        sb=rng.standard_normal((3, O)).astype(f),
        inc=rng.standard_normal((12, N)).astype(f),
        inc_lm=rng.standard_normal((3, O)).astype(f),
        ct64=cams.reshape(N, 12).T.astype(np.float64)
        + 1e-9 * rng.standard_normal((12, N)),
        x64=x.astype(np.float64) + 1e-9 * rng.standard_normal((3, O)),
        uv64=uv.astype(np.float64) + 1e-9 * rng.standard_normal((2, O)),
    )
    d["w"] = d["sw"] * d["sw"]
    return d


def J(d, *keys):
    return [jnp.asarray(d[k]) for k in keys]


def T(d, *keys):
    return [torch.as_tensor(d[k]) for k in keys]


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors go to the plain versions: no kernel launch counted."""
    launches.reset_launch_counts()
    yield
    assert all(v == 0 for v in launches.launch_counts().values())


@pytest.mark.parametrize(
    "robust, weighted, sums",
    [(0, True, True), (1, True, True), (0, False, True),
     (0, True, False), (1, True, False), (0, False, False)],
    ids=["none", "huber", "unweighted",
         "none-nosums", "huber-nosums", "unweighted-nosums"],
)
def test_prepare(prob, robust, weighted, sums):
    """With sums=False the port returns None for r_w, sw and jpsq and
    the same ata / atr as JAX's prepare."""
    args = ("cam", "ct", "x", "uv", "mask")
    kw = dict(alpha=ALPHA, robust=robust, huber=1.0, weighted=weighted)
    want = pp.prepare(*J(prob, *args), **kw)
    got = pk.prepare(*T(prob, *args), **kw, sums=sums)
    if robust:
        sw = np.asarray(want[1])
        assert (sw[sw > 0] < 0.99).any()  # some rows are Huber-weighted
    for k, (g, w, tol) in enumerate(zip(got, want, [1e-5] * 4 + [1e-4])):
        if not sums and k in (0, 1, 4):
            assert g is None
            continue
        _close(g.numpy(), w, tol)


@pytest.mark.parametrize("robust", [0, 1], ids=["none", "huber"])
def test_prepare_jpsq_rows_repeat(prob, robust):
    """jpsq's rows 4-7 (a = 1) are its rows 0-3 (a = 0) bit for bit, and
    ata / atr do not depend on `sums`, in the plain version the CPU runs
    and the card's kernels are held to."""
    args = T(prob, "cam", "ct", "x", "uv", "mask")
    kw = dict(alpha=ALPHA, robust=robust, huber=1.0)
    _rw, _sw, ata, atr, jpsq = pose_ref.prepare(*args, **kw)
    assert torch.equal(jpsq[4:8], jpsq[0:4])
    assert not torch.equal(jpsq[8:12], jpsq[0:4])
    _n, _m, ata0, atr0, _j = pose_ref.prepare(*args, **kw, sums=False)
    assert torch.equal(ata0, ata) and torch.equal(atr0, atr)


def test_e0_factor(prob):
    args = ("cam", "ct", "uv", "w", "jls", "lh")
    want = pp.e0_factor(*J(prob, *args), alpha=ALPHA)
    got = pk.e0_factor(*T(prob, *args), alpha=ALPHA)
    _close(got.numpy(), want, 1e-5)


def test_hpp_b_structured(prob):
    args = ("cam", "ct", "x", "uv", "sw", "r_w", "jls", "hib")
    want = pp.hpp_b_structured(*J(prob, *args), N, alpha=ALPHA)
    got = pk.hpp_b_structured(*T(prob, *args), N, alpha=ALPHA)
    for g, w in zip(got, want):
        _close(g.numpy(), w, 1e-4)


def test_e0_u_structured(prob):
    args = ("cam", "x", "h", "z")
    want = pp.e0_u_structured(*J(prob, *args))
    got = pk.e0_u_structured(*T(prob, *args))
    _close(got.numpy(), want, 1e-5)


def _rows(d, keys, order, seed=3):
    """d's per-observation operands `keys` in `order`: as drawn, sorted
    by camera (whole warps on one camera on the card, as the mesh's
    window order puts them), or sorted by camera with another ~25% of
    the rows dead (h = 0, the other operands kept)."""
    d = dict(d)
    if order in ("by_camera", "by_camera_dead"):
        idx = np.argsort(d["cam"], kind="stable")
        for k in keys:
            d[k] = np.ascontiguousarray(d[k][..., idx])
    if order == "by_camera_dead":
        dead = np.random.default_rng(seed).uniform(size=O) < 0.25
        d["h"] = np.where(dead, np.float32(0.0), d["h"])
    return d


@pytest.mark.parametrize("order", ["drawn", "by_camera", "by_camera_dead"])
def test_e0_scatter_structured(prob, order):
    """The composed step-1 scatter against the Pallas kernel, on the rows
    as drawn and in the camera-sorted lane order, with ~5% and with ~30%
    dead rows (t = h^T sb exactly zero: the kernel's guard)."""
    args = ("cam", "x", "h", "sb")
    d = _rows(prob, args, order)
    want = pp.e0_scatter_structured(*J(d, *args), N)
    got = pk.e0_scatter_structured(*T(d, *args), N)
    _close(got.numpy(), want, 1e-4)


def test_apply_ldiff(prob):
    args = ("cam", "x", "uv", "sw", "r_w", "jls", "inc_lm", "ct", "inc")
    want = float(np.asarray(
        pp.apply_ldiff(*J(prob, *args), alpha=ALPHA), np.float64
    ).sum())
    got = pk.apply_ldiff(*T(prob, *args), alpha=ALPHA)
    assert got.dtype == torch.float64 and got.shape == ()
    _close(float(got), want, 1e-4)


@pytest.mark.parametrize("parts", [PARTS, PREFIX], ids=["all", "prefix"])
def test_e0_term_parts(prob, parts):
    want = pp.e0_term_parts(
        jax_parts(parts, N, 13, prob["cam"], prob["x"], prob["h"]),
        jnp.asarray(prob["z"]), N,
    )
    got = pk.e0_term_parts(*T(prob, "cam", "x", "h", "z"), parts, N)
    _close(got.numpy(), want, 1e-4)


def test_e0_term_parts_is_the_composed_term(prob):
    """The fused term over slot parts equals e0_u -> per-landmark sum ->
    re-expansion -> e0_scatter (the composed term) over the same
    rows; measured 2.4e-7."""
    from povar_tpu_torch.solver.segments import (
        slot_part_sums, slot_row_expand,
    )

    t = dict(zip(prob, T(prob, *prob)))
    shapes = tuple((g, w) for _ofs, g, w in PARTS)
    u = pk.e0_u_structured(t["cam"], t["x"], t["h"], t["z"])
    sb = slot_row_expand(slot_part_sums(u, shapes), shapes)
    want = pk.e0_scatter_structured(t["cam"], t["x"], t["h"], sb, N)
    got = pk.e0_term_parts(t["cam"], t["x"], t["h"], t["z"], PARTS, N)
    _close(got.numpy(), want.numpy(), 1e-5)


def test_schur_diag_structured(prob):
    args = ("cam", "x", "h")
    want = pp.schur_diag_structured(*J(prob, *args), N)
    got = pk.schur_diag_structured(*T(prob, *args), N)
    _close(got.numpy(), want, 1e-4)


def _split(a):
    hi = a.astype(np.float32)
    return hi, (a - hi.astype(np.float64)).astype(np.float32)


@pytest.mark.parametrize("robust, tol", [(0, 1e-12), (1, 1e-8)],
                         ids=["none", "huber"])
def test_pose_error_vs_df32(prob, robust, tol):
    kw = dict(alpha=ALPHA, robust=robust, huber=1.0)
    ct_h, ct_l = _split(prob["ct64"])
    x_h, x_l = _split(prob["x64"])
    uv_h, uv_l = _split(prob["uv64"])
    part = np.asarray(pp.pose_error_df32(
        jnp.asarray(prob["cam"]), jnp.asarray(ct_h), jnp.asarray(ct_l),
        jnp.asarray(x_h), jnp.asarray(x_l), jnp.asarray(uv_h),
        jnp.asarray(uv_l), jnp.asarray(prob["mask"]), **kw,
    ))
    want_err = part[0].astype(np.float64).sum() + part[1].astype(np.float64).sum()
    want_rn = part[2].astype(np.float64).sum() + part[3].astype(np.float64).sum()
    err, rn, bad = pk.pose_error(*T(prob, "cam", "ct64", "x64", "uv64", "mask"),
                                 **kw)
    assert err.dtype == rn.dtype == torch.float64 and bad.dtype == torch.int32
    np.testing.assert_allclose(float(err), want_err, rtol=tol)
    np.testing.assert_allclose(float(rn), want_rn, rtol=1e-7)
    assert int(bad) == int(part[4].sum()) == 0

    # the exact f64 expression of the JAX package's f64 cost path
    # (stage1._compute_error without double-float)
    P = jnp.asarray(prob["ct64"].reshape(3, 4, N)[:, :, prob["cam"]])
    r = pose_math.pose_residual_t(
        P, jnp.asarray(prob["x64"]), jnp.asarray(prob["uv64"]), ALPHA
    )
    live = jnp.asarray(prob["mask"][0]) > 0
    r = jnp.where(live[None], r, 0.0)
    res_sq = jnp.sum(r * r, axis=0)
    e, _w = pose_math.robust_error_and_weight(res_sq, robust, 1.0)
    np.testing.assert_allclose(
        float(err), float(jnp.sum(jnp.where(live, e, 0.0))), rtol=1e-12
    )
    np.testing.assert_allclose(
        float(rn), float(jnp.sum(jnp.sqrt(res_sq))), rtol=1e-12
    )


def test_pose_error_counts_nonfinite(prob):
    x = prob["x64"].copy()
    live = np.nonzero(prob["mask"][0] > 0)[0]
    dead = np.nonzero(prob["mask"][0] == 0)[0]
    x[0, live[:3]] = np.nan
    x[1, dead[:2]] = np.inf  # dead rows never count
    _err, _rn, bad = pk.pose_error(
        *T(prob, "cam", "ct64"), torch.as_tensor(x),
        *T(prob, "uv64", "mask"), alpha=ALPHA, robust=0, huber=1.0,
    )
    assert int(bad) == 3


def test_cpu_wrappers_are_the_plain_versions(prob):
    """On CPU tensors every wrapper returns exactly what its plain
    version returns (and counts no launch: see _no_launches)."""
    t = dict(zip(prob, T(prob, *prob)))
    a = dict(alpha=ALPHA)
    calls = [
        ("prepare", (t["cam"], t["ct"], t["x"], t["uv"], t["mask"]),
         dict(robust=1, huber=1.0, **a)),
        ("e0_factor", (t["cam"], t["ct"], t["uv"], t["w"], t["jls"], t["lh"]), a),
        ("hpp_b_structured", (t["cam"], t["ct"], t["x"], t["uv"], t["sw"],
                              t["r_w"], t["jls"], t["hib"], N), a),
        ("e0_u_structured", (t["cam"], t["x"], t["h"], t["z"]), {}),
        ("e0_scatter_structured", (t["cam"], t["x"], t["h"], t["sb"], N), {}),
        ("apply_ldiff", (t["cam"], t["x"], t["uv"], t["sw"], t["r_w"],
                         t["jls"], t["inc_lm"], t["ct"], t["inc"]), a),
        ("pose_error", (t["cam"], t["ct64"], t["x64"], t["uv64"], t["mask"]),
         dict(robust=0, huber=1.0, **a)),
        ("e0_term_parts", (t["cam"], t["x"], t["h"], t["z"], PARTS, N), {}),
        ("schur_diag_structured", (t["cam"], t["x"], t["h"], N), {}),
        ("poba_t3", (t["cam"], t["ct"], t["x"], t["uv"], t["sw"], t["r_w"],
                     t["jls"], t["z"]), a),
        ("apply_ldiff_stored", (t["cam"], t["x"], t["uv"], t["sw"], t["r_w"],
                                t["jls"], t["inc_lm"], t["ct"], t["z"]), a),
    ]
    assert sorted(c[0] for c in calls) == sorted(pk.KERNELS)
    for name, args, kw in calls:
        got = getattr(pk, name)(*args, **kw)
        want = getattr(pose_ref, name)(*args, **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert torch.equal(g, w), name


def test_wrappers_check_shapes(prob):
    t = dict(zip(prob, T(prob, *prob)))
    with pytest.raises(ValueError, match="x"):
        pk.prepare(t["cam"], t["ct"], t["x"][:2], t["uv"], t["mask"],
                   alpha=ALPHA, robust=0, huber=1.0)
    with pytest.raises(ValueError, match="cam_table"):
        pk.hpp_b_structured(t["cam"], t["ct"], t["x"], t["uv"], t["sw"],
                            t["r_w"], t["jls"], t["hib"], N + 1, alpha=ALPHA)
    with pytest.raises(ValueError, match="parts"):
        pk.e0_term_parts(t["cam"], t["x"], t["h"], t["z"], ((768, 32, 16),),
                         N)
    with pytest.raises(ValueError, match="parts"):
        pk.e0_term_parts(t["cam"], t["x"], t["h"], t["z"], (), N)

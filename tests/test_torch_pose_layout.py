"""What Python hands the redesigned step-1 kernels of
povar_tpu_torch/csrc/pose1.cu, checked on the CPU.

- `hpp_b_structured` accumulates, per camera, b and 40 weighted moments
  of xh = [x, 1] (sum w k_t xh_i xh_j, k = (1, sp2 u, sp2 v,
  sp2 (u^2 + v^2)), i <= j) and expands them into hpp through the map
  step 2's `hppb2` uses (`pose_kernels.moment_expand_map`: step 1's K has
  the positions and signs of step 2's K3). Moments computed here in
  torch, row for row as the kernel forms them, and expanded through that
  map equal `pose_ref.hpp_b_structured`'s hpp and the JAX package's
  Pallas `hpp_b_structured` (interpret mode) per camera to f32 rounding:
  scaled by each camera's largest |entry| (tools/parity.py "cam"),
  within 1e-5, on three seeds and two alphas, with ~5% dead rows
  (sw = 0) and a HUBER-weighted sw.
- `e0_term_parts` runs one thread per slot row over the (part, tile)
  table both steps' fused terms share (`pose_kernels.tile_rows`): the
  kernel's two passes emulated here over that table (u per row, sb
  summed over the slot rows j = 0 .. w-1 in order, tt (x) xh added per
  camera where tt is not exactly zero) equal `pose_ref.e0_term_parts`
  and the JAX package's Pallas `e0_term_parts` per camera within 1e-5,
  and visit every (landmark, slot row) once, on the step-1 fused plans
  of tests/test_torch_e0_plan.py's layouts and on parts of three widths
  with ragged last tiles.
- `schur_diag_structured` accumulates, per camera, the 60 moments
  sum hth_s xh_i xh_j (hth = h^T h, s its upper triangle, i <= j) and
  expands them into the 144 rows through `pose_kernels.schur_expand_map`,
  which both steps' Schur-Jacobi kernels share. Moments computed here
  row for row as the kernel forms them and expanded through that map
  equal `pose_ref.schur_diag_structured` and the JAX package's Pallas
  `schur_diag_structured` (interpret mode) per camera within 1e-5, on
  three seeds with ~5% dead rows (h = 0); the map sends every row and
  its mirror to one moment.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from povar_tpu.ops import pallas_pose as pp
from povar_tpu_torch import SolverOptions, Stage1Solver
from povar_tpu_torch.ops import pose_kernels as pk
from povar_tpu_torch.ops import pose_ref
from povar_tpu_torch.tools.parity import scaled_error
from test_torch_e0_plan import _layout
from test_torch_pose2_layout import MIXED, _check_cover
from test_torch_pose_kernels import jax_parts

# one torch thread a test process: the CPU tests' tensors are small,
# and a parallel run's xdist workers share the host's cores
torch.set_num_threads(1)

O, N = 1024, 13
HUBER = 1.0
HPP_ARGS = ("cam", "ct", "x", "uv", "sw", "r_w", "jls", "hib")


def _operands(seed):
    """hpp_b_structured's operands over O rows and N cameras: ~5% dead
    rows (sw = 0, r_w = 0, as prepare leaves them) and sw the square root
    of a HUBER weight of |r_w| (below 1 on most rows)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    live = (rng.uniform(size=O) > 0.05).astype(f)
    r_w = rng.standard_normal((4, O)) * live
    w = np.minimum(1.0, HUBER / np.maximum(np.linalg.norm(r_w, axis=0),
                                           1e-30))
    d = dict(
        cam=rng.integers(0, N, O).astype(np.int32),
        ct=rng.standard_normal((12, N)).astype(f),
        x=rng.standard_normal((3, O)).astype(f),
        uv=rng.standard_normal((2, O)).astype(f),
        sw=(np.sqrt(w) * live).reshape(1, O).astype(f),
        r_w=r_w.astype(f),
        jls=rng.uniform(0.1, 1.0, (3, O)).astype(f),
        hib=rng.standard_normal((3, O)).astype(f),
    )
    assert (d["sw"] == 0).any() and ((d["sw"] > 0) & (d["sw"] < 1)).any()
    return d


def _moments(cam, x, uv, sw, alpha):
    """The kernel's 40 per-camera moments [40, N], row 10 t + p."""
    sp2 = pose_ref.pose_consts(alpha, torch.float32).sp2
    u, v = uv
    w = sw[0] * sw[0]
    kw = [w, w * (sp2 * u), w * (sp2 * v), w * (sp2 * (u * u + v * v))]
    xh = [x[0], x[1], x[2], torch.ones_like(u)]
    rows = torch.stack([kw[t] * (xh[i] * xh[j])
                        for t in range(4) for i, j in pk.MOMENT_PAIRS])
    return torch.zeros((40, N)).index_add_(1, cam.long(), rows)


def _expand(mom):
    """hpp [144, N] from the moments through moment_expand_map."""
    zero = torch.zeros_like(mom[0])
    return torch.stack([zero if e is None else e[1] * mom[e[0]]
                        for e in pk.moment_expand_map()])


@pytest.mark.parametrize("alpha", [0.01, 0.3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hpp_b_moments_expand_to_hpp(seed, alpha):
    d = _operands(seed)
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    got = _expand(_moments(t["cam"], t["x"], t["uv"], t["sw"], alpha))
    plain = pose_ref.hpp_b_structured(*(t[k] for k in HPP_ARGS), N,
                                      alpha=alpha)[0]
    tpu = torch.as_tensor(np.array(pp.hpp_b_structured(
        *(jnp.asarray(d[k]) for k in HPP_ARGS), N, alpha=alpha)[0]))
    assert scaled_error(got, plain, "cam") <= 1e-5
    assert scaled_error(got, tpu, "cam") <= 1e-5


def test_moment_map_holds_step1_k():
    """Step 1's K = [[1, 0, -sp2 u], [0, 1, -sp2 v], [-sp2 u, -sp2 v,
    sp2 (u^2 + v^2)]] is, entry for entry, the sign of the shared map
    times its weight k_t = (1, sp2 u, sp2 v, sp2 (u^2 + v^2)), and
    exactly 0 where the map has no moment."""
    sp2, u, v = 0.7, 0.3, -1.9
    k = (1.0, sp2 * u, sp2 * v, sp2 * (u * u + v * v))
    K = ((1.0, 0.0, -sp2 * u), (0.0, 1.0, -sp2 * v),
         (-sp2 * u, -sp2 * v, sp2 * (u * u + v * v)))
    m = pk.moment_expand_map()
    for a in range(3):
        for i in range(4):
            for b in range(3):
                for j in range(4):
                    e = m[(4 * a + i) * 12 + 4 * b + j]
                    want = 0.0 if e is None else e[1] * k[e[0] // 10]
                    assert want == K[a][b]
                    if e is not None:
                        assert pk.MOMENT_PAIRS[e[0] % 10] == (min(i, j),
                                                              max(i, j))


def _tile_term(cam, x, h, z, parts, n):
    """e0_term_parts as the kernel computes it, tile by tile over the
    table of tile_rows(parts): thread th of a tile holds slot row
    j = th // t of landmark column l = th % t. Returns (out [12, n], the
    (landmark, slot row, observation) each thread in a part visits)."""
    threads = pk.E0_TILE_THREADS
    rows, tiles = pk.tile_rows(parts, threads)
    table = np.asarray(rows).reshape(-1, len(pk.TILE_FIELDS))
    first = np.concatenate([[0], np.cumsum([g for _o, g, _w in parts])])
    zc = z[:, cam.long()]
    y = []
    for a in range(3):
        acc = zc[4 * a + 3]
        for i in range(3):
            acc = acc + x[i] * zc[4 * a + i]
        y.append(acc)
    u = torch.stack([h[c * 3] * y[0] + h[c * 3 + 1] * y[1]
                     + h[c * 3 + 2] * y[2] for c in range(3)])
    out = torch.zeros((12, n))
    th = np.arange(threads)
    seen = []
    for tile in range(tiles):
        p = int(np.searchsorted(table[:, 4], tile, side="right")) - 1
        ofs, g, w, t, tile0 = (int(v) for v in table[p])
        l, j = th % t, th // t
        lm = (tile - tile0) * t + l
        inside = (j < w) & (lm < g)
        o = torch.as_tensor(np.where(inside, ofs + j * g + lm, 0))
        su = u[:, o] * torch.as_tensor(inside)
        sb = su[:, l]
        for jj in range(1, w):
            sb = sb + su[:, jj * t + l]
        hv = h[:, o]
        tt = torch.stack([hv[a] * sb[0] + hv[3 + a] * sb[1]
                          + hv[6 + a] * sb[2] for a in range(3)])
        live = torch.as_tensor(inside) & (tt != 0).any(dim=0)
        xh = torch.cat([x[:, o], torch.ones((1, threads))])
        v = torch.stack([tt[a] * xh[i] for a in range(3) for i in range(4)])
        out.index_add_(1, cam[o[live]].long(), v[:, live])
        seen += [(first[p] + lm[k], j[k], ofs + j[k] * g + lm[k])
                 for k in np.flatnonzero(inside)]
    return out, seen


def _term_operands(o, n, mask, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(x=rng.standard_normal((3, o)).astype(f),
                h=(rng.standard_normal((9, o)) * mask).astype(f),
                z=rng.standard_normal((12, n)).astype(f))


def _check_tile_term(cam, d, parts, n):
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    cam_t = torch.as_tensor(cam)
    got, seen = _tile_term(cam_t, t["x"], t["h"], t["z"], parts, n)
    assert len(seen) == len(set(seen)) == sum(g * w for _o, g, w in parts)
    _check_cover(parts)
    plain = pose_ref.e0_term_parts(cam_t, t["x"], t["h"], t["z"], parts, n)
    tpu = torch.as_tensor(np.array(pp.e0_term_parts(
        jax_parts(parts, n, 13, cam, d["x"], d["h"]), jnp.asarray(d["z"]),
        n)))
    assert scaled_error(got, plain, "cam") <= 1e-5
    assert scaled_error(got, tpu, "cam") <= 1e-5


@pytest.mark.parametrize("layout", ["narrow", "wide_suffix", "all_dead"])
def test_tile_term_on_step1_plans(layout):
    args, _want = _layout(layout)
    s = Stage1Solver(*args, SolverOptions(device_lm_loop="off"),
                     device="cpu")
    cam = s.obs.cam.numpy()
    d = _term_operands(cam.shape[0], s.n_cams, s._mask1.numpy(), 4)
    _check_tile_term(cam, d, tuple(s.e0_plan.parts), s.n_cams)


@pytest.mark.parametrize("parts", [MIXED, MIXED[1:], ((0, 1, 16),)],
                         ids=["three_widths", "two_widths", "one_landmark"])
def test_tile_term_on_mixed_widths(parts):
    """Ragged last tiles: 100, 37 and 29 landmarks against tiles of
    E0_TILE_THREADS // w, ~5% of the rows dead (h = 0)."""
    rng = np.random.default_rng(5)
    mask = (rng.uniform(size=O) > 0.05).astype(np.float32)
    cam = rng.integers(0, N, O).astype(np.int32)
    _check_tile_term(cam, _term_operands(O, N, mask, 6), parts, N)


def _schur_operands(seed):
    """schur_diag_structured's operands over O rows and N cameras: ~5%
    dead rows (h = 0, as the E0 factor is on masked rows)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    live = (rng.uniform(size=O) > 0.05).astype(f)
    d = dict(cam=rng.integers(0, N, O).astype(np.int32),
             x=rng.standard_normal((3, O)).astype(f),
             h=(rng.standard_normal((9, O)) * live).astype(f))
    assert (live == 0).any()
    return d


def schur_moments(H, xh, cam, live):
    """The Schur-Jacobi kernels' 60 per-camera moments [60, N], row
    10 s + p: H[s] (xh_i xh_j) of the live rows, H the upper triangle
    (SCHUR_PAIRS order) of each row's symmetric 3x3 and (i, j) =
    MOMENT_PAIRS[p]."""
    xx = [xh[i] * xh[j] for i, j in pk.MOMENT_PAIRS]
    rows = torch.stack([H[s] * xx[p] for s in range(len(pk.SCHUR_PAIRS))
                        for p in range(len(pk.MOMENT_PAIRS))])
    return torch.zeros((pk.SCHUR_MOMENTS, N)).index_add_(
        1, cam[live].long(), rows[:, live])


def expand_schur(mom):
    """[144, N] from the Schur moments through schur_expand_map."""
    return torch.stack([mom[m] for m in pk.schur_expand_map()])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_schur_moments_expand_to_corr(seed):
    d = _schur_operands(seed)
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    h = t["h"]
    H = [h[a] * h[b] + h[3 + a] * h[3 + b] + h[6 + a] * h[6 + b]
         for a, b in pk.SCHUR_PAIRS]
    live = torch.stack(H).ne(0).any(dim=0)
    assert not live.all()
    xh = [t["x"][0], t["x"][1], t["x"][2], torch.ones(O)]
    got = expand_schur(schur_moments(H, xh, t["cam"], live))
    plain = pose_ref.schur_diag_structured(t["cam"], t["x"], h, N)
    tpu = torch.as_tensor(np.array(pp.schur_diag_structured(
        *(jnp.asarray(d[k]) for k in ("cam", "x", "h")), N)))
    assert scaled_error(got, plain, "cam") <= 1e-5
    assert scaled_error(got, tpu, "cam") <= 1e-5


def test_schur_expand_map_mirrors():
    """Row (4a+i)*12 + 4b+j and its mirror (4b+j)*12 + 4a+i go to one
    moment, 10 s + p for the sorted pairs (a, b) and (i, j); all 60
    moments are used; the int32 table is moment + 1."""
    m = pk.schur_expand_map()
    assert len(m) == 144 and sorted(set(m)) == list(range(pk.SCHUR_MOMENTS))
    for a in range(3):
        for i in range(4):
            for b in range(3):
                for j in range(4):
                    e = m[(4 * a + i) * 12 + 4 * b + j]
                    assert e == m[(4 * b + j) * 12 + 4 * a + i]
                    assert pk.SCHUR_PAIRS[e // 10] == (min(a, b), max(a, b))
                    assert pk.MOMENT_PAIRS[e % 10] == (min(i, j), max(i, j))
    table = pk.schur_expand_table(torch.device("cpu"))
    assert table.dtype == torch.int32
    assert table.tolist() == [e + 1 for e in m]

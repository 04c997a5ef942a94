"""What Python hands the redesigned step-2 kernels of
povar_tpu_torch/csrc/pose2.cu, checked on the CPU.

- `hppb2` accumulates, per camera, b12 and 40 weighted moments of x4
  (sum wz2 k x4_i x4_j, k in (1, mx, my, mx^2 + my^2), i <= j) and
  expands them into hpp12 through `pose_kernels.moment_expand_map` (the
  kernel reads its int32 form, `moment_expand_table`). Moments computed
  here in torch, row for row as the kernel forms them, and expanded
  through that map equal `pose2_ref.hppb2`'s hpp12 and the JAX package's
  Pallas `hppb2` (interpret mode) per camera to f32 rounding: scaled by
  each camera's largest |entry| (tools/parity.py "cam"), within 1e-5
  (measured <= 3.9e-7), on three seeds with dead rows (sw = 0, mm = 0, as
  prepare2 leaves them) and near-plane rows (1/p2 ~ 1e4).
- `e0_term2_parts` walks a (part, tile) table (`pose_kernels.tile_rows`)
  with one thread per slot row; enumerating its tiles with the kernel's
  index arithmetic covers every (landmark, slot row) of a part list once,
  each landmark's rows in slot order, on the fused plans of
  tests/test_torch_e0_plan.py's layouts and on parts of three widths with
  ragged last tiles.
- `schur_diag2` accumulates, per camera, the 60 moments sum H_s x4_i
  x4_j (H = (sw/p2)^2 C^T B B^T C, s its upper triangle, i <= j) and
  expands them through `pose_kernels.schur_expand_map`, as step 1's
  `schur_diag_structured` does. Moments computed here row for row as the
  kernel forms them and expanded through that map equal
  `pose2_ref.schur_diag2` and the JAX package's Pallas `schur_diag2`
  (interpret mode) per camera within 1e-5, on three seeds with dead rows
  (sw = 0, mm = 0) and near-plane rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from povar_tpu.ops import pallas_pose2 as pp2
from povar_tpu_torch import SolverOptions, Stage1Solver, Stage2Solver
from povar_tpu_torch.ops import pose_kernels as pk
from povar_tpu_torch.ops import pose2_ref
from povar_tpu_torch.tools.parity import scaled_error
from test_torch_e0_plan import _layout

# one torch thread a test process: the CPU tests' tensors are small,
# and a parallel run's xdist workers share the host's cores
torch.set_num_threads(1)

O, N = 1024, 13
# slot parts of three widths whose last tiles are ragged
MIXED = ((0, 100, 3), (300, 37, 7), (559, 29, 16))


def _operands(seed):
    """hppb2's operands over O rows and N cameras: ~5% dead rows (sw = 0
    and mm = 0), 1/p2 in [0.1, 0.5] and on ~1% of the rows near-plane
    (1/p2 of magnitude 1e3-1e4)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    live = (rng.uniform(size=O) > 0.05).astype(f)
    zinv = rng.uniform(0.1, 0.5, O)
    near = rng.uniform(size=O) < 0.01
    zinv[near] = rng.choice([-1.0, 1.0], near.sum()) * 10.0 ** rng.uniform(
        3, 4, near.sum())
    mm = np.stack([rng.standard_normal(O), rng.standard_normal(O), zinv])
    d = dict(
        cam=rng.integers(0, N, O).astype(np.int32),
        x4=rng.standard_normal((4, O)).astype(f),
        mm=(mm * live).astype(f),
        sw=(rng.uniform(0.5, 1.0, (1, O)) * live).astype(f),
        r_w=(rng.standard_normal((2, O)) * live).astype(f),
        jlns=rng.standard_normal((6, O)).astype(f),
        hib=rng.standard_normal((3, O)).astype(f),
    )
    assert (d["sw"] == 0).any() and near.any()
    return d


def _moments(cam, x4, mm, sw):
    """The kernel's 40 per-camera moments [40, N], row 10 t + p."""
    mx, my, zinv = mm
    swz = sw[0] * zinv
    wz2 = swz * swz
    kw = [wz2, wz2 * mx, wz2 * my, wz2 * (mx * mx + my * my)]
    rows = torch.stack([kw[t] * (x4[i] * x4[j])
                        for t in range(4) for i, j in pk.MOMENT_PAIRS])
    return torch.zeros((40, N)).index_add_(1, cam.long(), rows)


def _expand(mom):
    """hpp12 [144, N] from the moments through moment_expand_map."""
    zero = torch.zeros_like(mom[0])
    return torch.stack([zero if e is None else e[1] * mom[e[0]]
                        for e in pk.moment_expand_map()])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hppb2_moments_expand_to_hpp12(seed):
    d = _operands(seed)
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    got = _expand(_moments(t["cam"], t["x4"], t["mm"], t["sw"]))
    args = ("cam", "x4", "mm", "sw", "r_w", "jlns", "hib")
    plain = pose2_ref.hppb2(*(t[k] for k in args), N)[0]
    tpu = torch.as_tensor(np.array(
        pp2.hppb2(*(jnp.asarray(d[k]) for k in args), N)[0]))
    assert scaled_error(got, plain, "cam") <= 1e-5
    assert scaled_error(got, tpu, "cam") <= 1e-5


def test_hppb2_expand_map_is_k3():
    """The 144 rows: the (0,1) and (1,0) 3x3 blocks of K3 structurally
    zero, every other row one moment with K3's sign, each moment used by
    the transposed entry too, and the int32 table its signed form."""
    m = pk.moment_expand_map()
    assert len(m) == 144 and sum(e is None for e in m) == 32
    for a in range(3):
        for i in range(4):
            for b in range(3):
                for j in range(4):
                    e = m[(4 * a + i) * 12 + 4 * b + j]
                    assert (e is None) == ({a, b} == {0, 1})
                    assert e == m[(4 * b + j) * 12 + 4 * a + i]
                    if e is not None:
                        assert e[1] == (-1 if 2 in (a, b) and a != b else 1)
    table = pk.moment_expand_table(torch.device("cpu"))
    assert table.dtype == torch.int32
    assert table.tolist() == [0 if e is None else e[1] * (e[0] + 1)
                              for e in m]
    assert sorted({abs(v) for v in table.tolist()} - {0}) == list(
        range(1, 41))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_schur2_moments_expand_to_corr12(seed):
    from test_torch_pose_layout import expand_schur, schur_moments

    d = _operands(seed)
    d["mat6"] = np.random.default_rng(seed + 10).standard_normal(
        (6, O)).astype(np.float32)
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    m, (mx, my, zinv), sw = t["mat6"], t["mm"], t["sw"][0]
    g00 = m[0] * m[0] + m[1] * m[1] + m[2] * m[2]
    g11 = m[3] * m[3] + m[4] * m[4] + m[5] * m[5]
    g01 = m[0] * m[3] + m[1] * m[4] + m[2] * m[5]
    swz = sw * zinv
    wz2 = swz * swz
    cg = [[g00, g01], [g01, g11],
          [-(mx * g00 + my * g01), -(mx * g01 + my * g11)]]
    one, zero = torch.ones(O), torch.zeros(O)
    cc = [[one, zero], [zero, one], [-mx, -my]]
    H = [wz2 * (cg[a][0] * cc[b][0] + cg[a][1] * cc[b][1])
         for a, b in pk.SCHUR_PAIRS]
    live = sw != 0
    assert not live.all()
    got = expand_schur(schur_moments(H, list(t["x4"]), t["cam"], live))
    args = ("cam", "x4", "mm", "sw", "mat6")
    plain = pose2_ref.schur_diag2(*(t[k] for k in args), N)
    tpu = torch.as_tensor(np.array(
        pp2.schur_diag2(*(jnp.asarray(d[k]) for k in args), N)))
    assert scaled_error(got, plain, "cam") <= 1e-5
    assert scaled_error(got, tpu, "cam") <= 1e-5


def _tile_cover(parts, threads):
    """Every (landmark, slot row) the kernel's threads visit, in the
    kernel's index arithmetic over the table of tile_rows(parts)."""
    rows, tiles = pk.tile_rows(parts, threads)
    entries = np.asarray(rows).reshape(-1, len(pk.TILE_FIELDS))
    first = np.concatenate([[0], np.cumsum([g for _o, g, _w in parts])])
    seen = []
    for tile in range(tiles):
        p = int(np.searchsorted(entries[:, 4], tile, side="right")) - 1
        ofs, g, w, t, tile0 = entries[p]
        assert t * w <= threads
        for th in range(threads):
            lm, j = (tile - tile0) * t + th % t, th // t
            if j < w and lm < g:
                seen.append((first[p] + lm, j, ofs + j * g + lm))
    return seen


def _check_cover(parts):
    seen = _tile_cover(parts, pk.E0_TILE_THREADS)
    want = sorted((first + lm, j, ofs + j * g + lm)
                  for (ofs, g, w), first in zip(
                      parts, np.cumsum([0] + [g for _o, g, _w in parts]))
                  for lm in range(g) for j in range(w))
    assert sorted(seen) == want
    assert len(set(r for _l, _j, r in seen)) == len(seen)


@pytest.mark.parametrize("stage", [1, 2])
@pytest.mark.parametrize("layout", ["narrow", "wide_suffix", "all_dead"])
def test_tile_table_covers_the_fused_plans(layout, stage):
    args, _want = _layout(layout)
    s = (Stage1Solver if stage == 1 else Stage2Solver)(
        *args, SolverOptions(device_lm_loop="off"), device="cpu")
    parts = tuple(s.e0_plan.parts)
    _check_cover(parts)
    table, tiles = pk.e0_tile_table(parts, torch.device("cpu"))
    assert (table.tolist(), tiles) == pk.tile_rows(parts,
                                                   pk.E0_TILE_THREADS)


@pytest.mark.parametrize("parts", [MIXED, MIXED[1:], ((0, 1, 16),)],
                         ids=["three_widths", "two_widths", "one_landmark"])
def test_tile_table_covers_mixed_widths(parts):
    """Ragged last tiles: 100, 37 and 29 landmarks against tiles of
    E0_TILE_THREADS // w."""
    assert any(g % (pk.E0_TILE_THREADS // w) for _o, g, w in parts)
    _check_cover(parts)


def test_tile_table_refuses_a_width_past_a_block():
    with pytest.raises(ValueError, match="width"):
        pk.tile_rows(((0, 2, pk.E0_TILE_THREADS + 1),), pk.E0_TILE_THREADS)

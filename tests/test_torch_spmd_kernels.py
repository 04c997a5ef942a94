"""The SPMD window layout's plan and slot reduce/expand in the port
(povar_tpu_torch/parallel/spmd.py, ops/spmd_ref.py, ops/spmd_kernels.py)
against the JAX package's (povar_tpu/parallel/spmd.py,
povar_tpu/ops/pallas_spmd.py), on the CPU.

- The plan: `build_spmd_plan` and `build_uniform_combine` must give the
  JAX package's arrays, field by field and exactly (every field of the
  port's plan; it leaves out the JAX plan's TPU window maps), on the
  geometry of
  tests/test_spmd.py (`_local_problem`: locality, loop closures that
  overflow their window, scrambled camera ids) at D = 1, 2 and 8, on its
  unobserved-landmark case, on a venice-89-like problem at D = 1, and
  past 1,024 cameras at D = 1, 2 and 4 (N = 1300 without and N = 2048
  with loop closures).
- The three plain versions against the Pallas kernels in interpret mode
  (through JAX's `spmd_part_sums` / `spmd_expand_rows` /
  `spmd_reduce_reexpand`) on tests/test_pallas_spmd.py's two-class
  LAYOUT with leading shapes (), (4,) and (3, 3): exactly equal (both
  add the w slot elements left to right).
- The CUDA kernels' layout table (ops/spmd_kernels.layout_table),
  walked here as the kernels walk it, one work item at a time, against
  the plain versions: every lane and row of the layout is reached once.
  The kernels themselves run on the card (tests/test_torch_cuda.py,
  chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from povar_tpu.parallel import spmd as jspmd
from povar_tpu.problem.synthetic import (
    add_loop_closures_and_scramble,
    synthetic_bal_problem_fast,
)
from povar_tpu_torch.ops import launches, spmd_kernels, spmd_ref
from povar_tpu_torch.parallel import spmd as tspmd
from test_pallas_spmd import LAYOUT as JAX_LAYOUT
from test_spmd import _local_problem

import jax.numpy as jnp

# one torch thread a test process: the CPU tests' tensors are small,
# and a parallel run's xdist workers share the host's cores
torch.set_num_threads(1)

LAYOUT = tuple(tspmd.ClassLayout(*cl) for cl in JAX_LAYOUT)
O_DEV, N_ROWS = spmd_ref.layout_sizes(LAYOUT)


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors go to the plain versions: no kernel launch counted."""
    launches.reset_launch_counts()
    yield
    counts = launches.launch_counts()
    assert len(counts) == 34 and not any(counts.values()), counts


def _same_plan(obs_cam, obs_lm, n_cams, n_lms, n_dev):
    """Both packages' plan and combine reduce on one input, compared
    field by field."""
    a = jspmd.build_spmd_plan(obs_cam, obs_lm, n_cams, n_lms, n_dev, 4096)
    b = tspmd.build_spmd_plan(obs_cam, obs_lm, n_cams, n_lms, n_dev,
                              tspmd.PART_ALIGN)
    assert set(tspmd.SpmdPlan._fields) == set(jspmd.SpmdPlan._fields) - {
        "cam_local", "kmap", "win_gather", "win_scatter"}
    for f in tspmd.SpmdPlan._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f
        else:
            assert x == y, f
    ca = jspmd.build_uniform_combine(a.row_lm_ext, n_dev, a.n_rows_dev,
                                     a.m_dev)
    cb = tspmd.build_uniform_combine(b.row_lm_ext, n_dev, b.n_rows_dev,
                                     b.m_dev)
    assert len(ca.idx) == len(cb.idx) == len(cb.mask)
    for x, y in zip(ca.idx + ca.mask + (ca.inv_order,),
                    cb.idx + cb.mask + (cb.inv_order,)):
        assert np.array_equal(np.asarray(x), y.numpy())
    return b


@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_plan_matches_jax_on_overflow_geometry(n_dev):
    rng = np.random.default_rng(0)
    obs_cam, obs_lm, _uv, n_lms = _local_problem(rng, 700, 160)
    plan = _same_plan(obs_cam, obs_lm, 700, n_lms, n_dev)
    # the loop closures overflow their windows: a second class of grid
    # clones, landmarks owning several rows
    assert plan.has_duplicates and len(plan.layout) == 2


def test_plan_matches_jax_with_unobserved_landmarks():
    """tests/test_spmd.py's case: two landmarks without observations
    keep (all-fake) slot rows."""
    rng = np.random.default_rng(3)
    obs_cam, obs_lm, _uv, n_lms = _local_problem(rng, 200, 60)
    plan = _same_plan(obs_cam, obs_lm, 200, n_lms + 2, 8)
    assert plan.lm_mask.sum() == n_lms + 2


def test_plan_matches_jax_venice_like():
    """The venice-89 geometry (synthetic_bal_problem_fast, 89 cameras,
    five observations per landmark) on one device: one class, one part
    of width 5, no overflow."""
    p = synthetic_bal_problem_fast(89, 2000, 5, seed=0)
    plan = _same_plan(p.obs_cam, p.obs_lm, 89, 2000, 1)
    assert not plan.has_duplicates
    assert [cl.parts for cl in plan.layout] == [((1536, 5),)]


def _problem_past_1024(case):
    """(obs_cam, obs_lm, cameras, landmarks) of a plan past the TPU's
    1,024-camera one-hot limit: tests/test_torch_large_n.py's N = 1300
    local-span problem on ring cameras, or 2,048 cameras of a
    locality-32 problem with 1% loop closures and scrambled camera ids
    (add_loop_closures_and_scramble), whose closures overflow their
    windows."""
    if case == "local-1300":
        from test_torch_large_n import N_CAMS, N_LMS, _ring_problem

        (obs_cam, obs_lm, _uv, n_cams, n_lms), _c, _l = _ring_problem(
            N_CAMS, N_LMS)
        return obs_cam, obs_lm, n_cams, n_lms
    p = add_loop_closures_and_scramble(
        synthetic_bal_problem_fast(2048, 20_000, 5, seed=1, locality=32),
        0.01, seed=2)
    return p.obs_cam, p.obs_lm, p.num_cameras, p.num_landmarks


@pytest.mark.parametrize("case, n_dev", [
    (case, n_dev) for case in ("local-1300", "loops-2048")
    for n_dev in (1, 2, 4)])
def test_plan_matches_jax_past_1024_cameras(case, n_dev):
    """Past 1,024 cameras the port's plan (built with array operations
    where the JAX package's steps through rows in Python) is the JAX
    package's, array for array, with its combine reduce; the loop
    closures give the grid class and landmarks owning several rows."""
    obs_cam, obs_lm, n_cams, n_lms = _problem_past_1024(case)
    plan = _same_plan(obs_cam, obs_lm, n_cams, n_lms, n_dev)
    assert n_cams > 1024
    loops = case == "loops-2048"
    assert plan.has_duplicates == loops and len(plan.layout) == 1 + loops
    assert int(plan.pad_weight.sum()) == len(obs_cam)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("lead", [(), (4,), (3, 3)])
def test_part_sums_plain_equals_pallas(lead):
    x = _x(lead + (O_DEV,), 0)
    want = np.asarray(jspmd.spmd_part_sums(jnp.asarray(x), JAX_LAYOUT))
    got = tspmd.spmd_part_sums(torch.as_tensor(x), LAYOUT).numpy()
    assert got.shape == lead + (N_ROWS,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lead", [(), (4,), (3, 3)])
def test_expand_rows_plain_equals_pallas(lead):
    rows = _x(lead + (N_ROWS,), 1)
    want = np.asarray(jspmd.spmd_expand_rows(jnp.asarray(rows), JAX_LAYOUT))
    got = tspmd.spmd_expand_rows(torch.as_tensor(rows), LAYOUT).numpy()
    assert got.shape == lead + (O_DEV,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lead", [(), (4,), (3, 3)])
def test_reduce_reexpand_plain_equals_pallas(lead):
    x = _x(lead + (O_DEV,), 2)
    want = np.asarray(
        jspmd.spmd_reduce_reexpand(jnp.asarray(x), JAX_LAYOUT))
    got = tspmd.spmd_reduce_reexpand(torch.as_tensor(x), LAYOUT).numpy()
    np.testing.assert_array_equal(got, want)


def test_f64_operands_take_the_plain_formulation():
    """An f64 operand never reaches a kernel in f64. The f64 state
    expanded for the cost goes through the f32 expansion as its hi and
    lo halves, and comes back as hi + lo: what the JAX package's
    double-float cost expands (stage1._compute_error_df32), bit for bit,
    and within 2^-48 of the f64 copy. An f64 reduce on the CPU is the
    plain version's left-to-right sum."""
    rows = np.random.default_rng(3).standard_normal((2, N_ROWS))
    hi = rows.astype(np.float32)
    lo = (rows - hi.astype(np.float64)).astype(np.float32)
    want = (np.asarray(jspmd.spmd_expand_rows(jnp.asarray(hi), JAX_LAYOUT),
                       np.float64)
            + np.asarray(jspmd.spmd_expand_rows(jnp.asarray(lo), JAX_LAYOUT),
                         np.float64))
    got = tspmd.spmd_expand_rows(torch.as_tensor(rows), LAYOUT)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)
    exact = np.asarray(jspmd.spmd_expand_rows(jnp.asarray(rows), JAX_LAYOUT))
    np.testing.assert_allclose(got.numpy(), exact, rtol=2.0**-48, atol=0)
    x = np.random.default_rng(4).standard_normal((2, O_DEV))
    np.testing.assert_allclose(
        tspmd.spmd_part_sums(torch.as_tensor(x), LAYOUT).numpy(),
        np.asarray(jspmd.spmd_part_sums(jnp.asarray(x), JAX_LAYOUT)),
        rtol=1e-15, atol=1e-15)


def _walk_table(layout, tails, src, out, mode):
    """The CUDA kernels' loop (csrc/spmd.cu spmd_kernel) over the work
    items of ops/spmd_kernels.layout_table, in numpy, for one leading
    row: each item finds its entry by the work0 prefix, reads its row or
    its w lanes (summed left to right) and writes its w lanes or its
    row; a tail entry (w = 0) writes one zero lane. Returns (work items,
    entries)."""
    table, n_entries, work = spmd_kernels.layout_table(layout, tails, "cpu")
    t = table.numpy().reshape(n_entries, len(spmd_kernels.TABLE_FIELDS))
    for item in range(work):
        e = int(np.searchsorted(t[:, 6], item, side="right")) - 1
        lane0, stride, cap, w, _n, row0, work0 = (int(v) for v in t[e])
        win, r = divmod(item - work0, cap)
        lane = lane0 + win * stride + r
        row = row0 + win * cap + r
        if w == 0:
            out[lane] = 0.0
            continue
        if mode == "expand":
            v = src[row]
        else:
            v = src[lane]
            for s in range(1, w):
                v = np.float32(v + src[lane + s * cap])
        if mode == "part_sums":
            out[row] = v
        else:
            out[lane + np.arange(w) * cap] = v
    return work, n_entries


@pytest.mark.parametrize("mode", ["part_sums", "expand", "reexpand"])
def test_layout_table_walk_matches_plain(mode):
    """Every lane and slot row of the two-class LAYOUT is reached by
    exactly one work item of the kernels' table, and the walk computes
    the plain versions' results (part sums, the expansion with its zero
    tails, the fused reduce-reexpand)."""
    tails = mode != "part_sums"
    if mode == "expand":
        src = _x((N_ROWS,), 5)
        want = spmd_ref.class_expand_rows(torch.as_tensor(src)[None],
                                          LAYOUT)[0]
    else:
        src = _x((O_DEV,), 6)
        fn = (spmd_ref.class_part_sums if mode == "part_sums"
              else spmd_ref.class_reduce_reexpand)
        want = fn(torch.as_tensor(src)[None], LAYOUT)[0]
    out = np.full(want.shape, np.nan, np.float32)
    work, n_entries = _walk_table(LAYOUT, tails, src, out, mode)
    tail_lanes = O_DEV - sum(cl.n_windows * sum(c * w for c, w in cl.parts)
                             for cl in LAYOUT)
    # one entry per part, plus one per class with a tail (both have one)
    assert n_entries == 3 + (2 if tails else 0)
    assert work == N_ROWS + (tail_lanes if tails else 0)
    np.testing.assert_array_equal(out, want.numpy())

"""povar_tpu_torch's numpy-side modules against povar_tpu's: options,
synthetic problems, the slot and padded-reduce planners and their torch
reductions, residual accounting, `from_numpy`, and the jax-free import.

Both packages get the same numpy inputs; plans and generated arrays must
be bit-identical, reductions equal up to f32/f64 summation order."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from povar_tpu import options as jopts
from povar_tpu.problem import synthetic as jsyn
from povar_tpu.solver import common as jcommon
from povar_tpu.solver import segments as jseg
from povar_tpu_torch import options as topts
from povar_tpu_torch.problem import from_numpy
from povar_tpu_torch.problem import synthetic as tsyn
from povar_tpu_torch.solver import common as tcommon
from povar_tpu_torch.solver import segments as tseg

# one torch thread a test process: the CPU tests' tensors are small,
# and a parallel run's xdist workers share the host's cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "cls", ["SolverOptions", "BalResidualOptions", "BalDatasetOptions"]
)
def test_options_fields_and_defaults_match(cls):
    jf = dataclasses.fields(getattr(jopts, cls))
    tf = dataclasses.fields(getattr(topts, cls))
    assert [f.name for f in jf] == [f.name for f in tf]
    jd = jopts.options_to_dict(getattr(jopts, cls)())
    td = topts.options_to_dict(getattr(topts, cls)())
    assert jd == td
    assert {k: v for k, v in jopts.OPTION_META[getattr(jopts, cls)].items()} == {
        k: v for k, v in topts.OPTION_META[getattr(topts, cls)].items()
    }


def test_options_toml_matches():
    assert topts.options_to_toml(topts.BalAppOptions()) == (
        jopts.options_to_toml(jopts.BalAppOptions())
    )


@pytest.mark.parametrize(
    "kind, kwargs",
    [
        ("slow", dict(n_cams=8, n_lms=60, obs_per_lm=5, seed=7)),
        ("slow", dict(n_cams=12, n_lms=90, obs_per_lm=4, noise=0.5, seed=3)),
        ("fast", dict(n_cams=89, n_lms=500, obs_per_lm=5, seed=0)),
        ("fast", dict(n_cams=40, n_lms=300, obs_per_lm=6, seed=2,
                      noise=0.1, locality=10)),
    ],
)
def test_synthetic_bit_identical(kind, kwargs):
    if kind == "slow":
        (jp, jgt), (tp, tgt) = (
            jsyn.synthetic_bal_problem(**kwargs),
            tsyn.synthetic_bal_problem(**kwargs),
        )
        np.testing.assert_array_equal(jgt, tgt)
    else:
        jp = jsyn.synthetic_bal_problem_fast(**kwargs)
        tp = tsyn.synthetic_bal_problem_fast(**kwargs)
    for f in ("cam_space", "intrinsics", "lm_p", "obs_cam", "obs_lm",
              "obs_uv"):
        a, b = getattr(jp, f), getattr(tp, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert jp.input_path == tp.input_path


def _obs_lm(case):
    rng = np.random.default_rng(11)
    if case == "uniform":
        return np.repeat(np.arange(50), 5).astype(np.int32), 50
    if case == "mixed":
        counts = rng.integers(2, 9, 80)
        counts[[3, 17]] = [70, 130]  # wider than SLOT_EXACT_MAX
        return np.repeat(np.arange(80), counts).astype(np.int32), 80
    counts = rng.integers(0, 6, 40)  # unobserved landmarks too
    lm = np.repeat(np.arange(40), counts).astype(np.int32)
    return rng.permutation(lm), 40


@pytest.mark.parametrize("case", ["uniform", "mixed", "shuffled"])
@pytest.mark.parametrize("pad_to", [1, 512, 8192])
def test_build_slot_plan_identical(case, pad_to):
    obs_lm, m = _obs_lm(case)
    jp = jseg.build_slot_plan(obs_lm, m, pad_to=pad_to)
    tp = tseg.build_slot_plan(obs_lm, m, pad_to=pad_to)
    perm, pad_w, shapes, lm_order, lm_inv = tp
    np.testing.assert_array_equal(perm, jp[0])
    np.testing.assert_array_equal(pad_w, jp[1])
    assert shapes == jp[2]
    np.testing.assert_array_equal(lm_order, jp[3])
    np.testing.assert_array_equal(lm_inv, jp[4])


@pytest.mark.parametrize("case", ["mixed", "shuffled"])
def test_slot_reductions_match_jax(case):
    """slot_part_sums / slot_segment_sum / slot_row_expand / slot_expand
    on a random [2, O_pad] array: f64 sums agree to rounding, expansions
    exactly."""
    obs_lm, m = _obs_lm(case)
    _perm, _w, shapes, lm_order, lm_inv = tseg.build_slot_plan(
        obs_lm, m, pad_to=512
    )
    o = sum(g * w for g, w in shapes)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, o))
    rows = rng.standard_normal((2, len(lm_order)))
    s = rng.standard_normal((2, m))
    tx, jx = torch.as_tensor(x), jnp.asarray(x)
    np.testing.assert_allclose(
        tseg.slot_part_sums(tx, shapes).numpy(),
        jseg.slot_part_sums(jx, shapes), rtol=1e-13, atol=1e-13,
    )
    np.testing.assert_allclose(
        tseg.slot_segment_sum(tx, shapes, torch.as_tensor(lm_inv).long()).numpy(),
        jseg.slot_segment_sum(jx, shapes, jnp.asarray(lm_inv)),
        rtol=1e-13, atol=1e-13,
    )
    np.testing.assert_array_equal(
        tseg.slot_row_expand(torch.as_tensor(rows), shapes).numpy(),
        jseg.slot_row_expand(jnp.asarray(rows), shapes),
    )
    np.testing.assert_array_equal(
        tseg.slot_expand(torch.as_tensor(s), shapes,
                         torch.as_tensor(lm_order).long()).numpy(),
        jseg.slot_expand(jnp.asarray(s), shapes, jnp.asarray(lm_order)),
    )


@pytest.mark.parametrize("n_seg", [1, 13, 89])
def test_padded_reduce_matches_jax(n_seg):
    rng = np.random.default_rng(n_seg)
    seg = rng.integers(0, n_seg, 700).astype(np.int32)
    jr = jseg._build_padded_reduce(seg, n_seg)
    tr = tseg._build_padded_reduce(seg, n_seg)
    assert len(jr.idx) == len(tr.idx)
    for a, b in zip(jr.idx, tr.idx):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(jr.mask, tr.mask):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(jr.inv_order), tr.inv_order.numpy())
    x = rng.standard_normal((3, 700))
    np.testing.assert_allclose(
        tseg.padded_segment_sum(torch.as_tensor(x), tr).numpy(),
        jseg.padded_segment_sum(jnp.asarray(x), jr), rtol=1e-13, atol=1e-13,
    )


def test_padded_reduce_skips_ids_outside_the_segments():
    """Ids below 0 or at num_segments and past it belong to no segment,
    in both packages: the same buckets, the same sums."""
    rng = np.random.default_rng(5)
    seg = rng.integers(-3, 16, 500).astype(np.int32)
    jr = jseg._build_padded_reduce(seg, 13)
    tr = tseg._build_padded_reduce(seg, 13)
    for a, b in zip(jr.idx + jr.mask + (jr.inv_order,),
                    tr.idx + tr.mask + (tr.inv_order,)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    x = rng.standard_normal((2, 500))
    np.testing.assert_allclose(
        tseg.padded_segment_sum(torch.as_tensor(x), tr).numpy(),
        jseg.padded_segment_sum(jnp.asarray(x), jr), rtol=1e-13, atol=1e-13,
    )


def test_residual_accounting_matches_jax():
    rng = np.random.default_rng(2)
    err = rng.uniform(0, 3, 200)
    rn = rng.uniform(0, 2, 200)
    valid = rng.uniform(size=200) > 0.2
    finite = rng.uniform(size=200) > 0.01
    jd = jcommon.accumulate_residual_info(
        jnp.asarray(err), jnp.asarray(rn), jnp.asarray(valid),
        jnp.asarray(finite), num_obs_all=190,
    )
    td = tcommon.accumulate_residual_info(
        torch.as_tensor(err), torch.as_tensor(rn), torch.as_tensor(valid),
        torch.as_tensor(finite), num_obs_all=190,
    )
    ji = jcommon.ResidualInfo.from_device(jd)
    ti = tcommon.ResidualInfo.from_device(td)
    assert ti.all.num_obs == ji.all.num_obs == 190
    assert ti.valid.num_obs == ji.valid.num_obs
    assert ti.is_numerically_valid == ji.is_numerically_valid
    for a, b in ((ti.all, ji.all), (ti.valid, ji.valid)):
        np.testing.assert_allclose(a.error, b.error, rtol=1e-13)
        np.testing.assert_allclose(a.residual_sum, b.residual_sum, rtol=1e-13)
    for first in (False, True):
        assert tcommon.error_summary_oneline(ti, first) == (
            jcommon.error_summary_oneline(ji, first)
        )


def test_from_numpy_roundtrip():
    p = tsyn.synthetic_bal_problem_fast(9, 40, 4, seed=1)
    prob, cams, lms = from_numpy(
        p.obs_cam, p.obs_lm, p.obs_uv, p.cam_space, p.lm_p, device="cpu"
    )
    assert cams.dtype == lms.dtype == torch.float64
    np.testing.assert_array_equal(cams.numpy(), p.cam_space)
    np.testing.assert_array_equal(lms.numpy(), p.lm_p)
    for f in ("obs_cam", "obs_lm", "obs_uv", "cam_space", "lm_p"):
        np.testing.assert_array_equal(getattr(prob, f), getattr(p, f))
    assert prob.num_cameras == 9 and prob.num_landmarks == 40
    _, c32, _ = from_numpy(p.obs_cam, p.obs_lm, p.obs_uv, p.cam_space,
                           p.lm_p, device="cpu", dtype=torch.float32)
    assert c32.dtype == torch.float32
    with pytest.raises(ValueError):
        from_numpy(p.obs_cam, p.obs_lm, p.obs_uv, p.cam_space[:, :2],
                   p.lm_p, device="cpu")


def test_import_leaves_jax_out():
    code = (
        "import sys, povar_tpu_torch, povar_tpu_torch.solver.lm, "
        "povar_tpu_torch.ops.pose_kernels, povar_tpu_torch.cli, "
        "povar_tpu_torch.parallel.spmd, povar_tpu_torch.parallel.mesh, "
        "povar_tpu_torch.ops.spmd_kernels; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m.startswith('povar_tpu.') or m == 'povar_tpu']; "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_bal_text_io_matches_jax(tmp_path):
    """The port's numpy copies of `write_bal_text` and the BAL reader:
    the same bytes written for the same problem, the same arrays read
    back, and `create_dataset` writes the same randomized file."""
    from povar_tpu.problem import bal_io as jbal
    from povar_tpu_torch.problem import bal_io as tbal

    p, _ = jsyn.synthetic_bal_problem(n_cams=5, n_lms=30, obs_per_lm=3,
                                      seed=4)
    args = (p.num_cameras, p.num_landmarks, p.obs_cam, p.obs_lm, p.obs_uv)
    jsyn.write_bal_text(str(tmp_path / "j.txt"), *args, lm_p=p.lm_p)
    tsyn.write_bal_text(str(tmp_path / "t.txt"), *args, lm_p=p.lm_p)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    for got, want in zip(tbal.load_bal_text(str(tmp_path / "t.txt")),
                         jbal.load_bal_text(str(tmp_path / "j.txt"))):
        np.testing.assert_array_equal(got, want)
    jout = jbal.create_dataset(str(tmp_path / "j.txt"), str(tmp_path / "jd"))
    tout = tbal.create_dataset(str(tmp_path / "t.txt"), str(tmp_path / "td"))
    with open(jout, "rb") as fj, open(tout, "rb") as ft:
        assert ft.read() == fj.read()

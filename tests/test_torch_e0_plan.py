"""The fused power-term plan of povar_tpu_torch against povar_tpu's.

`solver/slots.plan_e0_fused` decides where the fused E0 kernels run:
the prefix of slot parts of width <= E0_TERM_MAX_W, a composed suffix
from the first wider part on (dropped when it holds no live row), and no
plan at all when the suffix carries half or more of the live work or no
row is live. On the four layouts of tests/test_e0_fused.py (all narrow;
a wide suffix; a suffix with most of the work; all rows dead) the port's
parts, cut and suffix shapes must equal the JAX package's
`_e0_meta` / `_e0_suffix` exactly, in both stage solvers, and each
part's landmark-major view of the port's observation layout must be the
camera block the JAX kernels read (`_e0_cam2`, before its lane padding).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from povar_tpu.options import SolverOptions as JaxOptions
from povar_tpu.problem.synthetic import synthetic_bal_problem_fast
from povar_tpu.solver.stage1 import Stage1Solver as JaxStage1
from povar_tpu.solver.stage2 import Stage2Solver as JaxStage2
from povar_tpu_torch import SolverOptions, Stage1Solver, Stage2Solver
from povar_tpu_torch.solver.slots import E0_TERM_MAX_W, plan_e0_fused


def _with_wide_landmark(p, extra, seed):
    """`p`'s observations plus `extra` more of landmark 0
    (tests/test_e0_fused.py's wide layouts)."""
    rng = np.random.default_rng(seed)
    oc = np.concatenate([p.obs_cam, rng.integers(0, p.num_cameras, extra)])
    ol = np.concatenate([p.obs_lm, np.zeros(extra, np.int64)])
    uv = np.concatenate([p.obs_uv, rng.standard_normal((extra, 2)) * 0.3])
    return oc, ol, uv


def _layout(name):
    """(stage-solver arguments, expected (fused plan?, suffix?))."""
    if name == "narrow":
        p = synthetic_bal_problem_fast(23, 400, 4, seed=1)
        obs, want = (p.obs_cam, p.obs_lm, p.obs_uv), (True, False)
    elif name == "wide_suffix":
        p = synthetic_bal_problem_fast(23, 300, 4, seed=2)
        obs, want = _with_wide_landmark(p, 2 * E0_TERM_MAX_W + 5, 3), (True,
                                                                       True)
    elif name == "suffix_dominates":
        p = synthetic_bal_problem_fast(23, 50, 4, seed=4)
        obs, want = _with_wide_landmark(p, 300, 5), (False, None)
    else:
        p = synthetic_bal_problem_fast(8, 60, 4, seed=5)
        obs, want = (p.obs_cam, p.obs_lm, p.obs_uv), (True, False)
    return (*obs, p.num_cameras, p.num_landmarks), want


def _jax_plan(js):
    """The JAX solver's plan in the port's form: (parts, suffix) with
    parts (ofs, g, w) and suffix (cut, shapes), or None."""
    if js._e0_meta is None:
        return None
    parts = tuple((ofs, g, w) for ofs, g, w, _gt, _gp in js._e0_meta)
    suffix = None if js._e0_suffix is None else js._e0_suffix[:2]
    return parts, suffix


@pytest.mark.parametrize("stage", [1, 2])
@pytest.mark.parametrize(
    "layout", ["narrow", "wide_suffix", "suffix_dominates", "all_dead"]
)
def test_fused_plan_matches_jax(layout, stage):
    args, (fused, suffix) = _layout(layout)
    jo = JaxOptions(pallas_kernels="on", device_lm_loop="off")
    js = (JaxStage1 if stage == 1 else JaxStage2)(*args, jo)
    ts = (Stage1Solver if stage == 1 else Stage2Solver)(
        *args, SolverOptions(device_lm_loop="off"), device="cpu"
    )
    assert tuple(ts.lm_shapes) == tuple(js.lm_shapes)
    if layout == "all_dead":
        # every observation weight zero: both plans are declined
        w = np.zeros(js.obs.cam.shape[0], np.float32)
        js.obs = js.obs._replace(weight=jnp.asarray(w))
        js._e0_meta = js._e0_cam2 = js._e0_suffix = None
        js._plan_e0_fused()
        assert js._e0_meta is None
        assert plan_e0_fused(ts.lm_shapes, w) is None
        assert ts.e0_plan is not None  # the live layout itself is fused
        return
    want = _jax_plan(js)
    got = ts.e0_plan
    assert (want is not None) == fused and (got is not None) == fused
    if not fused:
        return
    assert (tuple(got.parts), got.suffix) == want
    assert (got.suffix is not None) == suffix
    if suffix:
        assert max(w for _g, w in got.suffix[1]) > E0_TERM_MAX_W
    cam = ts.obs.cam.numpy()
    for (ofs, g, w), c2 in zip(got.parts, js._e0_cam2):
        np.testing.assert_array_equal(
            cam[ofs:ofs + g * w].reshape(w, g), np.asarray(c2)[:, :g]
        )


def test_plan_without_weights_counts_every_row_live():
    """weight None (no pad tail) is every row live, as in the JAX plan:
    a wide part carrying half the rows declines the plan, one carrying
    less keeps it with its suffix."""
    assert plan_e0_fused(((4, 2), (1, 8), (1, E0_TERM_MAX_W + 1)), None) \
        is None
    plan = plan_e0_fused(((8, 4), (1, E0_TERM_MAX_W + 1)), None)
    assert plan.parts == ((0, 8, 4),)
    assert plan.suffix == (32, ((1, E0_TERM_MAX_W + 1),))

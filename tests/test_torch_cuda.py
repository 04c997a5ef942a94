"""povar_tpu_torch on the card: each CUDA kernel against its plain
PyTorch version on the same CUDA tensors, and the step-1 slice on the
card against the same slice on the CPU.

Every test here is marked `cuda` and skips without a CUDA device. The
file imports nothing of JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(`--noconftest` skips tests/conftest.py, which configures JAX for the
rest of the suite.) chip_smoke.py runs the kernel check at the
venice-89 shapes; this file runs it at the CPU tests' small shapes
(O = 1024, N = 13, as tests/test_torch_pose_kernels.py) and at
N = 1024, where `hpp_b_structured` takes its global-atomic route.

Tolerances, relative to the largest magnitude of each output:
elementwise outputs 1e-5 (FMA contraction only); per-camera sums and
l_diff 1e-4 (the order of f32 atomics); the f64 cost 1e-12.
"""

import numpy as np
import pytest
import torch

from povar_tpu_torch import (
    SolverOptions,
    SolverSummary,
    Stage1Solver,
    Timer,
    optimize_step1,
    synthetic_bal_problem,
)
from povar_tpu_torch.ops import pose_kernels as pk
from povar_tpu_torch.ops import pose_ref

ALPHA = 0.01
O = 1024
ELEM, SUM, F64 = 1e-5, 1e-4, 1e-12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernels)")
    return torch.device("cuda")


def _inputs(n_cams, device, seed=7):
    rng = np.random.default_rng(seed)
    f = np.float32
    mask = (rng.uniform(size=(1, O)) > 0.05).astype(f)
    sw = (rng.uniform(0.5, 1.0, (1, O)) * mask).astype(f)
    ct = rng.standard_normal((12, n_cams))
    d = dict(
        cam=rng.integers(0, n_cams, O).astype(np.int32),
        ct=ct.astype(f), x=rng.standard_normal((3, O)).astype(f),
        uv=rng.standard_normal((2, O)).astype(f), mask=mask, sw=sw,
        w=sw * sw, r_w=(rng.standard_normal((4, O)) * mask).astype(f),
        jls=rng.uniform(0.1, 1.0, (3, O)).astype(f),
        hib=rng.standard_normal((3, O)).astype(f),
        lh=rng.standard_normal((9, O)).astype(f),
        h=(rng.standard_normal((9, O)) * mask).astype(f),
        z=rng.standard_normal((12, n_cams)).astype(f),
        sb=rng.standard_normal((3, O)).astype(f),
        inc=rng.standard_normal((12, n_cams)).astype(f),
        inc_lm=rng.standard_normal((3, O)).astype(f),
        ct64=ct, x64=rng.standard_normal((3, O)),
        uv64=rng.standard_normal((2, O)),
    )
    return {k: torch.as_tensor(v, device=device) for k, v in d.items()}


def _cases(t, n):
    a = dict(alpha=ALPHA)
    return [
        ("prepare", (t["cam"], t["ct"], t["x"], t["uv"], t["mask"]),
         dict(robust=1, huber=1.0, **a), [ELEM] * 4 + [SUM]),
        ("e0_factor", (t["cam"], t["ct"], t["uv"], t["w"], t["jls"],
                       t["lh"]), a, [ELEM]),
        ("hpp_b_structured", (t["cam"], t["ct"], t["x"], t["uv"], t["sw"],
                              t["r_w"], t["jls"], t["hib"], n), a,
         [SUM, SUM]),
        ("e0_u_structured", (t["cam"], t["x"], t["h"], t["z"]), {}, [ELEM]),
        ("e0_scatter_structured", (t["cam"], t["x"], t["h"], t["sb"], n),
         {}, [SUM]),
        ("apply_ldiff", (t["cam"], t["x"], t["uv"], t["sw"], t["r_w"],
                         t["jls"], t["inc_lm"], t["ct"], t["inc"]), a, [SUM]),
        ("pose_error", (t["cam"], t["ct64"], t["x64"], t["uv64"],
                        t["mask"]), dict(robust=1, huber=1.0, **a),
         [F64, F64, 0.0]),
    ]


def _close(name, got, want, tol):
    got = got.double().cpu().numpy()
    want = want.double().cpu().numpy()
    assert got.shape == want.shape, name
    assert np.isfinite(got).all(), name
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (name, err, np.abs(want).max())


@pytest.mark.cuda
@pytest.mark.parametrize("n_cams", [13, 1024])
def test_kernels_match_plain_versions(cuda, n_cams):
    """Each kernel once per call, counted once, within its tolerance."""
    t = _inputs(n_cams, cuda)
    for name, args, kw, tols in _cases(t, n_cams):
        pk.reset_launch_counts()
        got = getattr(pk, name)(*args, **kw)
        torch.cuda.synchronize()
        assert pk.launch_counts()[name] == 1, name
        want = getattr(pose_ref, name)(*args, **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w, tol in zip(got, want, tols):
            _close(name, g, w, tol)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    t = _inputs(13, cuda)
    with pytest.raises(TypeError, match="cam"):
        pk.e0_u_structured(t["cam"].long(), t["x"], t["h"], t["z"])
    with pytest.raises(TypeError, match="x"):
        pk.e0_u_structured(t["cam"], t["x"].double(), t["h"], t["z"])
    with pytest.raises(ValueError, match="contiguous"):
        pk.e0_u_structured(t["cam"], t["x"].T.contiguous().T, t["h"],
                           t["z"])
    with pytest.raises(ValueError, match="one CUDA device"):
        pk.e0_u_structured(t["cam"], t["x"].cpu(), t["h"], t["z"])


@pytest.mark.cuda
def test_step1_slice_card_matches_cpu(cuda):
    """Six LM iterations of the slice on the card and on the CPU (plain
    versions): identical decisions and power-term counts, costs within
    1e-3 (f32 inner solves in another summation order), and every
    kernel launched on the card."""
    problem, _ = synthetic_bal_problem(n_cams=8, n_lms=60, obs_per_lm=5,
                                       seed=7)
    opts = SolverOptions()
    opts.max_num_iterations_step_1 = 6
    opts.fused_power_term = False
    opts.device_lm_loop = "off"
    trajs = {}
    for dev in ("cuda", "cpu"):
        solver = Stage1Solver(
            problem.obs_cam, problem.obs_lm, problem.obs_uv,
            problem.num_cameras, problem.num_landmarks, opts, device=dev,
        )
        pk.reset_launch_counts()
        summary = SolverSummary()
        optimize_step1(
            solver, torch.as_tensor(problem.cam_space, device=dev),
            torch.as_tensor(problem.lm_p, device=dev), opts, summary,
            Timer(), log=lambda s: None,
        )
        counts = pk.launch_counts()
        if dev == "cuda":
            assert min(counts.values()) > 0, counts
        else:
            assert max(counts.values()) == 0, counts
        trajs[dev] = [
            (it.step_is_successful, it.linear_solver_iterations,
             it.cost.all.error)
            for it in summary.iterations
        ]
    assert len(trajs["cuda"]) == len(trajs["cpu"])
    for (ok_g, n_g, c_g), (ok_c, n_c, c_c) in zip(trajs["cuda"], trajs["cpu"]):
        assert (ok_g, n_g) == (ok_c, n_c)
        np.testing.assert_allclose(c_g, c_c, rtol=1e-3)

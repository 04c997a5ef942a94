"""Synthetic BAL-style problem generation for tests and benchmarks.

A numpy-only copy of three generators and `write_bal_text` in
povar_tpu/problem/synthetic.py: the same seed gives bit-identical
arrays in both packages. `synthetic_bal_problem_adversarial` makes the
structure that overflows camera windows (loop closures, scrambled
camera ids), which the SPMD window layout's checks run on.

The reference repository ships no data (examples/ is empty) and expects
BAL downloads (scripts/download-bal-problems.sh). These generators
synthesize problems with realistic SfM structure instead:
cameras on a ring looking inward at a Gaussian point cloud, projected
through ideal projective cameras to produce consistent observations.

`synthetic_bal_problem` returns the *initialization-free* setup that the
reference's --create-dataset + load_bal_eccv pipeline produces: random
N(0,1) camera matrices with third row [0,0,0,1], random N(0,1)
landmarks, and real (consistent) observations. Ground-truth cameras are
returned separately for tests that need a known optimum.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from povar_tpu_torch.problem.problem import BalProblem


def _ring_cameras(n_cams: int, radius: float, rng) -> np.ndarray:
    """World-to-camera projective matrices for cameras on a ring looking
    at the origin. Returns [N, 3, 4]."""
    mats = np.zeros((n_cams, 3, 4))
    for i in range(n_cams):
        angle = 2 * np.pi * i / n_cams + 0.01 * rng.standard_normal()
        center = np.array(
            [
                radius * np.cos(angle),
                radius * np.sin(angle),
                0.3 * radius * np.sin(2.3 * angle),
            ]
        )
        forward = -center / np.linalg.norm(center)
        up = np.array([0.0, 0.0, 1.0])
        right = np.cross(forward, up)
        right /= np.linalg.norm(right)
        up2 = np.cross(right, forward)
        R = np.stack([right, up2, forward])  # rows: cam x, y, z in world
        t = -R @ center
        mats[i, :, :3] = R
        mats[i, :, 3] = t
    return mats


def synthetic_bal_problem(
    n_cams: int = 12,
    n_lms: int = 200,
    obs_per_lm: int = 6,
    noise: float = 0.0,
    seed: int = 0,
    random_cameras: bool = True,
) -> Tuple[BalProblem, np.ndarray]:
    """Build a synthetic problem.

    Returns (problem, gt_cam_space). If random_cameras (the
    initialization-free default), problem.cam_space are N(0,1) matrices
    with third row [0,0,0,1] as produced by --create-dataset
    (bal_problem.cpp:398-409); otherwise ground truth cameras are used.
    """
    rng = np.random.default_rng(seed)
    gt_cams = _ring_cameras(n_cams, radius=10.0, rng=rng)
    pts = rng.standard_normal((n_lms, 3)) * 2.0

    obs_cam_list = []
    obs_lm_list = []
    obs_uv_list = []
    for j in range(n_lms):
        k = min(n_cams, max(2, int(obs_per_lm + rng.integers(-2, 3))))
        cams = np.sort(rng.choice(n_cams, size=k, replace=False))
        xh = np.append(pts[j], 1.0)
        for c in cams:
            p = gt_cams[c] @ xh
            if abs(p[2]) < 1e-6:
                continue
            uv = p[:2] / p[2]
            if noise > 0:
                uv = uv + rng.normal(0.0, noise, size=2)
            obs_cam_list.append(c)
            obs_lm_list.append(j)
            obs_uv_list.append(uv)

    obs_cam = np.array(obs_cam_list, dtype=np.int32)
    obs_lm = np.array(obs_lm_list, dtype=np.int32)
    obs_uv = np.array(obs_uv_list, dtype=np.float64)

    # drop landmarks with < 2 surviving observations, reindex
    counts = np.bincount(obs_lm, minlength=n_lms)
    keep = counts >= 2
    new_idx = np.cumsum(keep) - 1
    sel = keep[obs_lm]
    obs_cam, obs_uv = obs_cam[sel], obs_uv[sel]
    obs_lm = new_idx[obs_lm[sel]].astype(np.int32)
    pts = pts[keep]

    if random_cameras:
        cam_space = np.zeros_like(gt_cams)
        cam_space[:, 0, :] = rng.standard_normal((n_cams, 4))
        cam_space[:, 1, :] = rng.standard_normal((n_cams, 4))
        cam_space[:, 2, :] = np.array([0.0, 0.0, 0.0, 1.0])
        lm_p = rng.standard_normal((pts.shape[0], 3))
    else:
        cam_space = gt_cams.copy()
        lm_p = pts.copy()

    problem = BalProblem(
        cam_space=cam_space,
        intrinsics=np.tile(np.array([1.0, 0.0, 0.0]), (n_cams, 1)),
        lm_p=lm_p,
        obs_cam=obs_cam,
        obs_lm=obs_lm,
        obs_uv=obs_uv,
        input_path=f"synthetic-{n_cams}-{pts.shape[0]}",
    )
    problem.sort_observations()
    return problem, gt_cams


def synthetic_bal_problem_fast(
    n_cams: int,
    n_lms: int,
    obs_per_lm: int,
    seed: int = 0,
    noise: float = 0.0,
    locality: int = 0,
) -> BalProblem:
    """Fully vectorized large-scale synthetic problem (fixed obs count
    per landmark) for benchmarks at venice/final scale, in the
    initialization-free configuration (random cameras + landmarks).

    `locality > 0` draws each landmark's cameras from a window of that
    width around a random center — the temporal coherence real BAL
    sequences have (a landmark is seen by nearby frames), which the
    large-N camera-window solver layout exploits
    (segments.build_window_plan). 0 = cameras uniform over [0, N)."""
    rng = np.random.default_rng(seed)
    gt_cams = _ring_cameras(n_cams, radius=10.0, rng=rng)
    pts = rng.standard_normal((n_lms, 3)) * 2.0

    k = min(obs_per_lm, n_cams)
    # k distinct cameras per landmark, O(M*k) memory: draw k values in
    # [0, span - k], sort rows, add arange(k) -> strictly increasing
    # (mildly biased toward spread-out cameras; fine for benchmarks)
    span = n_cams if not locality else min(max(locality, k), n_cams)
    base = rng.integers(0, span - k + 1, size=(n_lms, k))
    base.sort(axis=1)
    cams_per_lm = base + np.arange(k)[None, :]
    if locality and span < n_cams:
        centers = rng.integers(0, n_cams - span + 1, size=(n_lms, 1))
        cams_per_lm = cams_per_lm + centers

    obs_lm = np.repeat(np.arange(n_lms, dtype=np.int32), k)
    obs_cam = cams_per_lm.reshape(-1).astype(np.int32)
    xh = np.concatenate([pts, np.ones((n_lms, 1))], axis=1)  # [M, 4]
    p = np.einsum("oij,oj->oi", gt_cams[obs_cam], xh[obs_lm])
    obs_uv = p[:, :2] / p[:, 2:3]
    if noise > 0:
        obs_uv = obs_uv + rng.normal(0.0, noise, size=obs_uv.shape)

    cam_space = np.zeros_like(gt_cams)
    cam_space[:, 0, :] = rng.standard_normal((n_cams, 4))
    cam_space[:, 1, :] = rng.standard_normal((n_cams, 4))
    cam_space[:, 2, :] = np.array([0.0, 0.0, 0.0, 1.0])

    problem = BalProblem(
        cam_space=cam_space,
        intrinsics=np.tile(np.array([1.0, 0.0, 0.0]), (n_cams, 1)),
        lm_p=rng.standard_normal((n_lms, 3)),
        obs_cam=obs_cam,
        obs_lm=obs_lm,
        obs_uv=obs_uv,
        input_path=f"synthetic-fast-{n_cams}-{n_lms}",
    )
    # already sorted by (lm, cam)
    return problem


def synthetic_bal_problem_adversarial(
    n_cams: int,
    n_lms: int,
    mean_obs_per_lm: float = 6.0,
    loop_closure_frac: float = 0.01,
    seed: int = 0,
) -> BalProblem:
    """Adversarial counterpart of `synthetic_bal_problem_fast`: the
    structure distributions that stress the camera-window layout
    instead of flattering it.

    - **Heavy-tailed observation counts**: per-landmark counts are
      drawn from a Zipf-weighted bucket set {2,3,4,6,8,12,16,24,32,48}
      scaled to the requested mean — a few landmarks carry dozens of
      observations while the mode stays small, like real SfM tracks.
    - **Mixed camera spans**: each landmark's span is drawn from
      {tight 24, medium 96, wide 384} (70/25/5), so no single window
      width fits everything.
    - **Loop closures**: `loop_closure_frac` of landmarks observe
      cameras strided across the ENTIRE camera range (global span) —
      the structure that forces the span-overflow grid-cell path.
    - **Scrambled camera ids**: a random permutation destroys index
      locality; only RCM reordering over the true adjacency
      (reference bal_problem.cpp:268-303) can recover it.

    Fully vectorized (per-k-bucket batch generation), so it runs at
    venice/final scale. Cameras/landmarks are the initialization-free
    N(0,1) configuration."""
    rng = np.random.default_rng(seed)
    gt_cams = _ring_cameras(n_cams, radius=10.0, rng=rng)
    pts = rng.standard_normal((n_lms, 3)) * 2.0

    ks = np.array([2, 3, 4, 6, 8, 12, 16, 24, 32, 48])
    ks = ks[ks <= n_cams]
    w = 1.0 / ks.astype(np.float64) ** 1.1  # Zipf-ish bucket weights
    w /= w.sum()
    # scale weights toward the requested mean by tempering
    for _ in range(40):
        mean = float((w * ks).sum())
        w = w * np.exp((mean_obs_per_lm - mean) * ks / ks.max() * 0.1)
        w /= w.sum()
    k_per_lm = rng.choice(ks, size=n_lms, p=w)

    spans = np.array([24, 96, 384])
    spans = np.minimum(spans, n_cams)
    span_per_lm = rng.choice(spans, size=n_lms, p=[0.70, 0.25, 0.05])
    span_per_lm = np.maximum(span_per_lm, k_per_lm)
    n_loop = int(loop_closure_frac * n_lms)
    loop_ids = rng.choice(n_lms, size=n_loop, replace=False)
    span_per_lm[loop_ids] = n_cams  # global span

    obs_lm_parts, obs_cam_parts = [], []
    for k in np.unique(k_per_lm):
        sel = np.nonzero(k_per_lm == k)[0]
        span = span_per_lm[sel]  # [m_b], all >= k
        # k distinct cameras within each landmark's span (sorted-base
        # + arange trick, per-row span)
        base = (
            rng.random((len(sel), k)) * (span - k + 1)[:, None]
        ).astype(np.int64)
        base.sort(axis=1)
        cams = base + np.arange(k)[None, :]
        centers = (
            rng.random(len(sel)) * (n_cams - span + 1)
        ).astype(np.int64)
        cams = cams + centers[:, None]
        obs_lm_parts.append(np.repeat(sel.astype(np.int32), k))
        obs_cam_parts.append(cams.reshape(-1).astype(np.int32))

    obs_lm = np.concatenate(obs_lm_parts)
    obs_cam = np.concatenate(obs_cam_parts)
    order = np.argsort(obs_lm, kind="stable")
    obs_lm, obs_cam = obs_lm[order], obs_cam[order]

    # scramble camera ids LAST (observations keep true co-visibility)
    scramble = rng.permutation(n_cams).astype(np.int32)
    obs_cam = scramble[obs_cam]
    gt_scr = np.empty_like(gt_cams)
    gt_scr[scramble] = gt_cams

    xh = np.concatenate([pts, np.ones((n_lms, 1))], axis=1)
    p = np.einsum("oij,oj->oi", gt_scr[obs_cam], xh[obs_lm])
    obs_uv = p[:, :2] / p[:, 2:3]

    cam_space = np.zeros_like(gt_cams)
    cam_space[:, 0, :] = rng.standard_normal((n_cams, 4))
    cam_space[:, 1, :] = rng.standard_normal((n_cams, 4))
    cam_space[:, 2, :] = np.array([0.0, 0.0, 0.0, 1.0])

    return BalProblem(
        cam_space=cam_space,
        intrinsics=np.tile(np.array([1.0, 0.0, 0.0]), (n_cams, 1)),
        lm_p=rng.standard_normal((n_lms, 3)),
        obs_cam=obs_cam,
        obs_lm=obs_lm,
        obs_uv=obs_uv,
        input_path=f"synthetic-adversarial-{n_cams}-{n_lms}",
    )


def write_bal_text(
    path: str,
    n_cams: int,
    n_lms: int,
    obs_cam: np.ndarray,
    obs_lm: np.ndarray,
    obs_uv: np.ndarray,
    cam_params9: Optional[np.ndarray] = None,
    lm_p: Optional[np.ndarray] = None,
) -> None:
    """Write an original-format BAL text file (for exercising the
    --create-dataset path and cross-checking against the reference)."""
    n_obs = len(obs_cam)
    if cam_params9 is None:
        cam_params9 = np.zeros((n_cams, 9))
        cam_params9[:, 6] = 1.0  # f
    if lm_p is None:
        lm_p = np.zeros((n_lms, 3))
    with open(path, "w") as f:
        f.write(f"{n_cams} {n_lms} {n_obs}\n")
        for i in range(n_obs):
            f.write(
                f"{obs_cam[i]} {obs_lm[i]} "
                f"{obs_uv[i, 0]:.6e} {obs_uv[i, 1]:.6e}\n"
            )
        for i in range(n_cams):
            for v in cam_params9[i]:
                f.write(f"{v:.16e}\n")
        for i in range(n_lms):
            for v in lm_p[i]:
                f.write(f"{v:.16e}\n")

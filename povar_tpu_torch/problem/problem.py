"""Flat array problem representation (a numpy-only copy of
povar_tpu/problem/problem.py, so that this package never imports jax),
plus `from_numpy`, which moves a problem's state onto a torch device.

The reference stores cameras/landmarks as C++ object vectors with
per-landmark `std::map<FrameIdx, Observation>` (bal/bal_problem.hpp:65-339).
The representation here is struct-of-arrays, observation-major:

  cam_space   [N, 3, 4]  projective camera matrices (`space_matrix`)
  intrinsics  [N, 3]     [f, k1, k2] (unused by the pOSE/projective
                         residuals, kept for format parity)
  lm_p        [M, 3]     euclidean landmarks (step 1 state)
  lm_p_h      [M, 4]     homogeneous landmarks (step 2 state)
  obs_cam     [O] int32  camera index per observation
  obs_lm      [O] int32  landmark index per observation
  obs_uv      [O, 2]     measurement (y already inverted at load,
                         bal_problem.cpp:236-244)

Observations are sorted by (landmark, camera), matching the reference's
iteration order (landmark vector order, then std::map camera order).
Per-camera / per-landmark reductions are `segment_sum`s over obs_cam /
obs_lm — the TPU replacement for the reference's mutex-guarded scatter.

Host-side state is numpy (f64); device arrays are materialized by the
solver. Backup/restore (bal_problem.hpp backup_pOSE/restore_pOSE etc.)
is implicit: the solver's LM loop keeps the previous state pytree and
simply discards the trial state on rejection (functional style).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch


@dataclass
class DatasetSummary:
    """bal/bal_pipeline_summary.hpp:42-61."""

    type: str = "bal"
    input_path: str = ""
    num_cameras: int = 0
    num_landmarks: int = 0
    num_observations: int = 0
    rcs_sparsity: float = 0.0
    per_lm_obs_mean: float = 0.0
    per_lm_obs_min: float = 0.0
    per_lm_obs_max: float = 0.0
    per_lm_obs_stddev: float = 0.0


@dataclass
class BalProblem:
    cam_space: np.ndarray  # [N, 3, 4] f64
    intrinsics: np.ndarray  # [N, 3] f64
    lm_p: np.ndarray  # [M, 3] f64
    obs_cam: np.ndarray  # [O] i32
    obs_lm: np.ndarray  # [O] i32
    obs_uv: np.ndarray  # [O, 2] f64
    lm_p_h: Optional[np.ndarray] = None  # [M, 4] f64 (created before step 2)
    input_path: str = ""

    @property
    def num_cameras(self) -> int:
        return int(self.cam_space.shape[0])

    @property
    def num_landmarks(self) -> int:
        return int(self.lm_p.shape[0])

    @property
    def num_observations(self) -> int:
        return int(self.obs_cam.shape[0])

    def sort_observations(self) -> None:
        """Order observations by (landmark, camera) — the reference's
        canonical iteration order."""
        order = np.lexsort((self.obs_cam, self.obs_lm))
        self.obs_cam = np.ascontiguousarray(self.obs_cam[order])
        self.obs_lm = np.ascontiguousarray(self.obs_lm[order])
        self.obs_uv = np.ascontiguousarray(self.obs_uv[order])

    def normalize(self, new_scale: float = 100.0) -> None:
        """Median + MAD rescaling of the map (bal_problem.cpp:484-526).

        Note: the reference also re-centers the *legacy* SE3 poses, which
        the PoVar pipeline never reads (it operates on `space_matrix`);
        only the landmark transform is observable, so that is what we do.
        Like the reference we use the "n/2 order statistic" median.
        """
        m = self.num_landmarks
        mid = m // 2
        median = np.partition(self.lm_p, mid, axis=0)[mid]
        dev = np.abs(self.lm_p - median).sum(axis=1)
        mad = np.partition(dev, mid)[mid]
        scale = new_scale / mad
        self.lm_p = scale * (self.lm_p - median)

    def perturb(
        self,
        rotation_sigma: float,
        translation_sigma: float,
        landmark_sigma: float,
        seed: int,
    ) -> None:
        """Gaussian state perturbation (bal_problem.cpp:565-611).

        rotation/translation perturb the legacy SE3 poses in the
        reference, which the PoVar solve never reads; only
        `landmark_sigma` is observable.
        """
        if landmark_sigma > 0:
            rng = np.random.default_rng(seed if seed >= 0 else None)
            self.lm_p = self.lm_p + rng.normal(
                0.0, landmark_sigma, size=self.lm_p.shape
            )

    def filter_obs(self, threshold: float) -> None:
        """Drop observations with landmark z < threshold, then landmarks
        with < 2 observations (bal_problem.cpp:528-563; with identity
        legacy poses the camera-frame depth is the world z)."""
        if threshold <= 0:
            return
        keep = self.lm_p[self.obs_lm, 2] >= threshold
        self.obs_cam = self.obs_cam[keep]
        self.obs_lm = self.obs_lm[keep]
        self.obs_uv = self.obs_uv[keep]
        counts = np.bincount(self.obs_lm, minlength=self.num_landmarks)
        keep_lm = counts >= 2
        new_idx = np.full(self.num_landmarks, -1, dtype=np.int64)
        new_idx[keep_lm] = np.arange(int(keep_lm.sum()))
        keep_obs = keep_lm[self.obs_lm]
        self.obs_cam = np.ascontiguousarray(self.obs_cam[keep_obs])
        self.obs_uv = np.ascontiguousarray(self.obs_uv[keep_obs])
        self.obs_lm = new_idx[self.obs_lm[keep_obs]].astype(np.int32)
        self.lm_p = np.ascontiguousarray(self.lm_p[keep_lm])
        if self.lm_p_h is not None:
            self.lm_p_h = np.ascontiguousarray(self.lm_p_h[keep_lm])

    def randomize_landmarks(self, rng: np.random.Generator) -> None:
        """N(0,1) landmark re-draw at load, as load_bal_eccv does
        (bal_problem.cpp:258-266). Irrelevant to the solve (the VarProj
        closed-form init replaces landmarks at iteration 0) but kept for
        behavioral parity."""
        self.lm_p = rng.standard_normal(self.lm_p.shape)

    def compute_rcs_sparsity(self) -> float:
        """Fraction of zero blocks in the reduced camera system
        (bal_problem.cpp:747-814), computed vectorized instead of the
        reference's TBB loop + atomic mask."""
        n = self.num_cameras
        # camera pairs sharing a landmark: join obs with itself on
        # obs_lm. Landmarks are bucketed by exact observation count so
        # each bucket's pair enumeration is one broadcast — no Python
        # loop over the (potentially millions of) landmarks.
        order = np.lexsort((self.obs_cam, self.obs_lm))
        cams = self.obs_cam[order]
        lms = self.obs_lm[order]
        counts = np.bincount(lms, minlength=self.num_landmarks)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        mask = np.zeros(n * n, dtype=bool)
        for k in np.unique(counts):
            if k < 2:
                continue
            sel = counts == k
            # [Lk, k] camera ids of every landmark with exactly k obs
            rows = cams[starts[sel][:, None] + np.arange(k)[None, :]]
            ii, jj = np.broadcast_arrays(rows[:, :, None], rows[:, None, :])
            pair_sel = ii > jj
            mask[ii[pair_sel] * n + jj[pair_sel]] = True
        nnz = n + 2 * int(mask.sum())
        return 1.0 - nnz / float(n * n)

    def summarize(self, compute_sparsity: bool = False) -> DatasetSummary:
        """bal_problem.cpp summarize_problem (816-859)."""
        counts = np.bincount(self.obs_lm, minlength=self.num_landmarks)
        s = DatasetSummary(
            input_path=self.input_path,
            num_cameras=self.num_cameras,
            num_landmarks=self.num_landmarks,
            num_observations=self.num_observations,
            per_lm_obs_mean=float(counts.mean()),
            per_lm_obs_min=float(counts.min()),
            per_lm_obs_max=float(counts.max()),
            per_lm_obs_stddev=float(counts.std()),
        )
        if compute_sparsity:
            s.rcs_sparsity = self.compute_rcs_sparsity()
        return s

    def save_npz(self, path: str) -> None:
        """Optimized-state persistence; replaces the reference's cereal
        binary archive (bal_problem.cpp:474-482) with a self-describing
        npz (magic/version in line with FileInfo, bal_problem_io.hpp:50)."""
        np.savez_compressed(
            path,
            magic="povar_tpu::BalProblem",
            version="1.0",
            cam_space=self.cam_space,
            intrinsics=self.intrinsics,
            lm_p=self.lm_p,
            lm_p_h=(
                self.lm_p_h
                if self.lm_p_h is not None
                else np.zeros((0, 4))
            ),
            obs_cam=self.obs_cam,
            obs_lm=self.obs_lm,
            obs_uv=self.obs_uv,
        )

    @staticmethod
    def load_npz(path: str) -> "BalProblem":
        d = np.load(path, allow_pickle=False)
        assert str(d["magic"]) == "povar_tpu::BalProblem", "bad file magic"
        lm_p_h = d["lm_p_h"]
        return BalProblem(
            cam_space=d["cam_space"],
            intrinsics=d["intrinsics"],
            lm_p=d["lm_p"],
            lm_p_h=lm_p_h if lm_p_h.size else None,
            obs_cam=d["obs_cam"],
            obs_lm=d["obs_lm"],
            obs_uv=d["obs_uv"],
            input_path=path,
        )


def from_numpy(
    obs_cam, obs_lm, obs_uv, cam_space, lm_p, *, device,
    dtype=torch.float64,
) -> Tuple[BalProblem, torch.Tensor, torch.Tensor]:
    """Build the port's problem and initial LM state from the JAX
    package's `BalProblem` fields as numpy arrays.

    Returns (problem, cams, lms): `problem` holds the host-side arrays
    (observations stay numpy; the solver lays them out on the device),
    `cams` [N, 3, 4] and `lms` [M, 3] are the state tensors on `device`
    in `dtype`. Nothing is reordered, so the same arrays fed to both
    packages describe the same problem."""
    cam_space = np.asarray(cam_space, np.float64)
    lm_p = np.asarray(lm_p, np.float64)
    obs_uv = np.asarray(obs_uv, np.float64)
    if cam_space.ndim != 3 or cam_space.shape[1:] != (3, 4):
        raise ValueError(f"cam_space must be [N, 3, 4], got {cam_space.shape}")
    if lm_p.ndim != 2 or lm_p.shape[1] != 3:
        raise ValueError(f"lm_p must be [M, 3], got {lm_p.shape}")
    if obs_uv.ndim != 2 or obs_uv.shape[1] != 2:
        raise ValueError(f"obs_uv must be [O, 2], got {obs_uv.shape}")
    problem = BalProblem(
        cam_space=cam_space,
        intrinsics=np.tile(np.array([1.0, 0.0, 0.0]), (len(cam_space), 1)),
        lm_p=lm_p,
        obs_cam=np.asarray(obs_cam, np.int32),
        obs_lm=np.asarray(obs_lm, np.int32),
        obs_uv=obs_uv,
    )
    cams = torch.as_tensor(cam_space, dtype=dtype, device=device)
    lms = torch.as_tensor(lm_p, dtype=dtype, device=device)
    return problem, cams, lms

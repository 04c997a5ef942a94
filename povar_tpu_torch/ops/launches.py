"""Launch counters of every kernel of the package at once.

Each wrapper module (ops/pose_kernels.py for step 1, ops/pose2_kernels.py
for step 2, ops/cam_kernels.py for the camera-table kernels,
ops/spmd_kernels.py for the SPMD window layout's, ops/lm_kernels.py
for the device LM loop's) adds one to
its `LAUNCHES` entry per kernel launch; a run that drives the whole
two-step solve zeroes and reads them all here. `KERNELS` lists the
counters: one per kernel, and the camera-table kernels' f64
instantiations apart (`cam_kernels.F64_KERNELS`, the names with `_f64`
appended).
"""

from __future__ import annotations

from typing import Dict

from povar_tpu_torch.ops import (
    cam_kernels,
    lm_kernels,
    pose2_kernels,
    pose_kernels,
    spmd_kernels,
)

MODULES = (pose_kernels, pose2_kernels, cam_kernels, spmd_kernels,
           lm_kernels)
KERNELS = tuple(name for m in MODULES for name in m.LAUNCHES)


def reset_launch_counts() -> None:
    for m in MODULES:
        m.LAUNCHES.update(dict.fromkeys(m.LAUNCHES, 0))


def launch_counts() -> Dict[str, int]:
    return {name: m.LAUNCHES[name] for m in MODULES for name in m.LAUNCHES}


def add_launch_counts(counts: Dict[str, int], times: int) -> None:
    """Add `times` x counts[name] to each named counter (the device LM
    loop's graph replays, whose launches no wrapper sees; a negative
    `times` takes back what a graph capture counted)."""
    owner = {name: m for m in MODULES for name in m.LAUNCHES}
    for name, n in counts.items():
        owner[name].LAUNCHES[name] += n * times

"""Tracing and device memory (the counterpart of
povar_tpu/utils/profiling.py, with torch in place of jax).

The reference instruments every pipeline stage with hand-rolled wall
timers (util/time_utils.hpp Timer + ~15 per-stage IterationSummary
fields); the summaries and ba_log keep that schema (utils/summary.py).
This module adds the device-level view the reference lacks: a
torch.profiler trace of host and device activity exported as a Chrome
trace (chrome://tracing, ui.perfetto.dev), and the CUDA allocator's
memory statistics for the log.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(dir_path: Optional[str]) -> Iterator[None]:
    """Profile the enclosed block (no-op when dir_path is None) and write
    dir_path/trace.json, a Chrome trace of its CPU and, where a card is
    present, CUDA activity."""
    if not dir_path:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(dir_path, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(dir_path, "trace.json"))


def annotate(name: str):
    """Named region that shows up on the trace's timeline."""
    return torch.profiler.record_function(name)


def device_memory_stats() -> dict:
    """Per-device memory statistics (bytes) of the CUDA caching
    allocator, under the keys of the JAX package's log (bytes_in_use,
    peak_bytes_in_use, bytes_limit); {} without a card. The device-side
    analogue of the reference's /proc RSS sampling
    (util/system_utils.cpp:52-89)."""
    if not torch.cuda.is_available():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(i)),
            "bytes_limit": int(torch.cuda.get_device_properties(i).total_memory),
        }
    return out

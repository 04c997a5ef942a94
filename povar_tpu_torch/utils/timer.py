"""Wall-clock timing (util/time_utils.hpp Timer equivalent)."""

from __future__ import annotations

import time


class Timer:
    def __init__(self) -> None:
        self._t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def reset(self) -> float:
        now = time.perf_counter()
        dt = now - self._t0
        self._t0 = now
        return dt

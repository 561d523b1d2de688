"""Wall-clock helpers (scripts/timer.py:6-29 and utils_data.py:376-387
parity; the port's copy of visitron_tpu/utils/timer.py)."""

from __future__ import annotations

import math
import time


class Timer:
    def __init__(self):
        self.cul_time = 0.0
        self.start_time = None
        self.count = 0

    def tic(self) -> None:
        self.start_time = time.time()

    def toc(self, average: bool = True) -> float:
        if self.start_time is None:
            raise RuntimeError("toc() before tic()")
        self.cul_time += time.time() - self.start_time
        self.count += 1
        if average:
            return self.cul_time / self.count
        return self.cul_time

    def reset(self) -> None:
        self.cul_time, self.start_time, self.count = 0.0, None, 0


def as_minutes(s: float) -> str:
    m = math.floor(s / 60)
    return "%dm %ds" % (m, s - m * 60)


def time_since(since: float, percent: float) -> str:
    """Elapsed and projected-remaining time at ``percent`` progress."""
    s = time.time() - since
    es = s / max(percent, 1e-9)
    return "%s (- %s)" % (as_minutes(s), as_minutes(es - s))

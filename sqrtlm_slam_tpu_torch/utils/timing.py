"""Timing utilities.

Counterpart of `sqrtlm_slam_tpu/utils/timing.py`: `TicToc` is a millisecond
stopwatch; `StageTimer` sums host wall time per named stage over a run and
prints a table. Work on the card is asynchronous: a stage's time includes
the device work only where something inside it waits for the device (a host
read), so deferred work lands in whichever stage reads it. For device
traces use `torch.profiler` (the runner's `--profile`).
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager


class TicToc:
    """Millisecond wall-clock stopwatch."""

    def __init__(self):
        self.tic()

    def tic(self):
        self._t0 = time.perf_counter()

    def toc(self) -> float:
        return (time.perf_counter() - self._t0) * 1000.0


class StageTimer:
    """Named-stage accumulator: with timer.stage("track"): ..."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> str:
        lines = [f"{'stage':<24}{'calls':>8}{'total s':>12}{'mean ms':>12}"]
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name:<24}{n:>8}{tot:>12.3f}{tot / max(n,1) * 1e3:>12.2f}")
        return "\n".join(lines)

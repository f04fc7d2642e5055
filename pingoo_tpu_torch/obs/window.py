"""Bounded timing windows for the serving objects.

A `TimingWindow` keeps the newest `maxlen` samples (ms) of one timing,
plus the count and the sum of every sample it was given. So its memory,
and the cost of a percentile over it, stay fixed however long the
process serves, while counts and means stay exact. Percentiles are over
the window: the newest `maxlen` samples, exact, not bucket bounds.
"""

from __future__ import annotations

from collections import deque

import numpy as np

# Samples kept per timing: a day of one batch every 1.3 s, or the last
# 65,536 batches of a busier process.
WINDOW = 65536


class TimingWindow:
    __slots__ = ("samples", "count", "total")

    def __init__(self, maxlen: int = WINDOW):
        self.samples: deque = deque(maxlen=maxlen)
        self.count = 0
        self.total = 0.0

    def append(self, ms: float) -> None:
        self.samples.append(ms)
        self.count += 1
        self.total += ms

    def __len__(self) -> int:
        return len(self.samples)

    def __iter__(self):
        return iter(self.samples)

    def __getitem__(self, i):
        return self.samples[i]

    def since(self, count: int) -> list[float]:
        """The samples added after the window's `count` read `count`
        (at most `maxlen` of them: older ones have left the window)."""
        n = min(self.count - count, len(self.samples))
        return list(self.samples)[len(self.samples) - n:] if n > 0 else []

    def percentile(self, q: float) -> float:
        """The q-th percentile (0-100) of the window, 0.0 when empty."""
        if not self.samples:
            return 0.0
        return float(np.percentile(np.fromiter(self.samples, float), q))

    def summary(self) -> dict:
        return {"count": self.count,
                "p50_ms": self.percentile(50),
                "p99_ms": self.percentile(99),
                "mean_ms": round(self.total / self.count, 4)
                if self.count else 0.0}

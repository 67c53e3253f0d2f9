"""Host-side result aggregation: meters, Welford running stats, keyed CSV
(the port's own copy of ``codd_tpu/utils/running_stats.py``; numpy and csv
only): AverageMeter, RunningStats, and RunningStatsWithBuffer with the
merge a multi-process eval reduce needs and the per-sequence CSV layout.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["AverageMeter", "RunningStats", "RunningStatsWithBuffer"]


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class RunningStats:
    """Welford online mean/variance with mergeable state."""

    def __init__(self):
        self.n = 0
        self.mean: Optional[np.ndarray] = None
        self.m2: Optional[np.ndarray] = None

    def push(self, x):
        x = np.asarray(x, dtype=np.float64)
        if self.mean is None:
            self.mean = np.zeros_like(x)
            self.m2 = np.zeros_like(x)
        self.n += 1
        delta = x - self.mean
        self.mean = self.mean + delta / self.n
        self.m2 = self.m2 + delta * (x - self.mean)

    def variance(self):
        if self.n < 2:
            return np.zeros_like(self.mean)
        return self.m2 / (self.n - 1)

    def __add__(self, other: "RunningStats") -> "RunningStats":
        out = RunningStats()
        if self.n == 0:
            out.n, out.mean, out.m2 = other.n, other.mean, other.m2
            return out
        if other.n == 0:
            out.n, out.mean, out.m2 = self.n, self.mean, self.m2
            return out
        n = self.n + other.n
        delta = other.mean - self.mean
        out.n = n
        out.mean = self.mean + delta * other.n / n
        out.m2 = self.m2 + other.m2 + delta ** 2 * self.n * other.n / n
        return out


class RunningStatsWithBuffer(RunningStats):
    """Keyed per-sequence rows + aggregate stats; dumps the reference's
    CSV layout (running_stats.py:109-184)."""

    def __init__(self, path: Optional[str] = None,
                 header: Optional[List[str]] = None):
        super().__init__()
        self.path = path
        self.header = header
        self.buffer: Dict[str, Sequence[float]] = {}

    def push(self, key, values):
        self.buffer[str(key)] = [float(v) for v in values]
        super().push(values)

    def __add__(self, other):
        out = RunningStatsWithBuffer(self.path or getattr(other, "path", None),
                                     self.header or getattr(other, "header", None))
        merged = RunningStats.__add__(self, other)
        out.n, out.mean, out.m2 = merged.n, merged.mean, merged.m2
        out.buffer = {**self.buffer, **getattr(other, "buffer", {})}
        return out

    def dump(self, path: Optional[str] = None):
        path = path or self.path
        if path is None:
            raise ValueError("no dump path configured")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", newline="") as f:
            writer = csv.writer(f)
            if self.header:
                writer.writerow(self.header)
            for k in sorted(self.buffer):
                writer.writerow([k] + list(self.buffer[k]))
            if self.mean is not None:
                writer.writerow(["mean"] + list(np.asarray(self.mean)))
        return path

"""Online mean/std meter (copy of graph_physics_tpu/utils/meter.py:
AverageValueMeter, itself after the reference's utils/meter.py)."""

from __future__ import annotations

import math


class AverageValueMeter:
    """Numerically stable online mean/std accumulator (Welford)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.n = 0
        self.sum = 0.0
        self.mean = 0.0
        self._m2 = 0.0
        self.val = 0.0

    def add(self, value: float, n: int = 1):
        value = float(value)
        self.val = value
        for _ in range(n):
            self.n += 1
            delta = value - self.mean
            self.mean += delta / self.n
            self._m2 += delta * (value - self.mean)
        self.sum += value * n

    @property
    def std(self) -> float:
        if self.n < 2:
            return float("nan")
        return math.sqrt(self._m2 / (self.n - 1))

    def value(self):
        return self.mean, self.std

"""Shape bucketing helpers used by the host mesh builders.

Copies of graph_physics_tpu/core/padding.py:round_up, bucket_size and
pad_axis (numpy only).
"""

from __future__ import annotations

import math

import numpy as np

#: rounding quantum of the node/edge buckets
ALIGN = 128


def round_up(n: int, multiple: int = ALIGN) -> int:
    """Smallest multiple of ``multiple`` that is >= max(n, 1)."""
    n = max(int(n), 1)
    return ((n + multiple - 1) // multiple) * multiple


def bucket_size(n: int, growth: float = 1.25, align: int = ALIGN) -> int:
    """Round ``n`` up to a geometric bucket boundary, then align."""
    n = max(int(n), 1)
    if n <= align:
        return align
    k = math.ceil(math.log(n / align) / math.log(growth))
    b = int(math.ceil(align * growth**k))
    return round_up(b, align)


def pad_axis(a: np.ndarray, size: int, axis: int = 0, fill=0) -> np.ndarray:
    """Pad ``a`` with ``fill`` along ``axis`` up to ``size``."""
    cur = a.shape[axis]
    if cur > size:
        raise ValueError(f"array dim {cur} exceeds bucket {size}")
    if cur == size:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, size - cur)
    return np.pad(a, widths, mode="constant", constant_values=fill)

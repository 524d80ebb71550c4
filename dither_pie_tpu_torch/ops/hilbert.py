"""Hilbert-curve scan order for Riemersma dithering.

A copy of ``dither_pie_tpu/ops/hilbert.py`` (numpy only; copied rather than
imported, since the port imports nothing of the JAX package): the standard
d2xy bit-twiddle, vectorized over all indices at once so path generation is
O(n^2 log n) NumPy ops instead of a Python loop.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np


def next_power_of_two(x: int) -> int:
    return 2 ** int(math.ceil(math.log2(x))) if x > 0 else 1


@lru_cache(maxsize=8)
def hilbert_path(n: int) -> np.ndarray:
    """(n*n, 2) int32 of (row, col) in Hilbert-curve visit order, n = 2^k.

    The original application's convention: its ``hilbert_xy`` fills
    ``order_map[yy, xx] = i`` and then ``coords[idx] = [rr, cc]`` with rr
    iterating rows, so coords[i] = (y, x) of curve position i.
    """
    order_bits = int(math.log2(n))
    t = np.arange(n * n, dtype=np.int64)
    x = np.zeros_like(t)
    y = np.zeros_like(t)
    s = 1
    for _ in range(order_bits):
        rx = 1 & (t // 2)
        ry = 1 & (t ^ rx)
        # Rotate quadrant where ry == 0.
        flip = (ry == 0) & (rx == 1)
        x = np.where(flip, s - 1 - x, x)
        y = np.where(flip, s - 1 - y, y)
        swap = ry == 0
        x, y = np.where(swap, y, x), np.where(swap, x, y)
        x = x + s * rx
        y = y + s * ry
        t = t // 4
        s <<= 1
    # coords[i] = (row, col) = (y, x), the order_map transpose.
    return np.stack([y, x], axis=1).astype(np.int32)

"""Local-variance gate map for adaptive-variance dithering.

The gates are computed on the host with scipy's ``uniform_filter``, as the
JAX package's strategy computes them: a gate is ``variance >= threshold``,
which flips on one ulp, so the port keeps the host function's bits rather
than a device filter of its own.
"""

from __future__ import annotations

import numpy as np


def variance_map_np(gray: np.ndarray, window_radius: int = 1) -> np.ndarray:
    from scipy.ndimage import uniform_filter

    size = 2 * window_radius + 1
    g = gray.astype(np.float32)
    mean_sq = uniform_filter(g**2, size=size, mode="nearest")
    sq_mean = uniform_filter(g, size=size, mode="nearest") ** 2
    return np.maximum(0.0, mean_sq - sq_mean)

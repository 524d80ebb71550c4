"""sRGB transfer functions for the gamma path of ``ImageDitherer``.

Host-side NumPy, copied from ``dither_pie_tpu/core/colors.py`` (the exact
piecewise IEC 61966-2-1 curve in float32). The gamma path converts frames
and palette on the host before they reach the device, exactly as the JAX
package does, so both packages feed the scan the same bytes.
"""

from __future__ import annotations

import numpy as np


def srgb_to_linear_np(c: np.ndarray) -> np.ndarray:
    """Exact piecewise sRGB electro-optical transfer function (float32),
    input in [0, 1]."""
    c = np.asarray(c, dtype=np.float32)
    low = c <= 0.04045
    out = np.empty_like(c, dtype=np.float32)
    out[low] = c[low] / 12.92
    out[~low] = ((c[~low] + 0.055) / 1.055) ** 2.4
    return out


def linear_to_srgb_np(c: np.ndarray) -> np.ndarray:
    """Exact piecewise inverse sRGB transfer function (float32), input in
    [0, 1]."""
    c = np.asarray(c, dtype=np.float32)
    low = c <= 0.0031308
    out = np.empty_like(c, dtype=np.float32)
    out[low] = c[low] * 12.92
    out[~low] = 1.055 * (c[~low] ** (1.0 / 2.4)) - 0.055
    return out

"""sRGB transfer functions, copied from ``dither_pie_tpu/core/colors.py``
(the exact piecewise IEC 61966-2-1 curve in float32).

The host-side NumPy pair serves the gamma path of ``ImageDitherer``: it
converts frames and palette on the host before they reach the device,
exactly as the JAX package does, so both packages feed the scan the same
bytes. The torch pair (``srgb_to_linear``, ``linear_to_srgb``) runs on a
tensor's device and serves the sharded ordered step
(``parallel/sharding.py``), which converts on each shard's device as the
JAX package's does.
"""

from __future__ import annotations

import numpy as np
import torch


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


def _consts(t: torch.Tensor, *values: float):
    """``values`` as 0-dim float32 tensors on ``t``'s device: PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal, a division by
    a tensor divides."""
    return torch.tensor(values, dtype=torch.float32, device=t.device).unbind()


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    """Exact piecewise sRGB electro-optical transfer function on a float32
    tensor in [0, 1], on its device; both branches computed, one kept."""
    knee, slope, off, scale, gamma = _consts(c, 0.04045, 12.92, 0.055, 1.055, 2.4)
    return torch.where(c <= knee, c / slope, torch.pow((c + off) / scale, gamma))


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    """Exact piecewise inverse sRGB transfer function on a float32 tensor
    in [0, 1], on its device. The power branch's operand is clamped at 0,
    so the unselected lane never takes a negative base."""
    knee, slope, off, scale, inv_gamma = _consts(c, 0.0031308, 12.92, 0.055, 1.055,
                                                 1.0 / 2.4)
    high = scale * torch.pow(c.clamp_min(0.0), inv_gamma) - off
    return torch.where(c <= knee, c * slope, high)

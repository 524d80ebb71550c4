"""The card's peaks and the least time of the error-diffusion scan.

A kernel's roofline share is its least time over its measured device time.
The least time is the larger of its float32 operations over the peak rate
outside the tensor cores and its bytes over the memory rate, both counted
from the shapes alone, the same whatever implements the scan.
"""

from __future__ import annotations

from typing import Dict

# NVIDIA's data sheet, H100 SXM at its 700 W limit: float32 outside the
# tensor cores, and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# Least latency of one wavefront step: a block-wide barrier, one trip
# through shared memory and about 25 dependent float instructions.
CHAIN_STEP_US = 0.1


def stream_steps(h: int, w: int, s: int) -> int:
    """Wavefront steps of an (h, w) frame under the skew s: w + s*(h-1)."""
    return w + s * (h - 1)


def bound_s(n_bytes: float, n_flops: float) -> Dict[str, float]:
    """{"bound_s", "bytes_s", "ops_s"}: the least time the card could take."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_flops / PEAK_F32_FLOPS
    return {"bound_s": max(t_bytes, t_ops), "bytes_s": t_bytes, "ops_s": t_ops}


def scan_work(b: int, h: int, w: int, s: int, p: int, n_entries: int,
              in_bytes: int = 1) -> Dict[str, float]:
    """Operations and bytes of one scan launch over b frames of (h, w) with
    a p-colour palette and n_entries diffusion weights.

    Bytes: the skewed (D, 3b, h) stream read once at ``in_bytes`` an
    element, the (p, 3) float32 palette read once, the (D, b, h) int32
    packed output written once. Operations a pixel: the fold (a multiply
    and an add a channel and weight), the exact search (3 subtracts, 3
    multiplies, 2 adds a colour) and the error (3 subtracts)."""
    d = stream_steps(h, w, s)
    n_bytes = d * 3 * b * h * in_bytes + p * 12 + d * b * h * 4
    n_flops = b * h * w * (6 * n_entries + 8 * p + 3)
    return {"bytes": float(n_bytes), "flops": float(n_flops), "steps": d,
            "chain_bound_s": d * CHAIN_STEP_US * 1e-6, "chain_step_us": CHAIN_STEP_US,
            **bound_s(n_bytes, n_flops)}

"""Perceptual-equivalence metrics of two dither outputs, on tensors.

Error diffusion is a chaotic recurrence: one palette pick that flips on a
near tie changes the pixels after it while the local mean colour, which
diffusion preserves by construction, stays. These two metrics make
"perceptually matched" a number: the fraction of identical pixels, and the
difference of the per-block mean colours. The dense-search gate of
``ops.wavefront.ed_batch_wavefront`` (``dense_search="auto"``) compares the
score search's output with the exact one through them, on the device the
outputs lie on.

The port's own copy of ``identity_fraction`` and ``block_mean_error`` of
the JAX package's ``core/fidelity.py``: float64 arithmetic, the same crop
of partial blocks, the same global-mean rule for images smaller than one
block.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _check_shapes(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {tuple(a.shape)} vs {tuple(b.shape)}")


def identity_fraction(a: torch.Tensor, b: torch.Tensor) -> float:
    """Fraction of pixels of two (..., 3) images whose full RGB value
    matches exactly."""
    _check_shapes(a, b)
    return float((a == b).all(dim=-1).to(torch.float64).mean().item())


def block_mean_error(a: torch.Tensor, b: torch.Tensor,
                     block: int = 4) -> Tuple[float, float]:
    """(mean, max) absolute difference of the per-block mean colours of two
    (H, W, 3) images of palette colours in [0, 255]. Blocks are ``block`` x
    ``block`` tiles; trailing partial tiles are cropped; an image smaller
    than one block compares its global means."""
    _check_shapes(a, b)
    a = a.to(torch.float64)
    b = b.to(torch.float64)
    h, w = a.shape[:2]
    hb, wb = h // block, w // block
    if hb == 0 or wb == 0:
        diff = (a.mean((0, 1)) - b.mean((0, 1))).abs().mean().item()
        return (float(diff),) * 2
    a = a[: hb * block, : wb * block].reshape(hb, block, wb, block, 3)
    b = b[: hb * block, : wb * block].reshape(hb, block, wb, block, 3)
    per_block = (a.mean((1, 3)) - b.mean((1, 3))).abs().mean(-1)  # (hb, wb)
    return float(per_block.mean().item()), float(per_block.max().item())

"""Ordered (threshold-screen) dithering: the port of
``dither_pie_tpu/ops/ordered.py``.

One rule serves every matrix-threshold mode (Bayer, PSX, blue noise, polka
dot: tiled screens; IGN: a computed per-pixel screen):

    factor = d1 / (d1 + d2)      (top-2 squared palette distances)
    out    = palette[factor <= screen ? nearest : second]

``dispatch_ordered_batch`` is the entry the strategies call. It sends every
CUDA batch to the hand-written kernel K4 (``ops/ordered_fused.py``),
whatever its size and palette, and runs K4's plain version on a CPU batch.
The JAX package's size and palette conditions for its Pallas kernel were
TPU launch-cost and SMEM limits. Its dense (N, P) XLA path is not ported:
K4's plain version is the CPU path, and it gives the XLA path's bits.
"""

from __future__ import annotations

import numpy as np
import torch

from dither_pie_tpu_torch.api.runtime import DeviceLike, resolve_device
from dither_pie_tpu_torch.ops.ordered_fused import ordered_dither_fused


def tile_screen_device(matrix: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Tile a (th, tw) threshold matrix over an (h, w) canvas on its device."""
    th, tw = matrix.shape
    rows = torch.arange(h, device=matrix.device) % th
    cols = torch.arange(w, device=matrix.device) % tw
    return matrix[rows][:, cols]


def screen_for_matrix(matrix: np.ndarray, h: int, w: int,
                      device: DeviceLike) -> torch.Tensor:
    """Tiled (h, w) float32 screen on ``device`` from a small host matrix."""
    m = torch.as_tensor(np.asarray(matrix, np.float32), device=resolve_device(device))
    return tile_screen_device(m, h, w)


def dispatch_ordered_batch(images: torch.Tensor, palette: torch.Tensor,
                           screen: torch.Tensor,
                           return_indices: bool = False) -> torch.Tensor:
    """(B, H, W, 3) frames -> (B, H, W, 3) u8 colours, or (B, H, W) u8
    indices with ``return_indices`` (P <= 256): K4 on a CUDA batch, its
    plain version on a CPU batch. Bit-identical either way; more than 256
    colours with ``return_indices`` raise ValueError."""
    return ordered_dither_fused(images, palette, screen,
                                return_indices=return_indices)

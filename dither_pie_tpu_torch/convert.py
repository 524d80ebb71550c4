"""State carried across from the JAX package.

The error-diffusion path has no learned weights. Its state is the palette,
the diffusion weight tables and Ostromoukhov's pre-divided weight table,
all numpy data in the JAX package; these functions return them as the
port's tensors on a given device, unchanged bit for bit.
``ops.wavefront.scan_geometry`` takes the scan's weight table from
``entries_to_torch`` (every mode's entries: the fixed variants, and the
Floyd-Steinberg entries of hybrid, perceptual and adaptive) and
``ops.wavefront.ostro_lut`` the Ostromoukhov table from
``weight_table_to_torch``; the tests use ``palette_to_torch`` to feed both
packages one palette (their k-means streams differ, see core/palette.py).
``augment_palette`` derives the score search's palette from it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from dither_pie_tpu_torch.api.runtime import DeviceLike, resolve_device


def palette_to_torch(palette, device: DeviceLike) -> torch.Tensor:
    """(P, 3) palette (array or list of RGB tuples) -> (P, 3) float32 tensor.
    Kept float32, never rounded: the gamma path's palettes are not
    integers."""
    arr = np.asarray(palette, dtype=np.float32)
    if arr.ndim != 2 or arr.shape[1] != 3:
        raise ValueError(f"palette must be (P, 3), got {arr.shape}")
    return torch.as_tensor(arr, device=resolve_device(device))


def entries_to_torch(entries: Sequence[Tuple[int, int, float]],
                     device: DeviceLike) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-kernel entries [(dx, dy, w), ...] (``_fixed_entries(variant)``
    of either package) -> ((n, 2) int32 offsets, (n,) float32 weights), the
    pre-divided float32 weights bit for bit."""
    dev = resolve_device(device)
    offs = np.array([(dx, dy) for dx, dy, _ in entries], dtype=np.int32)
    wts = np.array([w for _, _, w in entries], dtype=np.float32)
    return torch.as_tensor(offs, device=dev), torch.as_tensor(wts, device=dev)


def weight_table_to_torch(table, device: DeviceLike) -> torch.Tensor:
    """Ostromoukhov's pre-divided (256, 3) float32 weight table (the result
    of ``_ostro_weight_table()`` of either package) -> the same bits as a
    (256, 3) float32 tensor: row = truncated luminance, column = entry
    (x+1, y), (x-1, y+1), (x, y+1)."""
    arr = np.ascontiguousarray(table)
    if arr.dtype != np.float32 or arr.shape != (256, 3):
        raise ValueError(f"weight table must be (256, 3) float32, got "
                         f"{arr.shape} {arr.dtype}")
    return torch.as_tensor(arr, device=resolve_device(device))


def augment_palette(palette: torch.Tensor) -> torch.Tensor:
    """(P, 3) float32 palette -> (P, 4) float32 rows ``[r, g, b, n]`` with
    ``n = -0.5 * ((r*r + g*g) + b*b)``, on the palette's device: the
    palette of the score search (``dense_search="mxu"``), whose pick is the
    maximum of ``c . x + n`` instead of the minimum of ``|x - c|^2``. Each
    product and sum is one eager float32 op, so ``n`` equals the JAX
    package's ``_pad_palette_aug(pal, pp)[:P, 3]`` bit for bit; its sentinel
    rows and four zero columns are TPU tiling and are not carried over."""
    if palette.dtype != torch.float32 or palette.dim() != 2 or palette.shape[1] != 3:
        raise ValueError("palette must be a (P, 3) float32 tensor")
    sq = palette * palette
    norm = (sq[:, 0] + sq[:, 1]) + sq[:, 2]
    return torch.cat([palette, (norm * -0.5)[:, None]], dim=1).contiguous()

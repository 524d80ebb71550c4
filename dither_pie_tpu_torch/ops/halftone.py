"""Rotated-screen newspaper halftone: the port of
``dither_pie_tpu/ops/halftone.py``.

The screen and the cell assignment depend only on (H, W, parameters), not
on pixel data: ``halftone_screen`` computes them on the host in float64
(copied unchanged) and caches them. The per-pixel work runs as torch ops on
the frames' device, for a whole (B, H, W, 3) batch at once: luma, the
per-cell colour average (``index_add_``), the nearest palette colour of
each cell, and the ink test against the screen.

What keeps the card and the CPU on the same bits:

* the per-cell sums are exact in any order of the additions (the card adds
  with atomics) as long as the pixels are integers: values of at most 255,
  a cell of at most about 1024 pixels, far under 2**24. Every entry point
  hands over integer-valued pixels; for other values the sums depend on the
  order;
* the cell search ``(a2 - 2*ap) + p2`` is written with ``ap`` as explicit
  float32 products ``(a_r*p_r + a_g*p_g) + a_b*p_b``: no matrix product,
  so no TF32 and no library reduction order;
* the first minimum (and the first brightest colour) is built by
  construction, not left to ``argmin``'s tie order;
* a division by a constant takes a tensor divisor: PyTorch's CUDA division
  by a Python scalar multiplies by the reciprocal instead.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_SCREEN_CACHE = {}

# Most entries of the (cells, P) distance temporary of one chunk of the
# cell search: 2**24 float32 entries are 64 MB (16 x 1080p at cell size 8
# and 32 colours is 17 M entries; 4096 colours would be 8.6 GB at once).
SEARCH_CHUNK_ENTRIES = 1 << 24


def halftone_screen(
    h: int,
    w: int,
    cell_size: int = 8,
    angle: float = 45.0,
    dot_gain: float = 1.0,
    min_dot_size: float = 0.0,
    max_dot_size: float = 1.0,
    shape: str = "circle",
    sharpness: float = 1.5,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """(screen (H,W) f32, cell_idx (H,W) int32 compacted to [0, n_cells), n_cells)."""
    key = (h, w, cell_size, angle, dot_gain, min_dot_size, max_dot_size, shape, sharpness)
    if key in _SCREEN_CACHE:
        return _SCREEN_CACHE[key]

    angle_rad = np.radians(angle)
    cos_a, sin_a = np.cos(angle_rad), np.sin(angle_rad)
    y_coords, x_coords = np.mgrid[0:h, 0:w]
    x_rot = x_coords * cos_a - y_coords * sin_a
    y_rot = x_coords * sin_a + y_coords * cos_a

    cell_x = np.floor(x_rot / cell_size).astype(np.int32)
    cell_y = np.floor(y_rot / cell_size).astype(np.int32)
    cell_x -= cell_x.min()
    cell_y -= cell_y.min()
    max_x = cell_x.max() + 1
    raw_ids = cell_y * max_x + cell_x
    # Compact to consecutive ids (reference uses np.unique + searchsorted).
    unique_ids, cell_idx = np.unique(raw_ids, return_inverse=True)
    cell_idx = cell_idx.reshape(h, w).astype(np.int32)
    n_cells = int(len(unique_ids))

    x_in = (x_rot % cell_size) / cell_size
    y_in = (y_rot % cell_size) / cell_size
    dx, dy = x_in - 0.5, y_in - 0.5
    if shape == "square":
        dist, max_dist = np.maximum(np.abs(dx), np.abs(dy)), 0.5
    elif shape == "diamond":
        dist, max_dist = np.abs(dx) + np.abs(dy), 1.0
    else:  # circle (and unknown-shape fallback)
        dist, max_dist = np.sqrt(dx**2 + dy**2), 0.5
    dist_norm = np.clip(dist / max_dist, 0.0, 1.0)
    threshold = dist_norm ** (1.0 / dot_gain)
    threshold = min_dot_size + threshold * (max_dot_size - min_dot_size)
    if sharpness != 1.0:
        threshold = 0.5 + (threshold - 0.5) * sharpness
    screen = np.clip(threshold, 0.0, 1.0).astype(np.float32)

    result = (screen, cell_idx, n_cells)
    if len(_SCREEN_CACHE) < 16:
        _SCREEN_CACHE[key] = result
    return result


def _first(values: torch.Tensor, extremum: torch.Tensor) -> torch.Tensor:
    """The least index along the last axis whose value equals the
    extremum (int64)."""
    p = values.shape[-1]
    iota = torch.arange(p, device=values.device)
    return torch.where(values == extremum, iota, p).amin(-1)


def _luma(rgb: torch.Tensor) -> torch.Tensor:
    """``(0.299*r + 0.587*g) + 0.114*b`` of a (..., 3) float32 tensor."""
    return (rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587) + rgb[..., 2] * 0.114


def _sum3(t: torch.Tensor) -> torch.Tensor:
    return (t[..., 0] + t[..., 1]) + t[..., 2]


def _cell_palette(avgs: torch.Tensor, palette: torch.Tensor) -> torch.Tensor:
    """Nearest palette index of every cell average: (N, 3), (P, 3) -> (N,)
    int64, the first minimum of ``(a2 - 2*ap) + p2``, in chunks of at most
    ``SEARCH_CHUNK_ENTRIES`` entries of the (N, P) temporary."""
    p = palette.shape[0]
    p2 = _sum3(palette * palette)[None, :]
    rows = max(1, SEARCH_CHUNK_ENTRIES // p)
    picks = []
    for start in range(0, avgs.shape[0], rows):
        a = avgs[start:start + rows]
        a2 = _sum3(a * a)[:, None]
        ap = ((a[:, 0:1] * palette[None, :, 0] + a[:, 1:2] * palette[None, :, 1])
              + a[:, 2:3] * palette[None, :, 2])
        d = (a2 - ap * 2.0) + p2
        picks.append(_first(d, d.amin(-1, keepdim=True)))
    return torch.cat(picks)


def _check(images: torch.Tensor, palette: torch.Tensor, screen: torch.Tensor,
           cell_idx: torch.Tensor, n_cells: int) -> None:
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"images must be (B, H, W, 3), got {tuple(images.shape)}")
    if images.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"images must be uint8 or float32, got {images.dtype}")
    if palette.dtype != torch.float32 or palette.dim() != 2 or palette.shape[1] != 3:
        raise ValueError("palette must be a (P, 3) float32 tensor")
    hw = tuple(images.shape[1:3])
    if screen.dtype != torch.float32 or tuple(screen.shape) != hw:
        raise ValueError(f"screen must be {hw} float32")
    if cell_idx.dtype not in (torch.int32, torch.int64) or tuple(cell_idx.shape) != hw:
        raise ValueError(f"cell_idx must be {hw} int32 or int64")
    if n_cells < 1:
        raise ValueError("n_cells must be >= 1")
    if not (palette.device == screen.device == cell_idx.device == images.device):
        raise ValueError("images, palette, screen and cell_idx must be on one device")


def _pick(images: torch.Tensor, palette: torch.Tensor, screen: torch.Tensor,
          cell_idx: torch.Tensor, n_cells: int) -> torch.Tensor:
    """The halftone pick: (B, H, W, 3) u8 or float32 frames -> (B, H, W)
    int64 palette indices. A pixel takes its cell's colour (the palette
    colour nearest the cell's average) where ``1 - gray/255 > screen``, the
    first brightest palette colour (the paper) elsewhere."""
    _check(images, palette, screen, cell_idx, n_cells)
    b, h, w, _ = images.shape
    dev = images.device
    img = images.to(torch.float32)
    gray_norm = _luma(img) / torch.tensor(255.0, dtype=torch.float32, device=dev)

    pal_bright = _luma(palette)
    paper_idx = _first(pal_bright, pal_bright.amax())

    # Per-cell average colour (segment sums), then the nearest colour a cell.
    flat_idx = cell_idx.reshape(-1).to(torch.int64)
    sums = torch.zeros((b, n_cells, 3), dtype=torch.float32, device=dev)
    sums.index_add_(1, flat_idx, img.reshape(b, h * w, 3))
    counts = torch.zeros((n_cells,), dtype=torch.float32, device=dev)
    counts.index_add_(0, flat_idx, torch.ones((h * w,), dtype=torch.float32, device=dev))
    avgs = sums / counts.clamp(min=1.0)[None, :, None]
    cell_pal = _cell_palette(avgs.reshape(b * n_cells, 3), palette).view(b, n_cells)

    place_ink = (1.0 - gray_norm) > screen
    return torch.where(place_ink, cell_pal[:, flat_idx].view(b, h, w), paper_idx)


def halftone_dither_batch(images: torch.Tensor, palette: torch.Tensor,
                          screen: torch.Tensor, cell_idx: torch.Tensor,
                          n_cells: int) -> torch.Tensor:
    """Batched halftone: (B, H, W, 3) -> (B, H, W, 3) u8 palette colours
    (truncated from the float32 palette), one screen and cell layout for
    every frame."""
    idx = _pick(images, palette, screen, cell_idx, n_cells)
    return palette[idx].to(torch.int32).to(torch.uint8)


def halftone_dither_batch_indices(images: torch.Tensor, palette: torch.Tensor,
                                  screen: torch.Tensor, cell_idx: torch.Tensor,
                                  n_cells: int) -> torch.Tensor:
    """Batched index-emitting halftone: (B, H, W) u8 palette indices, the
    pick of ``halftone_dither_batch`` without the colour gather (palettes of
    up to 256 colours)."""
    if palette.shape[0] > 256:
        raise ValueError("the u8 index output requires a palette <= 256 colors")
    return _pick(images, palette, screen, cell_idx, n_cells).to(torch.uint8)

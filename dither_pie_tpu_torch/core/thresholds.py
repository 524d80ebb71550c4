"""Threshold screens for ordered dithering: Bayer/PSX matrices, blue noise,
interleaved gradient noise (IGN), polka-dot tiles.

Copied from ``dither_pie_tpu/core/thresholds.py`` (importing the JAX package
pulls in jax): the matrices verbatim with their hand-entered quirks, and the
numpy generators unchanged, so every screen is bit for bit the JAX
package's. ``ign_thresholds`` is the one device function: the JAX
sequence of float32 ops, one eager torch op per jnp op, so each op rounds
on its own and the map equals ``ign_thresholds_np`` bitwise on the CPU and
on the card.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from dither_pie_tpu_torch.api.runtime import DeviceLike, resolve_device

# ---------------------------------------------------------------------------
# Ordered threshold matrices (pre-normalized floats in [0, 1]).
# Verbatim numeric data — see module docstring parity notes.
# ---------------------------------------------------------------------------

BAYER2x2 = np.array(
    [[0.25, 0.75],
     [1.0, 0.5]],
    dtype=np.float32,
)

BAYER4x4 = np.array(
    [[0.03125, 0.53125, 0.15625, 0.65625],
     [0.78125, 0.28125, 0.90625, 0.40625],
     [0.21875, 0.71875, 0.09375, 0.59375],
     [0.96875, 0.46875, 0.84375, 0.34375]],
    dtype=np.float32,
)

BAYER8x8 = np.array(
    [[0.015625, 0.515625, 0.140625, 0.640625, 0.046875, 0.546875, 0.171875, 0.671875],
     [0.765625, 0.265625, 0.890625, 0.390625, 0.796875, 0.296875, 0.921875, 0.421875],
     [0.203125, 0.703125, 0.078125, 0.578125, 0.234375, 0.734375, 0.109375, 0.609375],
     [0.953125, 0.453125, 0.828125, 0.328125, 0.984375, 0.484375, 0.84375, 0.34375],
     [0.0625, 0.5625, 0.1875, 0.6875, 0.03125, 0.53125, 0.15625, 0.65625],
     [0.8125, 0.3125, 0.9375, 0.4375, 0.78125, 0.28125, 0.90625, 0.40625],
     [0.25, 0.75, 0.125, 0.625, 0.21875, 0.71875, 0.09375, 0.59375],
     [1.0, 0.5, 0.875, 0.375, 0.96875, 0.46875, 0.84375, 0.34375]],
    dtype=np.float32,
)

BAYER16x16 = np.array(
    [[0.00390625, 0.50390625, 0.12890625, 0.62890625, 0.03515625, 0.53515625, 0.16015625, 0.66015625,
      0.01171875, 0.51171875, 0.13671875, 0.63671875, 0.04296875, 0.54296875, 0.16796875, 0.66796875],
     [0.75390625, 0.25390625, 0.87890625, 0.37890625, 0.78515625, 0.28515625, 0.91015625, 0.41015625,
      0.76171875, 0.26171875, 0.88671875, 0.38671875, 0.79296875, 0.29296875, 0.91796875, 0.41796875],
     [0.19140625, 0.69140625, 0.06640625, 0.56640625, 0.22265625, 0.72265625, 0.09765625, 0.59765625,
      0.19921875, 0.69921875, 0.07421875, 0.57421875, 0.23046875, 0.73046875, 0.10546875, 0.60546875],
     [0.94140625, 0.44140625, 0.81640625, 0.31640625, 0.97265625, 0.47265625, 0.84765625, 0.34765625,
      0.94921875, 0.44921875, 0.82421875, 0.32421875, 0.98046875, 0.48046875, 0.85546875, 0.35546875],
     [0.05078125, 0.55078125, 0.17578125, 0.67578125, 0.01953125, 0.51953125, 0.14453125, 0.64453125,
      0.05859375, 0.55859375, 0.18359375, 0.68359375, 0.02734375, 0.52734375, 0.15234375, 0.65234375],
     [0.80078125, 0.30078125, 0.92578125, 0.42578125, 0.76953125, 0.26953125, 0.89453125, 0.39453125,
      0.80859375, 0.30859375, 0.93359375, 0.43359375, 0.77734375, 0.27734375, 0.90234375, 0.40234375],
     [0.23828125, 0.73828125, 0.11328125, 0.61328125, 0.20703125, 0.70703125, 0.08203125, 0.58203125,
      0.24609375, 0.74609375, 0.12109375, 0.62109375, 0.21484375, 0.71484375, 0.08984375, 0.58984375],
     [0.98828125, 0.48828125, 0.86328125, 0.36328125, 0.95703125, 0.45703125, 0.83203125, 0.33203125,
      0.99609375, 0.49609375, 0.87109375, 0.37109375, 0.96484375, 0.46484375, 0.83984375, 0.33984375],
     [0.015625, 0.515625, 0.140625, 0.640625, 0.046875, 0.546875, 0.171875, 0.671875,
      0.0078125, 0.5078125, 0.1328125, 0.6328125, 0.0390625, 0.5390625, 0.1640625, 0.6640625],
     [0.765625, 0.265625, 0.890625, 0.390625, 0.796875, 0.296875, 0.921875, 0.421875,
      0.7578125, 0.2578125, 0.8828125, 0.3828125, 0.7890625, 0.2890625, 0.9140625, 0.4140625],
     [0.203125, 0.703125, 0.078125, 0.578125, 0.234375, 0.734375, 0.109375, 0.609375,
      0.1953125, 0.6953125, 0.0703125, 0.5703125, 0.2265625, 0.7265625, 0.1015625, 0.6015625],
     [0.953125, 0.453125, 0.828125, 0.328125, 0.984375, 0.484375, 0.859375, 0.359375,
      0.9453125, 0.4453125, 0.8203125, 0.3203125, 0.9765625, 0.4765625, 0.8515625, 0.3515625],
     [0.0625, 0.5625, 0.1875, 0.6875, 0.03125, 0.53125, 0.15625, 0.65625,
      0.0546875, 0.5546875, 0.1796875, 0.6796875, 0.0234375, 0.5234375, 0.1484375, 0.6484375],
     [0.8125, 0.3125, 0.9375, 0.4375, 0.78125, 0.28125, 0.90625, 0.40625,
      0.8046875, 0.3046875, 0.9296875, 0.4296875, 0.7734375, 0.2734375, 0.8984375, 0.3984375],
     [0.25, 0.75, 0.125, 0.625, 0.21875, 0.71875, 0.09375, 0.59375,
      0.2421875, 0.7421875, 0.1171875, 0.6171875, 0.2109375, 0.7109375, 0.0859375, 0.5859375],
     [1.0, 0.5, 0.875, 0.375, 0.96875, 0.46875, 0.84375, 0.34375,
      0.9921875, 0.4921875, 0.8671875, 0.3671875, 0.9609375, 0.4609375, 0.8359375, 0.3359375]],
    dtype=np.float32,
)

PSX4x4 = np.array(
    [[0.0625, 0.5625, 0.1875, 0.6875],
     [0.8125, 0.3125, 0.9375, 0.4375],
     [0.1875, 0.6875, 0.0625, 0.5625],
     [0.9375, 0.4375, 0.8125, 0.3125]],
    dtype=np.float32,
)

BAYER_MATRICES: Dict[str, np.ndarray] = {
    "2x2": BAYER2x2,
    "4x4": BAYER4x4,
    "8x8": BAYER8x8,
    "16x16": BAYER16x16,
    "psx4x4": PSX4x4,
    "psx": PSX4x4,
}


def bayer_matrix(size: str = "4x4") -> np.ndarray:
    """Look up a Bayer/PSX threshold matrix; unknown sizes fall back to 4x4
    (matching the reference's dithering_lib.py:430-442)."""
    return BAYER_MATRICES.get(size, BAYER4x4)


# ---------------------------------------------------------------------------
# Blue noise
# ---------------------------------------------------------------------------

_BLUE_NOISE_CACHE: Dict[Tuple[int, int], np.ndarray] = {}


def generate_blue_noise(size: int = 64, seed: int = 42) -> np.ndarray:
    """Blue-noise threshold matrix in [0, 1].

    Exact algorithmic twin of the reference's naive generator
    (dithering_lib.py:381-399): shuffle all coordinates with
    ``RandomState(seed)``, then repeatedly rank the coordinate whose minimum
    distance to already-placed points is largest (first such coordinate in
    shuffled order breaks ties, matching Python ``max``). The inner
    min-distance update is vectorized, so this is fast enough to not need the
    reference's size cap, though we keep the same cached-per-(size, seed)
    behavior.
    """
    n = size * size
    rng = np.random.RandomState(seed)
    # The reference shuffles a Python list of (r, c) tuples. RandomState.shuffle
    # performs the same Fisher-Yates draws on a list and on a 2-D array's rows,
    # so shuffling the coordinate array reproduces the identical permutation.
    coords = np.array([(r, c) for r in range(size) for c in range(size)], dtype=np.int64)
    rng.shuffle(coords)

    bn = np.zeros((size, size), dtype=np.float32)
    # min_dist tracked per remaining coordinate, in shuffled list order.
    min_dist = np.full(n, np.inf, dtype=np.float64)
    active = np.ones(n, dtype=bool)
    denom = float(n - 1) + 1e-9

    rr = coords[:, 0].astype(np.float64)
    cc = coords[:, 1].astype(np.float64)

    for i in range(n):
        # Python max() returns the FIRST maximal element in iteration order;
        # np.argmax over inactive-masked values does the same.
        masked = np.where(active, min_dist, -np.inf)
        best = int(np.argmax(masked))
        br, bc = coords[best]
        bn[br, bc] = i / denom
        active[best] = False
        d2 = (rr - br) ** 2 + (cc - bc) ** 2
        np.minimum(min_dist, d2, out=min_dist)

    return bn


def blue_noise_cached(size: int = 64, seed: int = 42) -> np.ndarray:
    """Per-process cache keyed on (size, seed), mirroring
    ``BlueNoiseDitherStrategy._cache`` (the reference's dithering_lib.py:458)."""
    key = (size, seed)
    if key not in _BLUE_NOISE_CACHE:
        _BLUE_NOISE_CACHE[key] = generate_blue_noise(size, seed)
    return _BLUE_NOISE_CACHE[key]


# ---------------------------------------------------------------------------
# Interleaved Gradient Noise
# ---------------------------------------------------------------------------


def _f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float (exact in any float32
    op, so the torch scalar behaves as the JAX package's jnp.float32)."""
    return float(np.float32(x))


def ign_thresholds(h: int, w: int, scale: float = 1.0, seed: int = 0,
                   device: DeviceLike = "cuda") -> torch.Tensor:
    """Per-pixel IGN threshold map of shape (h, w), float32, on ``device``
    (the card unless the caller asks for the CPU, as every entry point of
    the port).

    ``fract(52.9829189 * fract(0.06711056*x + 0.00583715*y))`` with the
    reference's seed offsets (x += seed*0.37, y += seed*0.73) and frequency
    scale. The same eager float32 ops as the JAX package's, in its order
    and with no fused multiply-add.
    """
    dev = resolve_device(device)
    xv = torch.arange(w, dtype=torch.float32, device=dev)[None, :] + _f32(seed * 0.37)
    yv = torch.arange(h, dtype=torch.float32, device=dev)[:, None] + _f32(seed * 0.73)
    xv = xv * _f32(scale)
    yv = yv * _f32(scale)
    t = xv * _f32(0.06711056) + yv * _f32(0.00583715)
    t = t - torch.floor(t)
    t = t * _f32(52.9829189)
    return t - torch.floor(t)


def ign_thresholds_np(h: int, w: int, scale: float = 1.0, seed: int = 0) -> np.ndarray:
    """NumPy twin of :func:`ign_thresholds`."""
    x = np.arange(w, dtype=np.float32)
    y = np.arange(h, dtype=np.float32)
    xv, yv = np.meshgrid(x, y)
    xv = (xv + np.float32(seed * 0.37)) * np.float32(scale)
    yv = (yv + np.float32(seed * 0.73)) * np.float32(scale)
    t = xv * np.float32(0.06711056) + yv * np.float32(0.00583715)
    t = t - np.floor(t)
    t = t * np.float32(52.9829189)
    return t - np.floor(t)


# ---------------------------------------------------------------------------
# Polka dot
# ---------------------------------------------------------------------------


def polka_dot_matrix(tile_size: int = 8, gamma: float = 1.5) -> np.ndarray:
    """Radial threshold tile ``clip(1 - (dist/max_dist)^gamma, 0, 1)``."""
    x = np.arange(tile_size)
    y = np.arange(tile_size)
    xv, yv = np.meshgrid(x, y)
    cx = (tile_size - 1) / 2
    cy = (tile_size - 1) / 2
    dist = np.sqrt((xv - cx) ** 2 + (yv - cy) ** 2)
    max_dist = np.sqrt(cx**2 + cy**2)
    norm_dist = dist / (max_dist + 1e-9)
    thresh = 1.0 - (norm_dist**gamma)
    return np.clip(thresh, 0, 1).astype(np.float32)


def tile_threshold_map(matrix: np.ndarray, h: int, w: int) -> np.ndarray:
    """Tile a small threshold matrix over an (h, w) canvas (host-side)."""
    th, tw = matrix.shape
    reps = ((h + th - 1) // th, (w + tw - 1) // tw)
    return np.tile(matrix, reps)[:h, :w]

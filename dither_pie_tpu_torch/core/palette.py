"""Palette extraction: median-cut, k-means (kmeans++ and Lloyd), uniform cube.

* ``median_cut_palette``, ``uniform_palette`` and ``as_palette_array`` are
  host Python, copied from ``dither_pie_tpu/core/palette.py`` and identical
  to it: same unique-colour order, same stable sorts, same truncating
  averages.
* ``kmeans_palette`` keeps the JAX package's seeded numpy subsample
  (``np.random.RandomState(random_state)``, at most ``sample_cap`` pixels)
  and fits on the given ``torch.device``: kmeans++ seeding draws from a
  seeded ``torch.Generator`` on that device, then 64 Lloyd iterations. The
  ``jax.random`` stream cannot be reproduced, so the centres differ from
  the JAX package's; both are deterministic per seed and land at comparable
  inertia (tests/test_torch_palette.py states the bound).
* ``DITHER_PIE_TPU_KMEANS=sklearn`` (or ``reference``, any case) routes
  ``kmeans_palette`` to the reference's exact sklearn k-means on the host,
  as the JAX package does; that route needs scikit-learn and raises
  ``ImportError`` without it (it never falls back to the torch fit).
"""

from __future__ import annotations

import math
import os
from typing import List, Tuple

import numpy as np
import torch

from dither_pie_tpu_torch.api.runtime import DeviceLike, resolve_device

RGB = Tuple[int, int, int]


# ---------------------------------------------------------------------------
# Median cut (host: a small recursive sort, no device work)
# ---------------------------------------------------------------------------


def _dominant_channel(colors: List[RGB]) -> int:
    best_rng, best_ch = -1, 0
    for ch in range(3):
        vals = [c[ch] for c in colors]
        rng = max(vals) - min(vals)
        if rng > best_rng:
            best_rng, best_ch = rng, ch
    return best_ch


def _median_cut(colors: List[RGB], depth: int) -> List[RGB]:
    if depth == 0 or len(colors) == 0:
        if not colors:
            return [(0, 0, 0)]
        # Truncating int() average per channel, as the reference does.
        avg = tuple(int(sum(c) / len(c)) for c in zip(*colors))
        return [avg]
    channel = _dominant_channel(colors)
    colors.sort(key=lambda x: x[channel])  # stable
    mid = len(colors) // 2
    return _median_cut(colors[:mid], depth - 1) + _median_cut(colors[mid:], depth - 1)


def median_cut_palette(rgb_u8: np.ndarray, num_colors: int) -> List[RGB]:
    """Median-cut palette from an (H, W, 3) uint8 array."""
    if num_colors < 1:
        num_colors = 1
    # list(set(...)) over row-major python int tuples reproduces the
    # reference's `list(set(image.getdata()))` iteration order.
    flat = rgb_u8.reshape(-1, 3).tolist()
    unique_cols = list(set(map(tuple, flat)))
    depth = int(math.log2(num_colors)) if num_colors > 1 else 0
    return _median_cut(unique_cols, depth)


# ---------------------------------------------------------------------------
# k-means (device)
# ---------------------------------------------------------------------------


def _pairwise_sq(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(M, 3) x (k, 3) -> (M, k) squared distances from broadcast
    differences. No matmul, so no TF32 on the card whatever the global
    matmul flags say (the JAX package asks XLA for Precision.HIGHEST)."""
    diff = x[:, None, :] - c[None, :, :]
    return (diff * diff).sum(-1)


def _kmeans_fit(points: torch.Tensor, generator: torch.Generator, k: int,
                iters: int = 64) -> torch.Tensor:
    """kmeans++ init + Lloyd iterations on ``points.device``.

    ``points``: (M, 3) float32. Returns (k, 3) float32 centers. Every
    reduction is a plain ``sum`` over a fixed axis (no atomics), so the fit
    is deterministic per generator seed on the card too."""
    m = points.shape[0]
    dev = points.device
    centers = torch.zeros((k, 3), dtype=torch.float32, device=dev)
    first = points[torch.randint(0, m, (1,), generator=generator, device=dev)]
    centers[0] = first[0]
    min_d = ((points - first) ** 2).sum(-1)
    for i in range(1, k):
        # Sample proportionally to squared distance; the 1e-12 floor is the
        # JAX package's logit floor (already-chosen points keep a vanishing
        # weight, and an all-duplicate input stays a valid distribution).
        prob = min_d.clamp_min(1e-12)
        idx = torch.multinomial(prob / prob.sum(), 1, generator=generator)
        new_c = points[idx]  # (1, 3)
        centers[i] = new_c[0]
        min_d = torch.minimum(min_d, ((points - new_c) ** 2).sum(-1))

    for _ in range(iters):
        assign = _pairwise_sq(points, centers).argmin(-1)
        one_hot = torch.nn.functional.one_hot(assign, k).to(torch.float32)
        counts = one_hot.sum(0)  # (k,)
        sums = (one_hot[:, :, None] * points[:, None, :]).sum(0)  # (k, 3)
        new_centers = sums / counts.clamp_min(1.0)[:, None]
        # Empty clusters keep their previous center.
        centers = torch.where(counts[:, None] > 0, new_centers, centers)
    return centers


KMEANS_ENV = "DITHER_PIE_TPU_KMEANS"


def _kmeans_palette_sklearn(
    rgb_u8: np.ndarray, num_colors: int, random_state: int, sample_cap: int
) -> List[RGB]:
    """The reference's exact k-means path, copied from the JAX package:
    unseeded stdlib ``random.sample`` subsample above the cap, sklearn
    KMeans with the given random_state, truncating int cast of the centers.
    Bit-identical to the JAX package's when no sampling happens (<= cap
    pixels)."""
    import random

    try:
        from sklearn.cluster import KMeans
    except ImportError as e:
        raise ImportError(
            f"{KMEANS_ENV}={os.environ.get(KMEANS_ENV)!r} asks for "
            "scikit-learn's KMeans, which is not importable; unset "
            f"{KMEANS_ENV} to use the torch fit") from e

    pix = rgb_u8.reshape(-1, 3)
    if len(pix) > sample_cap:
        idx = random.sample(range(len(pix)), sample_cap)
        pix = pix[idx]
    km = KMeans(n_clusters=max(1, min(int(num_colors), len(pix))),
                random_state=random_state)
    km.fit(pix)
    out = [tuple(int(v) for v in c) for c in km.cluster_centers_.astype(int)]
    while len(out) < num_colors:
        out.append(out[-1])
    return out


def kmeans_palette(
    rgb_u8: np.ndarray,
    num_colors: int,
    random_state: int = 42,
    sample_cap: int = 10_000,
    device: DeviceLike = "cuda",
) -> List[RGB]:
    """k-means palette from an (H, W, 3) uint8 array (seeded, deterministic).

    Keeps the reference's <=10k-pixel subsample cap with the JAX package's
    seeded numpy sampler; ``random_state`` also seeds the kmeans++ draws.
    ``DITHER_PIE_TPU_KMEANS=sklearn`` (read at call time) routes to the
    reference's sklearn algorithm on the host instead; ``device`` is then
    ignored."""
    if os.environ.get(KMEANS_ENV, "").lower() in ("sklearn", "reference"):
        return _kmeans_palette_sklearn(rgb_u8, num_colors, random_state,
                                       sample_cap)
    dev = resolve_device(device)
    pix = rgb_u8.reshape(-1, 3)
    if len(pix) > sample_cap:
        rng = np.random.RandomState(random_state)
        idx = rng.choice(len(pix), size=sample_cap, replace=False)
        pix = pix[idx]
    k = max(1, min(int(num_colors), len(pix)))
    pts = torch.as_tensor(pix.astype(np.float32), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(random_state))
    centers = _kmeans_fit(pts, gen, k)
    centers_np = centers.cpu().numpy().astype(int)
    out = [tuple(int(v) for v in c) for c in centers_np]
    # Pad (degenerate tiny inputs) so callers always get num_colors entries.
    while len(out) < num_colors:
        out.append(out[-1])
    return out


# ---------------------------------------------------------------------------
# Uniform cube
# ---------------------------------------------------------------------------


def uniform_palette(num_colors: int) -> List[RGB]:
    """Uniform RGB-cube palette, faithful to the reference's walk including
    the break quirk that only exits the innermost loop."""
    c: List[RGB] = []
    cube = int(math.ceil(num_colors ** (1 / 3)))
    for r in range(cube):
        for g in range(cube):
            for b in range(cube):
                if len(c) >= num_colors:
                    break
                rr = int(r * 255 / (cube - 1)) if cube > 1 else 128
                gg = int(g * 255 / (cube - 1)) if cube > 1 else 128
                bb = int(b * 255 / (cube - 1)) if cube > 1 else 128
                c.append((rr, gg, bb))
    return c[:num_colors]


def as_palette_array(palette: List[RGB]) -> np.ndarray:
    """List of RGB tuples -> (P, 3) float32 array; singleton palettes are
    padded by duplicating the color so top-2 queries stay well-defined."""
    arr = np.asarray(palette, dtype=np.float32)
    if arr.ndim != 2 or arr.shape[1] != 3:
        raise ValueError(f"palette must be (P, 3), got {arr.shape}")
    if arr.shape[0] == 1:
        arr = np.concatenate([arr, arr], axis=0)
    return arr

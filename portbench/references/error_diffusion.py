"""The plain reference of the error-diffusion configurations.

Plain PyTorch, no kernel, no cache, nothing of the program imported: the
k-means palette worked out again from frame 0, and sequential fixed-weight
error diffusion, row-major, computed one anti-diagonal at a time. A pixel
(x, y) depends only on pixels scanned before it; with the skew
d = x + s*y (s the least integer with dx + s*dy >= 1 for every weight) all
pixels of one diagonal depend only on earlier diagonals, so a diagonal is
one vector step and the result equals the row-major scan exactly.

The arithmetic is the row-major scan's, in ``dtype``: a working buffer holds
each pixel's value and takes the weighted errors in the order the row-major
scan adds them (earlier source rows first, then left to right); the value
is clamped to 0..255, the nearest colour is the first minimum of
(dr*dr + dg*dg) + db*db, and the error (value - colour) times each weight is
added to the receiving pixels. Each operation rounds on its own (one eager
op each). In float32 this is the configuration's precision; the control
runs the same code in bfloat16.

The palette: the seeded numpy subsample of at most ``sample_cap`` pixels,
kmeans++ seeding drawn from a ``torch.Generator`` seeded with
``random_state`` on the device, then Lloyd iterations, the centres
truncated to integers. The draws come from a generator, so the reference
follows that documented recipe step by step to draw the same numbers. That
recipe is checked apart by ``lloyd_gap``, in NumPy float64 and sharing no
code with the fit: a k-means palette is a fixed point of Lloyd's step.

A configuration names this module in its ``reference`` key; the harness
calls ``palette``, ``palette_checks``, ``outputs`` and ``scan_work``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench import roofline

Entry = Tuple[int, int, float]


def fixed_entries(weights: Sequence[Sequence[int]], divisor: int) -> List[Entry]:
    """(dx, dy, w) with w = weight / divisor rounded once to float32."""
    return [(int(dx), int(dy), float(np.float32(wt / divisor))) for dx, dy, wt in weights]


def skew_of(entries: Sequence[Entry]) -> int:
    """Least s >= 1 with dx + s*dy >= 1 for every entry."""
    s = 1
    for dx, dy, _ in entries:
        if dy > 0:
            s = max(s, math.ceil((1 - dx) / dy))
        elif dx < 1:
            raise ValueError("a weight on the same row must point right")
    return s


def subsample(frame0: np.ndarray, random_state: int, sample_cap: int) -> np.ndarray:
    """The (m, 3) uint8 pixels a k-means fit sees: at most ``sample_cap``,
    drawn without replacement by numpy's ``RandomState(random_state)``."""
    pix = frame0.reshape(-1, 3)
    if len(pix) > sample_cap:
        pick = np.random.RandomState(random_state).choice(len(pix), size=sample_cap,
                                                          replace=False)
        pix = pix[pick]
    return pix


def lloyd_gap(pixels: np.ndarray, palette: np.ndarray, rows: int = 2048) -> float:
    """One Lloyd step from ``palette`` over ``pixels``, in NumPy float64:
    each pixel goes to its nearest colour (the first on a tie), and the
    result is the widest distance, over colours that got a pixel and over
    channels, between a colour and the mean of its pixels. The centres of a
    converged fit, truncated to integers, lie about a unit from their means;
    a fit that skipped its Lloyd steps, or took them wrong, lies further."""
    x = pixels.reshape(-1, 3).astype(np.float64)
    c = np.asarray(palette, dtype=np.float64)
    assign = np.empty(len(x), dtype=np.int64)
    for lo in range(0, len(x), rows):
        d = ((x[lo:lo + rows, None, :] - c[None, :, :]) ** 2).sum(-1)
        assign[lo:lo + rows] = d.argmin(1)
    counts = np.bincount(assign, minlength=len(c))
    sums = np.zeros_like(c)
    np.add.at(sums, assign, x)
    used = counts > 0
    if not used.any():
        return float("inf")
    means = sums[used] / counts[used, None]
    return float(np.abs(means - c[used]).max())


def entries_of(config: Dict[str, Any]) -> List[Entry]:
    return fixed_entries(config["diffusion"]["weights"], config["diffusion"]["divisor"])


def palette(frame0: np.ndarray, config: Dict[str, Any], device: torch.device) -> np.ndarray:
    """The configuration's palette worked out again from frame 0."""
    if config["palette"]["source"] != "kmeans":
        raise ValueError(f"palette source {config['palette']['source']!r}: this reference "
                         "works out k-means palettes only")
    km = config["kmeans"]
    return kmeans_palette(frame0, int(config["palette"]["num_colors"]), km["random_state"],
                          km["sample_cap"], km["iters"], device)


def palette_checks(frame0: np.ndarray, port_palette: np.ndarray, ref_palette: np.ndarray,
                   config: Dict[str, Any]) -> Dict[str, float]:
    """``palette_diff``: the widest gap between the program's palette and
    the reference's (256 where their sizes differ); ``palette_lloyd_gap``:
    ``lloyd_gap`` of the program's palette on the fit's subsample."""
    if port_palette.shape == ref_palette.shape:
        diff = float(np.abs(port_palette.astype(np.int64) - ref_palette).max())
    else:
        diff = 256.0
    km = config["kmeans"]
    pix = subsample(frame0, km["random_state"], km["sample_cap"])
    return {"palette_diff": diff, "palette_lloyd_gap": lloyd_gap(pix, port_palette)}


def outputs(frames: np.ndarray, palette: np.ndarray, config: Dict[str, Any],
            device: torch.device, dtype: torch.dtype = torch.float32) -> np.ndarray:
    """The configuration's dithering of (N, H, W, 3) uint8 frames."""
    return error_diffusion(frames, palette, entries_of(config), device, dtype)


def scan_work(config: Dict[str, Any], frames: int, h: int, w: int,
              input_bytes: int) -> Optional[Dict[str, float]]:
    """``roofline.scan_work`` of one scan launch over ``frames`` frames of
    (h, w) whose stream holds ``input_bytes`` an element."""
    entries = entries_of(config)
    return roofline.scan_work(frames, h, w, skew_of(entries),
                              int(config["palette"]["num_colors"]), len(entries), input_bytes)


def kmeans_palette(frame0: np.ndarray, k: int, random_state: int, sample_cap: int,
                   iters: int, device: torch.device,
                   dtype: torch.dtype = torch.float32) -> np.ndarray:
    """(k, 3) int64 k-means centres of an (H, W, 3) uint8 frame, computed
    in ``dtype`` (the draws' probabilities in float32 whatever it is)."""
    pix = subsample(frame0, random_state, sample_cap)
    pts = torch.as_tensor(pix.astype(np.float32), device=device).to(dtype)
    m = pts.shape[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(random_state))
    centres = torch.zeros((k, 3), dtype=dtype, device=device)
    first = pts[torch.randint(0, m, (1,), generator=gen, device=device)]
    centres[0] = first[0]
    nearest = ((pts - first) ** 2).sum(-1)
    for i in range(1, k):
        prob = nearest.float().clamp_min(1e-12)
        pick = torch.multinomial(prob / prob.sum(), 1, generator=gen)
        centres[i] = pts[pick][0]
        nearest = torch.minimum(nearest, ((pts - pts[pick]) ** 2).sum(-1))
    for _ in range(iters):
        diff = pts[:, None, :] - centres[None, :, :]
        assign = (diff * diff).sum(-1).argmin(-1)
        one_hot = torch.nn.functional.one_hot(assign, k).to(dtype)
        counts = one_hot.sum(0)
        sums = (one_hot[:, :, None] * pts[:, None, :]).sum(0)
        moved = sums / counts.clamp_min(1.0)[:, None]
        centres = torch.where(counts[:, None] > 0, moved, centres)
    return centres.float().cpu().numpy().astype(np.int64)


def error_diffusion(frames: np.ndarray, palette: np.ndarray, entries: Sequence[Entry],
                    device: torch.device, dtype: torch.dtype = torch.float32) -> np.ndarray:
    """(N, H, W, 3) uint8 frames dithered to the (P, 3) integer palette,
    (N, H, W, 3) uint8, computed in ``dtype`` on ``device``."""
    n, h, w, _ = frames.shape
    s = skew_of(entries)
    # Row-major scan's order of arrival at a pixel: earlier source rows
    # (larger dy) first, then sources further left (larger dx) first.
    order = sorted(entries, key=lambda e: (-e[1], -e[0]))
    left = max([0] + [-dx for dx, _, _ in entries])
    right = max([0] + [dx for dx, _, _ in entries])
    below = max([0] + [dy for _, dy, _ in entries])
    wp = left + w + right
    work = torch.zeros((n, (h + below) * wp, 3), dtype=dtype, device=device)
    work.view(n, h + below, wp, 3)[:, :h, left:left + w] = (
        torch.from_numpy(frames).to(device).to(dtype))
    pal = torch.from_numpy(palette.astype(np.float32)).to(device).to(dtype)
    p = pal.shape[0]
    iota = torch.arange(p, device=device)
    weights = [torch.tensor(wt, dtype=torch.float32, device=device).to(dtype)
               for _, _, wt in order]
    idx_out = torch.zeros((n, h * w), dtype=torch.int64, device=device)
    for d in range(w + s * (h - 1)):
        y0 = max(0, -((w - 1 - d) // s))  # least y with x = d - s*y < w
        y1 = min(h - 1, d // s)
        ys = torch.arange(y0, y1 + 1, device=device)
        xs = d - s * ys
        at = ys * wp + xs + left
        cur = work[:, at].clamp(0.0, 255.0)  # (N, n, 3)
        diff = cur[:, :, None, :] - pal  # (N, n, P, 3)
        sq = diff * diff
        dist = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
        best = torch.where(dist == dist.amin(-1, keepdim=True), iota, p).amin(-1)
        err = cur - pal[best]
        for (dx, dy, _), wt in zip(order, weights):
            tgt = at + (dy * wp + dx)
            work[:, tgt] = work[:, tgt] + err * wt
        idx_out[:, ys * w + xs] = best
    pal_u8 = torch.from_numpy(palette.astype(np.uint8)).to(device)
    return pal_u8[idx_out].view(n, h, w, 3).cpu().numpy()

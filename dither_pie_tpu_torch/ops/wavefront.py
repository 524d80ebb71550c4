"""Anti-diagonal wavefront error diffusion on the H100 (mode "fixed").

Error diffusion is a 2-D sequential recurrence: pixel (x, y) depends on
already-scanned neighbours. With the skew d = x + s*y (s chosen so every
kernel offset satisfies dx + s*dy >= 1) all pixels on wavefront d depend
only on wavefronts < d, so one step processes a whole anti-diagonal.

The main path is three hand-written CUDA kernels (``kernels/csrc``), each
with a plain PyTorch version of the same function beside it here:

* K1 ``skew``: (B, H, W, 3) frames -> (D, 3B, H) stream,
  ``out[d, c*B + b, y] = x[b, y, d - s*y, c]`` (0 outside the image).
* K2 ``scan``: the wavefront scan -> (D, B, H) int32 packed colours
  ``r << 16 | g << 8 | b`` (0 outside the image).
* K3 ``unskew_unpack``: (D, B, H) packed colours -> (B, H, W, 3) uint8.

Which implementation runs is a pure function of the tensor's device: a
CUDA tensor launches the kernel (and counts the launch in
``kernels.build.LAUNCHES``), a CPU tensor runs the plain version, anything
else raises. There is no fallback between them.

Geometry: the stream has D = W + s*(H-1) steps and H lanes per frame. The
JAX package's dead rows, 128-lane rounding and 256-step bucketing are TPU
tiling and compile-cost artefacts, not part of the function.

The plain scan is bitwise equal to the golden engine's f32 twin
(``dither_pie_tpu/native/ed_scan.cpp`` ``ed_fixed_f32``): the palette
search is (dr*dr + dg*dg) + db*db in float32 with first-wins ties, and a
pixel's working value is the left fold from its image value over its
incoming errors in contributor-scan order (one error ring per entry).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from dither_pie_tpu_torch import convert
from dither_pie_tpu_torch.kernels import build
from dither_pie_tpu_torch.ops.ed_kernels import get_kernel

# Largest palette the scan serves: the running-min search. Larger palettes
# need the tournament search (ROADMAP A5).
SCAN_PALETTE_MAX = 64

# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


def _skew_params(weights: Sequence[Tuple[int, int, float]]) -> Tuple[int, int]:
    """(s, n_slots): minimal skew s.t. dx + s*dy >= 1 for all offsets, and
    the circular-buffer depth max(dx + s*dy) + 1."""
    s = 1
    for dx, dy, _ in weights:
        if dy > 0:
            s = max(s, math.ceil((1 - dx) / dy))
        elif dx < 1:
            raise ValueError("same-row offsets must have dx >= 1")
    dmax = max(dx + s * dy for dx, dy, _ in weights)
    return s, dmax + 1


def _fixed_entries(variant: str):
    """Fixed-weight entries (dx, dy, w) with pre-divided float32 weights,
    bit-equal to the JAX package's ``_fixed_entries``."""
    k = get_kernel(variant)
    return [(dx, dy, np.float32(w / k["divisor"])) for dx, dy, w in k["weights"]]


def _require_fixed(mode: str) -> None:
    if mode != "fixed":
        raise NotImplementedError(
            f"wavefront mode {mode!r} is not ported yet (ROADMAP A5); "
            "the port runs mode 'fixed'")


def _scan_params(mode: str, variant: str) -> Tuple[int, int]:
    _require_fixed(mode)
    return _skew_params(get_kernel(variant)["weights"])


def consume_order(offsets: Sequence[Tuple[int, int]]) -> list:
    """Entry indices in contributor-scan order: earlier source rows first
    (dy descending), then x ascending (dx descending). The golden engine
    accumulates into a pixel in this order, so the scan folds in it."""
    return sorted(range(len(offsets)),
                  key=lambda i: (-offsets[i][1], -offsets[i][0]))


@dataclass(frozen=True)
class ScanGeometry:
    """Everything the scan needs about one fixed-weight variant.

    ``offsets`` (n, 2) int32 (dx, dy) and ``weights`` (n,) float32, the
    pre-divided weights bit for bit, both in consume order on the CPU:
    the one weight table that the plain scan and the CUDA kernel read.
    ``ring``: the power of two >= n_slots that the CUDA kernel's per-row
    error history uses."""

    s: int
    n_slots: int
    ring: int
    offsets: torch.Tensor
    weights: torch.Tensor


@functools.lru_cache(maxsize=16)
def scan_geometry(variant: str) -> ScanGeometry:
    s, n_slots = _scan_params("fixed", variant)
    entries = _fixed_entries(variant)
    order = consume_order([(dx, dy) for dx, dy, _ in entries])
    offsets, weights = convert.entries_to_torch([entries[i] for i in order], "cpu")
    return ScanGeometry(s=s, n_slots=n_slots, ring=1 << (n_slots - 1).bit_length(),
                        offsets=offsets, weights=weights)


def stream_length(h: int, w: int, s: int) -> int:
    """Steps of the wavefront over an (h, w) frame: D = w + s*(h-1)."""
    return w + s * (h - 1)


# ---------------------------------------------------------------------------
# K1: skew
# ---------------------------------------------------------------------------


def skew_plain(images: torch.Tensor, s: int) -> torch.Tensor:
    """Plain PyTorch K1: (B, H, W, 3) -> (D, 3B, H), same dtype."""
    b, h, w, _ = images.shape
    dev = images.device
    out = torch.zeros((stream_length(h, w, s), 3 * b, h), dtype=images.dtype,
                      device=dev)
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    out[xx + s * yy, :, yy] = images.permute(1, 2, 3, 0).reshape(h, w, 3 * b)
    return out


def skew(images: torch.Tensor, s: int) -> torch.Tensor:
    """K1 on CUDA tensors, its plain version on CPU tensors."""
    if not build.on_cuda(images):
        return skew_plain(images, s)
    b, h, w, _ = images.shape
    out = torch.empty((stream_length(h, w, s), 3 * b, h), dtype=images.dtype,
                      device=images.device)
    build.extension().skew(images, out, s)
    build.LAUNCHES["skew"] += 1
    return out


# ---------------------------------------------------------------------------
# K2: scan
# ---------------------------------------------------------------------------


def scan_plain(stream: torch.Tensor, palette: torch.Tensor,
               geom: ScanGeometry, width: int) -> torch.Tensor:
    """Plain PyTorch K2: (D, 3B, H) stream -> (D, B, H) int32 packed colours.

    Push form, as the TPU kernel: each step folds the per-entry error rings
    into the image value, clamps, searches, and pushes err * w into ring
    slot (d + dx + s*dy) mod n_slots at row y + dy."""
    d_total, rows, h = stream.shape
    b = rows // 3
    dev = stream.device
    s, n_slots = geom.s, geom.n_slots
    pal_t = palette.t().contiguous()  # (3, P)
    pal_c = pal_t[:, :, None, None]  # (3, P, 1, 1)
    offsets = geom.offsets.tolist()
    weights = geom.weights.to(dev).unbind()
    ring = torch.zeros((len(offsets), n_slots, 3, b, h),
                       dtype=torch.float32, device=dev)
    out = torch.empty((d_total, b, h), dtype=torch.int32, device=dev)
    y = torch.arange(h, device=dev)
    for d in range(d_total):
        slot = d % n_slots
        cur = stream[d].view(3, b, h).to(torch.float32)
        for e in range(len(offsets)):  # entries are in consume order
            cur = cur + ring[e, slot]
        cur = cur.clamp(0.0, 255.0)
        diff = cur[:, None] - pal_c  # (3, P, B, H)
        sq = diff * diff
        idx = ((sq[0] + sq[1]) + sq[2]).argmin(0)  # first minimum wins
        chosen = pal_t[:, idx]  # (3, B, H)
        x = d - s * y
        active = (x >= 0) & (x < width)
        ci = chosen.to(torch.int32)  # truncates, as the kernel's cast
        out[d] = torch.where(active, (ci[0] << 16) | (ci[1] << 8) | ci[2], 0)
        err = (cur - chosen) * active
        for e, (dx, dy) in enumerate(offsets):
            contrib = err * weights[e]
            if dy:
                contrib = torch.roll(contrib, dy, dims=2)
                contrib[..., :dy] = 0.0
            ring[e, (d + dx + s * dy) % n_slots] = contrib
    return out


def _check_palette_size(p: int) -> None:
    if p > SCAN_PALETTE_MAX:
        raise NotImplementedError(
            f"palettes above {SCAN_PALETTE_MAX} colours need the tournament "
            "search, not ported yet (ROADMAP A5)")


def scan(stream: torch.Tensor, palette: torch.Tensor, geom: ScanGeometry,
         width: int) -> torch.Tensor:
    """K2 on CUDA tensors, its plain version on CPU tensors. ``palette`` is
    (P, 3) float32 on the stream's device, P <= SCAN_PALETTE_MAX."""
    _check_palette_size(palette.shape[0])
    if not build.on_cuda(stream):
        return scan_plain(stream, palette, geom, width)
    d_total, rows, h = stream.shape
    b = rows // 3
    hist = torch.empty((b, geom.ring, 3, h), dtype=torch.float32,
                       device=stream.device)
    out = torch.empty((d_total, b, h), dtype=torch.int32, device=stream.device)
    build.extension().ed_scan_fixed(stream, palette, hist, out, geom.offsets,
                                    geom.weights, geom.s, width)
    build.LAUNCHES["ed_scan_fixed"] += 1
    return out


# ---------------------------------------------------------------------------
# K3: unskew + unpack
# ---------------------------------------------------------------------------

_SHIFTS = (16, 8, 0)


def unskew_unpack_plain(col: torch.Tensor, s: int, h: int, w: int) -> torch.Tensor:
    """Plain PyTorch K3: (D, B, H) int32 -> (B, H, W, 3) uint8."""
    dev = col.device
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    v = col[xx + s * yy, :, yy].permute(2, 0, 1)  # (B, H, W)
    shifts = torch.tensor(_SHIFTS, dtype=torch.int32, device=dev)
    return ((v[..., None] >> shifts) & 255).to(torch.uint8)


def unskew_unpack(col: torch.Tensor, s: int, h: int, w: int) -> torch.Tensor:
    """K3 on CUDA tensors, its plain version on CPU tensors."""
    if not build.on_cuda(col):
        return unskew_unpack_plain(col, s, h, w)
    out = torch.empty((col.shape[1], h, w, 3), dtype=torch.uint8,
                      device=col.device)
    build.extension().unskew_unpack(col, out, s)
    build.LAUNCHES["unskew_unpack"] += 1
    return out


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _run(images: torch.Tensor, palette: torch.Tensor,
         variant: str) -> torch.Tensor:
    """(B, H, W, 3) uint8 or float32 frames + (P, 3) float32 palette on the
    same device -> (B, H, W, 3) uint8 palette colours. Any B."""
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"images must be (B, H, W, 3), got {tuple(images.shape)}")
    if images.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"images must be uint8 or float32, got {images.dtype}")
    if palette.dtype != torch.float32 or palette.dim() != 2 or palette.shape[1] != 3:
        raise ValueError("palette must be a (P, 3) float32 tensor")
    if palette.device != images.device:
        raise ValueError(f"palette on {palette.device}, images on {images.device}")
    geom = scan_geometry(variant)
    _, h, w, _ = images.shape
    stream = skew(images.contiguous(), geom.s)
    col = scan(stream, palette.contiguous(), geom, w)
    return unskew_unpack(col, geom.s, h, w)


def _check_slice(mode: str, planar: bool, return_indices: bool,
                 dense_search: Optional[str]) -> None:
    """Raise for the options outside this slice, naming the ROADMAP item."""
    _require_fixed(mode)
    if planar:
        raise NotImplementedError(
            "planar (3, B, H, W) batches are not ported yet (ROADMAP A5)")
    if return_indices:
        raise NotImplementedError(
            "the index stream is not ported yet (ROADMAP A5, A6)")
    if dense_search not in (None, "exact"):
        raise NotImplementedError(
            f"dense_search={dense_search!r}: the matrix-unit dense search is "
            "not ported yet (ROADMAP A5)")


def ed_fixed_wavefront(img: torch.Tensor, palette: torch.Tensor,
                       variant: str) -> torch.Tensor:
    """One (H, W, 3) frame -> (H, W, 3) uint8."""
    return _run(img[None], palette, variant)[0]


def ed_batch_wavefront(images: torch.Tensor, palette: torch.Tensor,
                       mode: str = "fixed", variant: str = "floyd_steinberg",
                       planar: bool = False, return_indices: bool = False,
                       dense_search: Optional[str] = None) -> torch.Tensor:
    """Batched entry of the video path: (B, H, W, 3) frames in one scan."""
    _check_slice(mode, planar, return_indices, dense_search)
    return _run(images, palette, variant)


def wavefront_device_fn(mode: str, variant: str, h: int, w: int, p: int,
                        batch: int, planar: bool = False,
                        dense_search: str = "exact") -> Callable:
    """``fn(frames (batch, h, w, 3), palette (p, 3) f32) -> (batch, h, w, 3)
    uint8``: the shape-checked device function of one configuration, as
    the JAX package's benchmark builds it. Raises at construction for what
    the slice does not serve."""
    _check_slice(mode, planar, False, dense_search)
    _check_palette_size(p)
    shape = (batch, h, w, 3)

    def fn(frames: torch.Tensor, palette: torch.Tensor) -> torch.Tensor:
        if tuple(frames.shape) != shape or tuple(palette.shape) != (p, 3):
            raise ValueError(
                f"expected frames {shape} and palette ({p}, 3), got "
                f"{tuple(frames.shape)} and {tuple(palette.shape)}")
        return _run(frames, palette, variant)

    return fn

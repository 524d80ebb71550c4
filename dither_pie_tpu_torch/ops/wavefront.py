"""Anti-diagonal wavefront error diffusion on the H100, every mode.

Error diffusion is a 2-D sequential recurrence: pixel (x, y) depends on
already-scanned neighbours. With the skew d = x + s*y (s chosen so every
kernel offset satisfies dx + s*dy >= 1) all pixels on wavefront d depend
only on wavefronts < d, so one step processes a whole anti-diagonal.

The path is hand-written CUDA kernels (``kernels/csrc``), each with a
plain PyTorch version of the same function beside it here:

* K1 ``skew``: (B, H, W, 3) frames -> (D, 3B, H) stream,
  ``out[d, c*B + b, y] = x[b, y, d - s*y, c]`` (0 outside the image).
* K6 ``skew_planar``: compact planes (R, H, W) -> (D, R, H) stream,
  ``out[d, r, y] = x[r, y, d - s*y]``; the planes of a (3, B, H, W) batch
  (rows c*B + b) give K1's stream bit for bit.
* K2 ``scan``: the wavefront scan -> (D, B, H) int32 packed colours
  ``r << 16 | g << 8 | b`` (0 outside the image), palettes of up to
  ``PACKED_PALETTE_MAX`` colours.
* K3 ``unskew_unpack``: (D, B, H) packed colours -> (B, H, W, 3) uint8, or
  the planes (3, B, H, W) with ``planar_out``.
* K8 ``scan_idx``: the same scan for palettes of up to
  ``INDEX_PALETTE_MAX`` colours -> (D, B, H) int32 palette indices (0
  outside the image). It is also K2's ``emit_idx`` stream of the JAX
  package: the same body with the index as its output.
* K5 ``unskew_idx``: (D, B, H) indices -> the (B, H, W) index stream, uint8
  for palettes of up to 256 colours, uint16 above.
* K9 ``unskew_select``: (D, B, H) indices + palette -> (B, H, W, 3) uint8.

Palettes of up to 1024 colours run K1 -> K2 -> K3, larger ones K1 -> K8 ->
K9. ``planar`` batches (3, B, H, W), the layout of the video pipeline's
zero-copy flow, run K6 -> K2 -> K3 and stay planar; ``return_indices``
(either layout) runs the skew -> K8 -> K5 and returns the index stream,
whose ``palette.astype(uint8)[idx]`` is the colour output exactly. Both
stop at ``PACKED_PALETTE_MAX`` colours, as in the JAX package. The modes are "fixed" (8 variants), "ostromoukhov" (per-pixel weights
from a luminance-indexed table), "hybrid" (the error projected onto luma
and chroma), "perceptual" (weights scaled by a per-pixel sensitivity) and
"adaptive" (the error gated per pixel); the last two take an ``aux``
(B, H, W) float32 map.

Which implementation runs is a pure function of the tensor's device: a
CUDA tensor launches the kernel (and counts the launch in
``kernels.build.LAUNCHES``), a CPU tensor runs the plain version, anything
else raises. There is no fallback between them.

Geometry: the stream has D = W + s*(H-1) steps and H lanes per frame. The
JAX package's dead rows, 128-lane rounding, 256-step bucketing, batch
padding and splitting, sentinel palette rows and bit-reversed palette order
are TPU tiling, memory and compile-cost artefacts, not part of the function.

The plain scan is bitwise equal to the golden engine's f32 twins
(``dither_pie_tpu/native/ed_scan.cpp`` ``ed_fixed_f32``,
``ed_ostromoukhov_f32``, ``ed_hybrid_f32``, ``ed_perceptual_f32``,
``ed_adaptive_f32``): the palette search is (dr*dr + dg*dg) + db*db in
float32 with first-wins ties, and a pixel's working value is the left fold
from its image value over its incoming errors in contributor-scan order
(one error ring per entry).
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
from dither_pie_tpu_torch.ops.ed_kernels import OSTROMOUKHOV_ARRAY, get_kernel

# Largest palette of the packed-colour scan K2 (its shared-memory palette);
# larger palettes run the index scan K8 and its epilogue K9.
PACKED_PALETTE_MAX = 1024
# Largest palette of the index scan K8: 192 KB of shared memory. The golden
# engine stops at 4096 colours.
INDEX_PALETTE_MAX = 16384

# The scan's modes; a mode's position is its id in the CUDA kernel.
MODES = ("fixed", "ostromoukhov", "hybrid", "perceptual", "adaptive")
_AUX_MODES = ("perceptual", "adaptive")
# Modes that clamp the working value to 0..255 before the palette search.
_CLAMP_MODES = ("fixed", "ostromoukhov", "hybrid")
_LUMA = (0.299, 0.587, 0.114)

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


# Hybrid, perceptual and adaptive diffuse with Floyd-Steinberg's weights.
_FS_ENTRIES = [(1, 0, np.float32(7 / 16)), (-1, 1, np.float32(3 / 16)),
               (0, 1, np.float32(5 / 16)), (1, 1, np.float32(1 / 16))]
# Ostromoukhov's three targets; entry k takes column k of the weight table.
_OSTRO_OFFSETS = [(1, 0), (-1, 1), (0, 1)]


@functools.lru_cache(maxsize=1)
def _ostro_weight_table() -> np.ndarray:
    """(256, 3) float32 Ostromoukhov weights, pre-divided on the host:
    float64 division, then float32, as the golden engine divides
    (``native/ed_scan.cpp`` ``ed_ostromoukhov_f32``). Rows whose divisor is
    0 stay 0 (the golden engine skips them)."""
    tbl = OSTROMOUKHOV_ARRAY.astype(np.float64)
    div = tbl.sum(axis=1, keepdims=True)
    return np.where(div == 0, 0.0, tbl / np.where(div == 0, 1.0, div)
                    ).astype(np.float32)


@functools.lru_cache(maxsize=8)
def ostro_lut(device) -> torch.Tensor:
    """The (256, 3) float32 weight table on ``device``, sent there once."""
    return convert.weight_table_to_torch(_ostro_weight_table(), device)


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown wavefront mode {mode!r}: one of {MODES}")


def _mode_entries(mode: str, variant: str):
    """The mode's entries (dx, dy, w); Ostromoukhov's weights are per pixel,
    so its entries carry 0."""
    _check_mode(mode)
    if mode == "fixed":
        return _fixed_entries(variant)
    if mode == "ostromoukhov":
        return [(dx, dy, np.float32(0.0)) for dx, dy in _OSTRO_OFFSETS]
    return _FS_ENTRIES


def _scan_params(mode: str, variant: str) -> Tuple[int, int]:
    """(s, n_slots) of a mode, as the JAX package's ``_scan_params``."""
    return _skew_params(_mode_entries(mode, variant))


def consume_order(offsets: Sequence[Tuple[int, int]]) -> list:
    """Entry indices in contributor-scan order: earlier source rows first
    (dy descending), then x ascending (dx descending). The golden engine
    accumulates into a pixel in this order, so the scan folds in it."""
    return sorted(range(len(offsets)),
                  key=lambda i: (-offsets[i][1], -offsets[i][0]))


@dataclass(frozen=True)
class ScanGeometry:
    """Everything the scan needs about one mode (and fixed variant).

    ``offsets`` (n, 2) int32 (dx, dy) and ``weights`` (n,) float32, the
    pre-divided weights bit for bit, both in consume order on the CPU:
    the one weight table that the plain scan and the CUDA kernel read
    (Ostromoukhov's are 0: its weights are ``ostro_lut[luminance,
    columns[k]]``). ``columns`` (n,) int32: each consume-ordered entry's
    position in the mode's own entry list. ``ring``: the power of two >=
    n_slots that the CUDA kernel's per-row error history uses.
    ``clamp_before``: clamp the working value to 0..255 before the search.
    ``lum_factor``, ``col_factor``: hybrid's projection factors."""

    mode: str
    s: int
    n_slots: int
    ring: int
    offsets: torch.Tensor
    weights: torch.Tensor
    columns: torch.Tensor
    clamp_before: bool
    lum_factor: float
    col_factor: float

    @property
    def needs_aux(self) -> bool:
        return self.mode in _AUX_MODES

    @property
    def hist_channels(self) -> int:
        """Floats per pixel of the CUDA kernel's error history: the error,
        and for perceptual and ostromoukhov the source pixel's sensitivity
        or luminance index beside it."""
        return 4 if self.mode in ("perceptual", "ostromoukhov") else 3


@functools.lru_cache(maxsize=32)
def scan_geometry(variant: str = "", mode: str = "fixed",
                  lum_factor: float = 1.0, col_factor: float = 0.2) -> ScanGeometry:
    entries = _mode_entries(mode, variant)
    s, n_slots = _skew_params(entries)
    order = consume_order([(dx, dy) for dx, dy, _ in entries])
    offsets, weights = convert.entries_to_torch([entries[i] for i in order], "cpu")
    return ScanGeometry(mode=mode, s=s, n_slots=n_slots,
                        ring=1 << (n_slots - 1).bit_length(),
                        offsets=offsets, weights=weights,
                        columns=torch.tensor(order, dtype=torch.int32),
                        clamp_before=mode in _CLAMP_MODES,
                        lum_factor=float(lum_factor), col_factor=float(col_factor))


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
# K6: skew of compact planes
# ---------------------------------------------------------------------------


def skew_planar_plain(planes: torch.Tensor, s: int) -> torch.Tensor:
    """Plain PyTorch K6: (R, H, W) -> (D, R, H), same dtype, ``out[d, r, y]
    = planes[r, y, d - s*y]`` (0 outside the image)."""
    r, h, w = planes.shape
    dev = planes.device
    out = torch.zeros((stream_length(h, w, s), r, h), dtype=planes.dtype, device=dev)
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    out[xx + s * yy, :, yy] = planes.permute(1, 2, 0)
    return out


def skew_planar(planes: torch.Tensor, s: int) -> torch.Tensor:
    """K6 on CUDA tensors, its plain version on CPU tensors. ``planes`` is
    (R, H, W) uint8 or float32, contiguous; a (3, B, H, W) batch viewed as
    (3B, H, W) gives the stream K1 gives for the same frames."""
    if not build.on_cuda(planes):
        return skew_planar_plain(planes, s)
    r, h, w = planes.shape
    out = torch.empty((stream_length(h, w, s), r, h), dtype=planes.dtype,
                      device=planes.device)
    build.extension().skew_planar(planes, out, s)
    build.LAUNCHES["skew_planar"] += 1
    return out


# ---------------------------------------------------------------------------
# K2 and K8: the scan
# ---------------------------------------------------------------------------


def _scan_core(stream: torch.Tensor, palette: torch.Tensor, geom: ScanGeometry,
               width: int, aux: Optional[torch.Tensor],
               emit_idx: bool) -> torch.Tensor:
    """The plain scan of K2 (packed colours) and K8 (``emit_idx``).

    Push form, as the TPU kernel: each step folds the per-entry error rings
    into the image value, clamps (fixed, ostromoukhov, hybrid), searches,
    transforms the error by the mode and pushes err * w into ring slot
    (d + dx + s*dy) mod n_slots at row y + dy. One eager op per arithmetic
    step, so each rounds on its own."""
    d_total, rows, h = stream.shape
    b = rows // 3
    dev = stream.device
    s, n_slots, mode = geom.s, geom.n_slots, geom.mode
    p = palette.shape[0]
    pal_t = palette.t().contiguous()  # (3, P)
    pal_c = pal_t[:, :, None, None]  # (3, P, 1, 1)
    p_iota = torch.arange(p, device=dev)[:, None, None]
    offsets = geom.offsets.tolist()
    weights = geom.weights.to(dev).unbind()
    columns = geom.columns.tolist()
    luma = torch.tensor(_LUMA, dtype=torch.float32, device=dev).unbind()
    lum_f = torch.tensor(geom.lum_factor, dtype=torch.float32, device=dev)
    col_f = torch.tensor(geom.col_factor, dtype=torch.float32, device=dev)
    aux_sk = skew_planar_plain(aux, s) if geom.needs_aux else None  # (D, B, H)
    lut = ostro_lut(dev) if mode == "ostromoukhov" else None
    ring = torch.zeros((len(offsets), n_slots, 3, b, h),
                       dtype=torch.float32, device=dev)
    out = torch.empty((d_total, b, h), dtype=torch.int32, device=dev)
    y = torch.arange(h, device=dev)
    for d in range(d_total):
        slot = d % n_slots
        cur = stream[d].view(3, b, h).to(torch.float32)
        for e in range(len(offsets)):  # entries are in consume order
            cur = cur + ring[e, slot]
        if geom.clamp_before:
            cur = cur.clamp(0.0, 255.0)
        diff = cur[:, None] - pal_c  # (3, P, B, H)
        sq = diff * diff
        d2 = (sq[0] + sq[1]) + sq[2]
        # The first minimum wins by construction: the least index among
        # the entries that equal the minimum.
        idx = torch.where(d2 == d2.amin(0), p_iota, p).amin(0)
        chosen = pal_t[:, idx]  # (3, B, H)
        x = d - s * y
        active = (x >= 0) & (x < width)
        if emit_idx:
            out[d] = torch.where(active, idx.to(torch.int32), 0)
        else:
            ci = chosen.to(torch.int32)  # truncates, as the kernel's cast
            out[d] = torch.where(active, (ci[0] << 16) | (ci[1] << 8) | ci[2], 0)
        err = (cur - chosen) * active
        if mode == "adaptive":
            err = err * aux_sk[d]  # the gate, 0 or 1
        elif mode == "hybrid":
            lum_err = (luma[0] * err[0] + luma[1] * err[1]) + luma[2] * err[2]
            err_lum = torch.stack([c * lum_err for c in luma])
            err = lum_f * err_lum + col_f * (err - err_lum)
        elif mode == "ostromoukhov":
            # Luminance of the clamped pixel, clamped and truncated.
            lum = (luma[0] * cur[0] + luma[1] * cur[1]) + luma[2] * cur[2]
            w_px = lut[lum.clamp(0.0, 255.0).to(torch.int64)]  # (B, H, 3)
        for e, (dx, dy) in enumerate(offsets):
            if mode == "ostromoukhov":
                contrib = err * w_px[..., columns[e]]
            elif mode == "perceptual":
                # The golden engine's order: err * (w_k * sens).
                contrib = err * (weights[e] * aux_sk[d])
            else:
                contrib = err * weights[e]
            if dy:
                contrib = torch.roll(contrib, dy, dims=2)
                contrib[..., :dy] = 0.0
            ring[e, (d + dx + s * dy) % n_slots] = contrib
    return out


def scan_plain(stream: torch.Tensor, palette: torch.Tensor, geom: ScanGeometry,
               width: int, aux: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch K2: (D, 3B, H) stream -> (D, B, H) int32 packed colours."""
    return _scan_core(stream, palette, geom, width, aux, emit_idx=False)


def scan_idx_plain(stream: torch.Tensor, palette: torch.Tensor,
                   geom: ScanGeometry, width: int,
                   aux: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch K8: (D, 3B, H) stream -> (D, B, H) int32 palette indices."""
    return _scan_core(stream, palette, geom, width, aux, emit_idx=True)


def _launch_scan(stream: torch.Tensor, palette: torch.Tensor, geom: ScanGeometry,
                 width: int, aux: Optional[torch.Tensor],
                 emit_idx: bool) -> torch.Tensor:
    """Launch the scan kernel: K8 with ``emit_idx``, else K2."""
    d_total, rows, h = stream.shape
    b = rows // 3
    dev = stream.device
    hist = torch.empty((b, geom.ring, geom.hist_channels, h),
                       dtype=torch.float32, device=dev)
    out = torch.empty((d_total, b, h), dtype=torch.int32, device=dev)
    none = torch.empty(0, dtype=torch.float32, device=dev)
    build.extension().ed_scan(
        stream, palette, aux if geom.needs_aux else none,
        ostro_lut(dev) if geom.mode == "ostromoukhov" else none, hist, out,
        geom.offsets, geom.weights, geom.columns, MODES.index(geom.mode),
        geom.s, width, geom.lum_factor, geom.col_factor, emit_idx)
    build.LAUNCHES["ed_scan_idx" if emit_idx else "ed_scan"] += 1
    return out


def _check_aux(geom: ScanGeometry, aux: Optional[torch.Tensor],
               stream: torch.Tensor, width: int) -> None:
    if not geom.needs_aux:
        if aux is not None:
            raise ValueError(f"mode {geom.mode!r} takes no aux map")
        return
    shape = (stream.shape[1] // 3, stream.shape[2], width)
    if (aux is None or tuple(aux.shape) != shape or aux.dtype != torch.float32
            or aux.device != stream.device or not aux.is_contiguous()):
        raise ValueError(
            f"mode {geom.mode!r} needs a contiguous float32 aux map {shape} on "
            f"{stream.device}")


def scan(stream: torch.Tensor, palette: torch.Tensor, geom: ScanGeometry,
         width: int, aux: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2 on CUDA tensors, its plain version on CPU tensors. ``palette`` is
    (P, 3) float32 on the stream's device, P <= PACKED_PALETTE_MAX; ``aux``
    the (B, H, W) float32 map of perceptual and adaptive."""
    if palette.shape[0] > PACKED_PALETTE_MAX:
        raise ValueError(
            f"the packed-colour scan serves up to {PACKED_PALETTE_MAX} colours, "
            f"got {palette.shape[0]}: use scan_idx")
    _check_aux(geom, aux, stream, width)
    if not build.on_cuda(stream):
        return scan_plain(stream, palette, geom, width, aux)
    return _launch_scan(stream, palette, geom, width, aux, emit_idx=False)


def scan_idx(stream: torch.Tensor, palette: torch.Tensor, geom: ScanGeometry,
             width: int, aux: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K8 on CUDA tensors, its plain version on CPU tensors: the scan for
    palettes of up to INDEX_PALETTE_MAX colours, emitting palette indices."""
    if palette.shape[0] > INDEX_PALETTE_MAX:
        raise ValueError(
            f"the index scan serves up to {INDEX_PALETTE_MAX} colours, got "
            f"{palette.shape[0]}")
    _check_aux(geom, aux, stream, width)
    if not build.on_cuda(stream):
        return scan_idx_plain(stream, palette, geom, width, aux)
    return _launch_scan(stream, palette, geom, width, aux, emit_idx=True)


# ---------------------------------------------------------------------------
# K3: unskew + unpack
# ---------------------------------------------------------------------------

_SHIFTS = (16, 8, 0)


def _unskew_plain(stream: torch.Tensor, s: int, h: int, w: int) -> torch.Tensor:
    """(D, B, H) -> (B, H, W): ``out[b, y, x] = stream[x + s*y, b, y]``."""
    dev = stream.device
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    return stream[xx + s * yy, :, yy].permute(2, 0, 1)


def unskew_unpack_plain(col: torch.Tensor, s: int, h: int, w: int,
                        planar_out: bool = False) -> torch.Tensor:
    """Plain PyTorch K3: (D, B, H) int32 -> (B, H, W, 3) uint8, or the
    planes (3, B, H, W) with ``planar_out``."""
    v = _unskew_plain(col, s, h, w)
    shifts = torch.tensor(_SHIFTS, dtype=torch.int32, device=col.device)
    if planar_out:
        return ((v[None] >> shifts[:, None, None, None]) & 255).to(torch.uint8)
    return ((v[..., None] >> shifts) & 255).to(torch.uint8)


def unskew_unpack(col: torch.Tensor, s: int, h: int, w: int,
                  planar_out: bool = False) -> torch.Tensor:
    """K3 on CUDA tensors, its plain version on CPU tensors."""
    if not build.on_cuda(col):
        return unskew_unpack_plain(col, s, h, w, planar_out)
    b = col.shape[1]
    out = torch.empty((3, b, h, w) if planar_out else (b, h, w, 3),
                      dtype=torch.uint8, device=col.device)
    build.extension().unskew_unpack(col, out, s, planar_out)
    build.LAUNCHES["unskew_unpack"] += 1
    return out


# ---------------------------------------------------------------------------
# K5: unskew of the index stream
# ---------------------------------------------------------------------------


def index_dtype(p: int) -> torch.dtype:
    """The index stream's type for a P-colour palette: one byte a pixel up
    to 256 colours, two above."""
    return torch.uint8 if p <= 256 else torch.uint16


def unskew_idx_plain(idx: torch.Tensor, s: int, h: int, w: int,
                     dtype: torch.dtype = torch.uint8) -> torch.Tensor:
    """Plain PyTorch K5: (D, B, H) int32 indices -> (B, H, W) ``dtype``
    (uint8 or uint16; the indices must fit it)."""
    return _unskew_plain(idx, s, h, w).to(dtype).contiguous()


def unskew_idx(idx: torch.Tensor, s: int, h: int, w: int,
               dtype: torch.dtype = torch.uint8) -> torch.Tensor:
    """K5 on CUDA tensors, its plain version on CPU tensors."""
    if dtype not in (torch.uint8, torch.uint16):
        raise TypeError(f"the index stream is uint8 or uint16, got {dtype}")
    if not build.on_cuda(idx):
        return unskew_idx_plain(idx, s, h, w, dtype)
    out = torch.empty((idx.shape[1], h, w), dtype=dtype, device=idx.device)
    build.extension().unskew_idx(idx, out, s)
    build.LAUNCHES["unskew_idx"] += 1
    return out


# ---------------------------------------------------------------------------
# K9: unskew + palette select
# ---------------------------------------------------------------------------


def unskew_select_plain(idx: torch.Tensor, palette: torch.Tensor, s: int,
                        h: int, w: int) -> torch.Tensor:
    """Plain PyTorch K9: (D, B, H) int32 indices + (P, 3) float32 palette ->
    (B, H, W, 3) uint8; the palette's float32 -> int32 cast truncates."""
    v = _unskew_plain(idx, s, h, w)
    return palette.to(torch.int32)[v.to(torch.int64)].to(torch.uint8)


def unskew_select(idx: torch.Tensor, palette: torch.Tensor, s: int, h: int,
                  w: int) -> torch.Tensor:
    """K9 on CUDA tensors, its plain version on CPU tensors."""
    if not build.on_cuda(idx):
        return unskew_select_plain(idx, palette, s, h, w)
    out = torch.empty((idx.shape[1], h, w, 3), dtype=torch.uint8,
                      device=idx.device)
    build.extension().unskew_select(idx, palette, out, s)
    build.LAUNCHES["unskew_select"] += 1
    return out


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def perceptual_sensitivity(images: torch.Tensor, planar: bool = False) -> torch.Tensor:
    """(..., 3) uint8 or float32 frames, or with ``planar`` the planes
    (3, ...), -> (...) float32 sensitivity map
    ``0.5 + 0.5 * (gray / 255)`` with ``gray = (0.299 r + 0.587 g) + 0.114
    b``, on the frames' device. One eager float32 op per numpy op of the JAX
    package's map and every constant a tensor on the device (a division by
    a host scalar may run as a multiplication by its reciprocal), so each
    step rounds on its own and the result equals numpy's bit for bit."""
    dev = images.device
    c0, c1, c2, full, half = torch.tensor(
        _LUMA + (255.0, 0.5), dtype=torch.float32, device=dev).unbind()
    r, g, b = (ch.to(torch.float32) for ch in images.unbind(0 if planar else -1))
    gray = (c0 * r + c1 * g) + c2 * b
    return half + half * (gray / full)


def _run(mode: str, images: torch.Tensor, palette: torch.Tensor,
         variant: str = "", aux: Optional[torch.Tensor] = None,
         lum_factor: float = 1.0, col_factor: float = 0.2,
         planar: bool = False, return_indices: bool = False) -> torch.Tensor:
    """(B, H, W, 3) uint8 or float32 frames + (P, 3) float32 palette on the
    same device -> (B, H, W, 3) uint8 palette colours. Any B, P from 1 to
    INDEX_PALETTE_MAX: up to PACKED_PALETTE_MAX colours through K1 -> K2 ->
    K3, more through K1 -> K8 -> K9.

    ``planar``: the frames are (3, B, H, W) channel-major planes and so is
    the output (K6 -> K2 -> K3's planar layout). ``return_indices``: the
    result is the (B, H, W) index stream, uint8 up to 256 colours and
    uint16 above (skew -> K8 -> K5), whatever the frames' layout. Both
    serve up to PACKED_PALETTE_MAX colours, as the JAX package does."""
    if palette.dtype != torch.float32 or palette.dim() != 2 or palette.shape[1] != 3:
        raise ValueError("palette must be a (P, 3) float32 tensor")
    p = palette.shape[0]
    if return_indices and p > PACKED_PALETTE_MAX:
        raise ValueError("return_indices requires a palette <= "
                         f"{PACKED_PALETTE_MAX} colors (the packed kernel)")
    if planar and p > PACKED_PALETTE_MAX:
        raise ValueError(
            "planar layout requires a palette <= "
            f"{PACKED_PALETTE_MAX} colors (the packed kernel path)")
    if images.dim() != 4 or images.shape[0 if planar else -1] != 3:
        raise ValueError(
            f"images must be {'(3, B, H, W)' if planar else '(B, H, W, 3)'}, "
            f"got {tuple(images.shape)}")
    if images.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"images must be uint8 or float32, got {images.dtype}")
    if palette.device != images.device:
        raise ValueError(f"palette on {palette.device}, images on {images.device}")
    geom = scan_geometry(variant if mode == "fixed" else "", mode,
                         float(lum_factor), float(col_factor))
    if planar:
        # (3, B, H, W) -> (3B, H, W) is a free view: the planar layout is
        # the stream's row order c*B + b.
        _, b, h, w = images.shape
        stream = skew_planar(images.contiguous().view(3 * b, h, w), geom.s)
    else:
        _, h, w, _ = images.shape
        stream = skew(images.contiguous(), geom.s)
    palette = palette.contiguous()
    if aux is not None:
        aux = aux.contiguous()
    if return_indices:
        idx = scan_idx(stream, palette, geom, w, aux)
        return unskew_idx(idx, geom.s, h, w, index_dtype(p))
    if p <= PACKED_PALETTE_MAX:
        col = scan(stream, palette, geom, w, aux)
        return unskew_unpack(col, geom.s, h, w, planar_out=planar)
    idx = scan_idx(stream, palette, geom, w, aux)
    return unskew_select(idx, palette, geom.s, h, w)


def _check_slice(mode: str, dense_search: Optional[str]) -> None:
    """Raise for the option not ported yet, naming the ROADMAP item."""
    _check_mode(mode)
    if dense_search not in (None, "exact"):
        raise NotImplementedError(
            f"dense_search={dense_search!r}: the matrix-unit dense search is "
            "not ported yet (ROADMAP A5)")


def ed_batch_wavefront(images: torch.Tensor, palette: torch.Tensor,
                       mode: str = "fixed", variant: str = "floyd_steinberg",
                       aux: Optional[torch.Tensor] = None,
                       lum_factor: float = 1.0, col_factor: float = 0.2,
                       planar: bool = False, return_indices: bool = False,
                       dense_search: Optional[str] = None) -> torch.Tensor:
    """Batched entry of the video path: (B, H, W, 3) frames in one scan,
    or with ``planar`` (3, B, H, W) planes in and out; with
    ``return_indices`` the (B, H, W) index stream comes back instead of
    colours. ``aux``: adaptive's (B, H, W) float32 gates; perceptual's
    sensitivity map is built here from the frames."""
    _check_slice(mode, dense_search)
    if mode == "perceptual":
        aux = perceptual_sensitivity(images, planar)
    return _run(mode, images, palette, variant, aux, lum_factor, col_factor,
                planar, return_indices)


def wavefront_device_fn(mode: str, variant: str, h: int, w: int, p: int,
                        batch: int, lum_factor: float = 1.0,
                        col_factor: float = 0.2, planar: bool = False,
                        dense_search: str = "exact") -> Callable:
    """``fn(frames (batch, h, w, 3), palette (p, 3) f32, aux=None) ->
    (batch, h, w, 3) uint8``: the shape-checked device function of one
    configuration, as the JAX package's benchmark builds it (``aux``: the
    (batch, h, w) float32 map of perceptual and adaptive); with ``planar``
    the frames and the result are (3, batch, h, w) planes. Raises at
    construction for what is not ported and for a planar configuration
    above PACKED_PALETTE_MAX colours."""
    _check_slice(mode, dense_search)
    if planar and p > PACKED_PALETTE_MAX:
        raise ValueError(
            "planar layout requires a palette <= "
            f"{PACKED_PALETTE_MAX} colors (the packed kernel path)")
    shape = (3, batch, h, w) if planar else (batch, h, w, 3)

    def fn(frames: torch.Tensor, palette: torch.Tensor,
           aux: Optional[torch.Tensor] = None) -> torch.Tensor:
        if tuple(frames.shape) != shape or tuple(palette.shape) != (p, 3):
            raise ValueError(
                f"expected frames {shape} and palette ({p}, 3), got "
                f"{tuple(frames.shape)} and {tuple(palette.shape)}")
        return _run(mode, frames, palette, variant, aux, lum_factor, col_factor,
                    planar)

    return fn

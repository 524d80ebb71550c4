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
  (rows c*B + b) give K1's stream bit for bit. K1 and K6 are one tile
  transpose, over C = 3 channels or one (``skew_tile_plan``).
* K2 ``scan``: the wavefront scan -> (D, B, H) int32 packed colours
  ``r << 16 | g << 8 | b`` (0 outside the image), palettes of up to
  ``PACKED_PALETTE_MAX`` colours. One frame runs on a thread-block cluster
  of n blocks whose ranks search contiguous slices of the palette
  (``scan_cluster_plan``, ``scan_smem_plan``).
* K3 ``unskew_unpack``: (D, B, H) packed colours -> (B, H, W, 3) uint8, or
  the planes (3, B, H, W) with ``planar_out``.
* K8 ``scan_idx``: the same scan for palettes of up to
  ``INDEX_PALETTE_MAX`` colours -> (D, B, H) int32 palette indices (0
  outside the image). It is also K2's ``emit_idx`` stream of the JAX
  package: the same body with the index as its output.
* K5 ``unskew_idx``: (D, B, H) indices -> the (B, H, W) index stream, uint8
  for palettes of up to 256 colours, uint16 above. K3 and K5 are one tile
  transpose, by output kind (``unskew_tile_plan``).
* K9 ``unskew_select``: (D, B, H) indices + palette -> (B, H, W, 3) uint8:
  the "select" kind of the same tile transpose, K3's NHWC kind with a
  lookup in the packed palette at the load.
* K7 ``skew_transpose``: the same stream as K1 and K6, uint8 -> uint8,
  float32 -> float32 or uint8 -> float32; on the card it is K1's and K6's
  tile kernel in those type pairs (``skew`` and ``skew_planar`` take
  frames and planes of either dtype themselves; no path calls K7).

Palettes of up to 1024 colours run K1 -> K2 -> K3, larger ones K1 -> K8 ->
K9. ``planar`` batches (3, B, H, W), the layout of the video pipeline's
zero-copy flow, run K6 -> K2 -> K3 and stay planar; ``return_indices``
(either layout) runs the skew -> K8 -> K5 and returns the index stream,
whose ``palette.astype(uint8)[idx]`` is the colour output exactly. Both
stop at ``PACKED_PALETTE_MAX`` colours, as in the JAX package.

``dense_search="mxu"`` replaces the scan's exact palette search by the
score search for palettes of 65 to ``PACKED_PALETTE_MAX`` colours (K2's and
K8's score branch): the first maximum of ``c . x - |c|^2 / 2`` instead of
the first minimum of ``|x - c|^2``. The two agree except on near ties, so
the score search is outside the bit contract with the golden engine;
``"auto"`` runs both on the first batch and keeps the score search only if
the outputs match perceptually.

The modes are "fixed" (8 variants), "ostromoukhov" (per-pixel weights
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

import contextlib
import functools
import math
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dither_pie_tpu_torch import convert
from dither_pie_tpu_torch.core import fidelity
from dither_pie_tpu_torch.kernels import build
from dither_pie_tpu_torch.ops.ed_kernels import OSTROMOUKHOV_ARRAY, get_kernel

# Largest palette of the packed-colour scan K2 (its shared-memory palette);
# larger palettes run the index scan K8 and its epilogue K9.
PACKED_PALETTE_MAX = 1024
# Largest palette of the index scan K8: 192 KB of shared memory. The golden
# engine stops at 4096 colours.
INDEX_PALETTE_MAX = 16384

# The palette searches of the scan: the exact sweep, and the score search
# that ``"mxu"`` asks for above SCORE_PALETTE_MIN colours.
DENSE_SEARCHES = ("exact", "mxu")
SCORE_PALETTE_MIN = 64

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
    """The (256, 3) float32 weight table on ``device``, sent there once.
    The copy is waited for: the cached table is read on other threads'
    streams too (the video pipeline's overlap workers)."""
    lut = convert.weight_table_to_torch(_ostro_weight_table(), device)
    if lut.device.type == "cuda":
        torch.cuda.current_stream(lut.device).synchronize()
    return lut


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


def _launch_skew(x: torch.Tensor, s: int, out_dtype: torch.dtype) -> torch.Tensor:
    """The tile kernel of ``skew.cu`` on CUDA frames (B, H, W, 3) or planes
    (R, H, W) into a fresh (D, 3B or R, H) stream of ``out_dtype``, with
    the plan of that output type (``skew_tile_plan``); counts nothing."""
    channels = 3 if x.dim() == 4 else 1
    b, h, w = x.shape[:3]
    out = torch.empty((stream_length(h, w, s), channels * b, h), dtype=out_dtype,
                      device=x.device)
    plan = skew_tile_plan(b, h, w, s, out_dtype, out.data_ptr() % SECTOR_BYTES, channels)
    build.extension().skew(x, out, s, plan.td, plan.ty, plan.lead, plan.threads,
                           list(plan.grid), plan.smem_bytes)
    return out


def skew_gather(images: torch.Tensor, s: int) -> torch.Tensor:
    """K1 itself on CUDA frames of either dtype: a shared-memory tile
    transpose (``skew_tile_plan``)."""
    out = _launch_skew(images, s, images.dtype)
    build.count_launch("skew")
    return out


def skew(images: torch.Tensor, s: int) -> torch.Tensor:
    """The frames' stream: K1 on CUDA frames (uint8 or float32), its plain
    version on CPU tensors."""
    if not build.on_cuda(images):
        return skew_plain(images, s)
    return skew_gather(images, s)


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


def skew_planar_gather(planes: torch.Tensor, s: int) -> torch.Tensor:
    """K6 itself on CUDA planes of either dtype: K1's tile transpose with
    one channel (``skew_tile_plan(..., channels=1)``)."""
    out = _launch_skew(planes, s, planes.dtype)
    build.count_launch("skew_planar")
    return out


def skew_planar(planes: torch.Tensor, s: int) -> torch.Tensor:
    """The planes' stream: K6 on CUDA planes (uint8 or float32), its plain
    version on CPU tensors. ``planes`` is (R, H, W), contiguous; a (3, B,
    H, W) batch viewed as (3B, H, W) gives the stream K1 gives for the same
    frames."""
    if not build.on_cuda(planes):
        return skew_planar_plain(planes, s)
    return skew_planar_gather(planes, s)


# ---------------------------------------------------------------------------
# K7: the transposing skew, as the type pairs of K1's and K6's tile kernel
# ---------------------------------------------------------------------------


def _as_planes(frames: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) frames as (3B, H, W) planes in the stream's row order
    c*B + b (a copy); (R, H, W) planes as they are."""
    if frames.dim() == 4:
        b, h, w, _ = frames.shape
        return frames.permute(3, 0, 1, 2).reshape(3 * b, h, w)
    return frames


def skew_transpose_plain(frames: torch.Tensor, s: int,
                         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch K7: (B, H, W, 3) frames or (R, H, W) planes -> the
    (D, 3B or R, H) stream, cast to ``out_dtype``.

    The stride lemma in its padded form: pad every plane's rows with zeros
    to D + s elements and read the flat buffer again with rows of D
    elements; row y then starts s*y elements late, ``view[r, y, d] =
    plane[r, y, d - s*y]``, and every position outside the image falls on
    padding (D + s - s*(H-1) >= W). The transpose ``permute(2, 0, 1)`` puts
    the wavefront axis first. Any width is served, W <= s too."""
    planes = _as_planes(frames)
    r, h, w = planes.shape
    d = stream_length(h, w, s)
    padded = torch.nn.functional.pad(planes, (0, d + s - w))  # (R, H, D + s)
    view = padded.reshape(r, h * (d + s))[:, : h * d].reshape(r, h, d)
    out = view.permute(2, 0, 1).contiguous()
    return out if out_dtype is None else out.to(out_dtype)


def skew_transpose(frames: torch.Tensor, s: int,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K7 on CUDA tensors, its plain version on CPU tensors: (B, H, W, 3)
    frames or (R, H, W) planes, uint8 or float32 -> the (D, 3B or R, H)
    stream that K1 and K6 give, bit for bit, as ``out_dtype`` (the input's
    dtype, or float32 from uint8). On the card it launches ``skew.cu``'s
    tile kernel (C = 3 or 1) in that type pair on the frames as they lie;
    any width is served."""
    if frames.dim() not in (3, 4) or (frames.dim() == 4 and frames.shape[3] != 3):
        raise ValueError("frames must be (B, H, W, 3) or planes (R, H, W), got "
                         f"{tuple(frames.shape)}")
    out_dtype = frames.dtype if out_dtype is None else out_dtype
    if (frames.dtype, out_dtype) not in (
            (torch.uint8, torch.uint8), (torch.float32, torch.float32),
            (torch.uint8, torch.float32)):
        raise TypeError(f"skew_transpose serves uint8 -> uint8, float32 -> float32 "
                        f"and uint8 -> float32, got {frames.dtype} -> {out_dtype}")
    if not build.on_cuda(frames):
        return skew_transpose_plain(frames, s, out_dtype)
    out = _launch_skew(frames.contiguous(), s, out_dtype)
    build.count_launch("skew_transpose")
    return out


# ---------------------------------------------------------------------------
# K2 and K8: the scan
# ---------------------------------------------------------------------------


def score_search(dense_search: str, p: int) -> bool:
    """Whether a P-colour scan takes the score search: ``"mxu"`` and 64 < P
    <= PACKED_PALETTE_MAX. Smaller palettes and the index scan's larger
    ones run the exact search whatever is asked, as in the JAX package
    (whose further condition, a power-of-two padded size, is TPU tiling:
    this port pads no palette, so any size in the range qualifies)."""
    if dense_search not in DENSE_SEARCHES:
        raise ValueError(f"dense_search must be one of {DENSE_SEARCHES}, got "
                         f"{dense_search!r}")
    return dense_search == "mxu" and SCORE_PALETTE_MIN < p <= PACKED_PALETTE_MAX


def _scan_core(stream: torch.Tensor, palette: torch.Tensor, geom: ScanGeometry,
               width: int, aux: Optional[torch.Tensor], emit_idx: bool,
               dense_search: str = "exact") -> torch.Tensor:
    """The plain scan of K2 (packed colours) and K8 (``emit_idx``).

    Push form, as the TPU kernel: each step folds the per-entry error rings
    into the image value, clamps (fixed, ostromoukhov, hybrid), searches,
    transforms the error by the mode and pushes err * w into ring slot
    (d + dx + s*dy) mod n_slots at row y + dy. One eager op per arithmetic
    step, so each rounds on its own.

    The search is the exact one, the first minimum of ``(dr*dr + dg*dg) +
    db*db``, or where ``score_search`` says so the score search: the first
    strict maximum over p of ``((r_p*x_r + g_p*x_g) + b_p*x_b) + n_p`` with
    the augmented palette of ``convert.augment_palette``, each product and
    sum an eager float32 op of its own (no ``matmul``), which fixes the
    order the CUDA kernel follows."""
    d_total, rows, h = stream.shape
    b = rows // 3
    dev = stream.device
    s, n_slots, mode = geom.s, geom.n_slots, geom.mode
    p = palette.shape[0]
    pal_t = palette.t().contiguous()  # (3, P)
    pal_c = pal_t[:, :, None, None]  # (3, P, 1, 1)
    p_iota = torch.arange(p, device=dev)[:, None, None]
    score = score_search(dense_search, p)
    if score:
        aug = convert.augment_palette(palette)
        norm_c = aug[:, 3, None, None]  # (P, 1, 1)
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
        # The first extremum wins by construction: the least index among
        # the entries that equal it.
        if score:
            prod = pal_c * cur[:, None]  # (3, P, B, H)
            sc = ((prod[0] + prod[1]) + prod[2]) + norm_c
            idx = torch.where(sc == sc.amax(0), p_iota, p).amin(0)
        else:
            diff = cur[:, None] - pal_c  # (3, P, B, H)
            sq = diff * diff
            d2 = (sq[0] + sq[1]) + sq[2]
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
               width: int, aux: Optional[torch.Tensor] = None,
               dense_search: str = "exact") -> torch.Tensor:
    """Plain PyTorch K2: (D, 3B, H) stream -> (D, B, H) int32 packed colours."""
    return _scan_core(stream, palette, geom, width, aux, False, dense_search)


def scan_idx_plain(stream: torch.Tensor, palette: torch.Tensor,
                   geom: ScanGeometry, width: int,
                   aux: Optional[torch.Tensor] = None,
                   dense_search: str = "exact") -> torch.Tensor:
    """Plain PyTorch K8: (D, 3B, H) stream -> (D, B, H) int32 palette indices."""
    return _scan_core(stream, palette, geom, width, aux, True, dense_search)


# ---------------------------------------------------------------------------
# K2 and K8 over a thread-block cluster
# ---------------------------------------------------------------------------

# Blocks a frame of the scan: the cluster sizes the kernel takes.
CLUSTER_SIZES = (1, 2, 4, 8)
# Dynamic shared memory a block may have on the H100 (232,448 bytes).
SMEM_BYTES_MAX = 227 * 1024
# The cluster size by palette size, (least P, n) in ascending P: a fixed
# table, set from the sweep of n in {1, 2, 4, 8} at P in {32, 64, 256,
# 1024, 2048} on an H100 (dither_pie_tpu_torch/tools/time_ed_path.py
# --sweep, PERF.md). A step costs about c_n + k * P / n, k = 0.035 us and
# c_1 = 1.6, c_2 = 2.7, c_4 = 2.9, c_8 = 3.5 us: the crossovers lie near
# 45-56 colours (1 -> 4) and 128-143 (4 -> 8), and every measured P takes
# its fastest n. n = 2 is never the least; the plan takes it where four or
# eight are not all resident.
_CLUSTER_TABLE = ((1, 1), (56, 4), (128, 8))


def cluster_size_for(p: int) -> int:
    """The table's cluster size for a P-colour palette, before the limits
    of ``scan_cluster_plan``."""
    n = 1
    for least_p, size in _CLUSTER_TABLE:
        if p >= least_p:
            n = size
    return n


def palette_slices(p: int, n: int) -> Tuple[int, ...]:
    """The n + 1 bounds of the contiguous palette slices, in rank order:
    rank r searches colours [bounds[r], bounds[r+1]). Slices differ in
    length by at most one colour and none is empty while n <= p."""
    if not 1 <= n <= p:
        raise ValueError(f"cannot split {p} colours into {n} slices")
    return tuple(r * p // n for r in range(n + 1))


def scan_smem_bytes(geom: ScanGeometry, h: int, p: int, n: int, score: bool,
                    hist_smem: bool) -> int:
    """Bytes of dynamic shared memory of one block of the scan, the sum the
    kernel's ``smem_layout`` makes, in floats, each part rounded up to 4:
    the ostromoukhov weight table (768); the block's palette slice, packed
    (3 floats a colour, 4 with the score search: (r, g, b, n)) for the
    longest of the ``palette_slices``; with n > 1 and P <=
    PACKED_PALETTE_MAX the whole palette's colours (3 floats a colour); the
    error history (ring * C * H, where ``hist_smem``); with n > 1 the rows'
    stage (4 floats a row) and the candidates (2 buffers of 2 floats a
    row)."""
    def round4(v):
        return (v + 3) // 4 * 4
    longest = int(max(np.diff(palette_slices(p, n))))
    floats = 256 * 3 if geom.mode == "ostromoukhov" else 0
    floats += round4((4 if score else 3) * longest)
    if n > 1 and p <= PACKED_PALETTE_MAX:
        floats += round4(3 * p)
    if hist_smem:
        floats += round4(geom.ring * geom.hist_channels * h)
    if n > 1:
        floats += 8 * h
    return 4 * floats


def scan_smem_plan(geom: ScanGeometry, h: int, p: int, n: int,
                   score: bool = False) -> Optional[Tuple[int, bool]]:
    """(bytes, hist_smem): the block's shared memory with the error history
    in it where that fits SMEM_BYTES_MAX, else without it (the history then
    lives in device memory). None where even that does not fit."""
    for hist_smem in (True, False):
        nbytes = scan_smem_bytes(geom, h, p, n, score, hist_smem)
        if nbytes <= SMEM_BYTES_MAX:
            return nbytes, hist_smem
    return None


@dataclass(frozen=True)
class ClusterPlan:
    """One launch of the scan: ``n`` blocks a frame, the palette slices'
    ``bounds`` (n + 1 ints from 0 to P), the block's ``smem_bytes`` and
    whether the history lives in shared memory (``hist_smem``)."""

    n: int
    bounds: Tuple[int, ...]
    smem_bytes: int
    hist_smem: bool


def scan_cluster_plan(b: int, h: int, p: int, geom: ScanGeometry,
                      score: bool = False,
                      capacity: Optional[Callable[[ClusterPlan], int]] = None,
                      n: Optional[int] = None) -> ClusterPlan:
    """The scan's launch for B frames of H rows and a P-colour palette.

    n starts at the table's size for P (``cluster_size_for``), or at ``n``
    where a measurement asks for one size, and halves until n <= P, the
    block's shared memory fits (``scan_smem_plan``) and all B clusters are
    resident at once: B <= ``capacity(plan)``, the card's count of clusters
    of that launch (cudaOccupancyMaxActiveClusters; None: no limit), since
    a second wave of clusters would double the time. A forced ``n`` skips
    the residency rule, and so does n = 1, which always fits: its block
    holds the palette (at most 192 KB at INDEX_PALETTE_MAX colours) and the
    weight table, the history going to device memory where it must."""
    start = cluster_size_for(p) if n is None else n
    if start not in CLUSTER_SIZES:
        raise ValueError(f"cluster size {start} not one of {CLUSTER_SIZES}")
    for size in CLUSTER_SIZES[::-1]:
        smem = scan_smem_plan(geom, h, p, size, score) if size <= min(start, p) else None
        if smem is None:
            continue
        plan = ClusterPlan(size, palette_slices(p, size), *smem)
        if size == 1 or n is not None or capacity is None or b <= capacity(plan):
            return plan
    raise ValueError(f"a {p}-colour scan of {h} rows does not fit {SMEM_BYTES_MAX} bytes "
                     "of shared memory")


@functools.lru_cache(maxsize=256)
def _cluster_capacity(device: int, img_f32: bool, mode: str, emit_idx: bool,
                      score: bool, p: int, h: int, ring: int,
                      plan: ClusterPlan) -> int:
    """Clusters of ``plan.n`` blocks that the card holds at once for this
    launch, asked of the CUDA runtime once per configuration."""
    with torch.cuda.device(device):
        return build.extension().ed_scan_capacity(
            img_f32, MODES.index(mode), emit_idx, score, p, h, plan.n,
            list(plan.bounds), ring, plan.hist_smem, plan.smem_bytes)


def _capacity_of(stream: torch.Tensor, palette: torch.Tensor, geom: ScanGeometry,
                 emit_idx: bool, dense_search: str) -> Callable[[ClusterPlan], int]:
    """``capacity`` of ``scan_cluster_plan`` for the launch on this stream."""
    dev = stream.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    p = palette.shape[0]
    key = (index, stream.dtype == torch.float32, geom.mode, emit_idx,
           score_search(dense_search, p), p, stream.shape[2], geom.ring)
    return lambda plan: _cluster_capacity(*key, plan)


def launch_plan(stream: torch.Tensor, palette: torch.Tensor, geom: ScanGeometry,
                emit_idx: bool = False, dense_search: str = "exact",
                n: Optional[int] = None) -> ClusterPlan:
    """The cluster plan of the scan launch on this CUDA stream and palette
    (``scan_cluster_plan`` with the card's residency count)."""
    _, rows, h = stream.shape
    p = palette.shape[0]
    return scan_cluster_plan(rows // 3, h, p, geom, score_search(dense_search, p),
                             _capacity_of(stream, palette, geom, emit_idx, dense_search), n)


def launch_capacity(stream: torch.Tensor, palette: torch.Tensor, geom: ScanGeometry,
                    n: int, emit_idx: bool = False, dense_search: str = "exact") -> int:
    """Clusters of ``n`` blocks of this scan launch that the card holds at
    once (the number ``launch_plan`` holds the batch to)."""
    return _capacity_of(stream, palette, geom, emit_idx, dense_search)(
        launch_plan(stream, palette, geom, emit_idx, dense_search, n))


class ScanTurns:
    """The order of the scan launches that several CUDA streams enqueue on
    one card.

    ``launch_plan`` sizes a launch so that all its clusters are resident at
    once, a rule of one launch. Launches enqueued on two streams may run
    at the same time and together ask for more clusters than the card
    holds: two batches of 16 1080p frames at 256 colours ask for 2 x 16
    clusters of 4, and an H100 holds 30. The clusters that find no room
    wait for the other launch's to finish, so the later launch's frames
    come no sooner than if it had waited whole, and its span on the card
    covers the other's. ``turn`` has it wait whole, on the device, for
    the last launch enqueued on another stream. Launches that fit
    together still overlap, and no host thread waits."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # Card index -> (stream, event after its launch, its clusters).
        self._last: Dict[int, Tuple[torch.cuda.Stream, torch.cuda.Event, int]] = {}

    @contextlib.contextmanager
    def turn(self, device: torch.device, clusters: int, capacity: int):
        """Enqueue the launch made inside the block after the last scan
        launch of another stream of ``device`` where the two launches'
        ``clusters`` exceed ``capacity``, the card's count of resident
        clusters; then record it as the last. A launch captured into a CUDA
        graph takes no turn."""
        if torch.cuda.is_current_stream_capturing():
            yield
            return
        stream = torch.cuda.current_stream(device)
        with self._lock:
            last = self._last.get(device.index)
            if last is not None and last[0] != stream and last[2] + clusters > capacity:
                stream.wait_event(last[1])
            yield
            done = torch.cuda.Event()
            done.record(stream)
            self._last[device.index] = (stream, done, clusters)


scan_turns = ScanTurns()


def launch_scan(stream: torch.Tensor, palette: torch.Tensor, geom: ScanGeometry,
                width: int, aux: Optional[torch.Tensor], emit_idx: bool,
                dense_search: str, n: Optional[int] = None) -> torch.Tensor:
    """Launch the scan kernel: K8 with ``emit_idx``, else K2; with the
    augmented palette where the score search runs; one frame over a
    cluster of ``launch_plan``'s size (``n`` forces one, for the
    measurements and checks that compare sizes), in its turn among the
    card's streams (``scan_turns``)."""
    d_total, rows, h = stream.shape
    b = rows // 3
    dev = stream.device
    score = score_search(dense_search, palette.shape[0])
    plan = launch_plan(stream, palette, geom, emit_idx, dense_search, n)
    capacity = _capacity_of(stream, palette, geom, emit_idx, dense_search)(plan)
    none = torch.empty(0, dtype=torch.float32, device=dev)
    hist = none if plan.hist_smem else torch.empty(
        (b * plan.n, geom.ring, geom.hist_channels, h), dtype=torch.float32, device=dev)
    out = torch.empty((d_total, b, h), dtype=torch.int32, device=dev)
    with scan_turns.turn(dev, b, capacity):
        build.extension().ed_scan(
            stream, palette, convert.augment_palette(palette) if score else none,
            aux if geom.needs_aux else none,
            ostro_lut(dev) if geom.mode == "ostromoukhov" else none, hist, out,
            geom.offsets, geom.weights, geom.columns, MODES.index(geom.mode),
            geom.s, width, geom.lum_factor, geom.col_factor, emit_idx, plan.n,
            list(plan.bounds), geom.ring, plan.hist_smem, plan.smem_bytes)
    build.count_launch("ed_scan_idx" if emit_idx else "ed_scan")
    return out


# ---------------------------------------------------------------------------
# K1 and K3: tile plans
# ---------------------------------------------------------------------------

# Tiles (TD steps d, TY rows y) of the (D, H) stream plane that one block of
# K1 (3 channels) or K6 (1 channel) moves, by frame dtype and channel count,
# and of K3 and K5; 256 threads a block. Set by timing variants on an H100
# (PERF.md, PR 8 and 9): K6's tiles hold at least K1's C*TD stream rows.
SKEW_TILES = {(torch.uint8, 3): (64, 128), (torch.float32, 3): (64, 32),
              (torch.uint8, 1): (256, 128), (torch.float32, 1): (192, 32)}
UNSKEW_TILE = (128, 32)
# The output kinds of the unskew tile kernel and their bytes a pixel of an
# output row: K3's NHWC colours and planar planes (a row in each of three),
# K5's uint8 and uint16 index streams, K9's NHWC colours of palette indices
# (the packed palette's lookup, then K3's NHWC store). The order is the
# kernel's.
UNSKEW_KINDS = ("nhwc", "planar", "u8", "u16", "select")
_UNSKEW_BYTES = {"nhwc": 3, "planar": 1, "u8": 1, "u16": 2, "select": 3}
# Frames a block of K3 and K5 walks: it loads the next one's words while it
# stores this one's tile.
UNSKEW_FRAMES_PER_BLOCK = 2
TILE_THREADS = 256
SECTOR_BYTES = 32  # a device-memory sector: K1 writes its stream in whole ones
_GRID_Y_MAX = _GRID_Z_MAX = 65535


@dataclass(frozen=True)
class TilePlan:
    """One launch of K1, K6, K3 or K5: blocks of ``threads`` threads over tiles of
    ``td`` steps by ``ty`` rows, each block also loading the ``lead`` rows
    above its tile (K1, K6) or steps before it (K3, K5) that its sector-aligned
    store windows reach, ``grid`` = (row tiles, step tiles, frames a pass;
    a block walks frames z, z + grid[2], ...), and the block's static shared
    memory, which the kernel's layout must equal."""

    td: int
    ty: int
    lead: int
    threads: int
    grid: Tuple[int, int, int]
    smem_bytes: int


def _checked_grid(grid: Tuple[int, int, int], b: int, h: int, w: int) -> Tuple[int, int, int]:
    if min(b, h, w) < 1 or grid[1] > _GRID_Y_MAX:
        raise ValueError(f"no tile grid for B={b} H={h} W={w}")
    return grid


def skew_lead_rows(h: int, itemsize: int, out_phase: int = 0) -> int:
    """K1's and K6's ``lead``: the largest sector phase, in elements, of a
    stream row's start when the (D, C*B, H) output starts ``out_phase`` bytes past
    a sector boundary. Row R starts at out_phase + R*H*itemsize; modulo 32
    those are out_phase plus the multiples of gcd(H*itemsize, 32)."""
    step = math.gcd(h * itemsize, SECTOR_BYTES)
    return (out_phase % step + SECTOR_BYTES - step) // itemsize


@functools.lru_cache(maxsize=64)
def skew_tile_plan(b: int, h: int, w: int, s: int, dtype: torch.dtype,
                   out_phase: int = 0, channels: int = 3) -> TilePlan:
    """The launch of K1 (``channels`` = 3: B (H, W, 3) frames) or K6
    (``channels`` = 1: B (H, W) planes) into a stream of ``dtype`` (uint8
    or float32: the output's type, which alone sets the plan; K7's uint8 ->
    float32 form takes the float32 plan) and skew s, the output starting
    ``out_phase`` bytes past a 32-byte sector boundary (0 for a fresh
    allocation).

    Row tile k stores, of each stream row R, the window y in [k*TY - ph,
    (k+1)*TY - ph), ph = the phase of R's start in its sector, so every
    window starts on a sector boundary; a block therefore loads the
    ``lead`` >= ph rows above its tile too, and the grid has
    ceil((H + lead) / TY) row tiles. Shared memory: a 16-byte front pad,
    the tile's C*TD stream rows (dd, c) of TY + 32/itemsize elements and 4
    bytes (an odd count of 32-bit words, so the rows' word-wise reads meet
    no bank conflict), row r = C*dd + c placed at r + r/32 (a spare row
    after every 32, so the scattering byte stores of a warp meet few),
    and a 32-byte back pad; the pads take the reads of the first and last
    rows' partial words."""
    td, ty = SKEW_TILES[dtype, channels]
    e = dtype.itemsize
    lead = skew_lead_rows(h, e, out_phase)
    pitch = (ty + SECTOR_BYTES // e) * e + 4
    rows = channels * td
    grid = (-(-(h + lead) // ty), -(-stream_length(h, w, s) // td), min(b, _GRID_Z_MAX))
    return TilePlan(td, ty, lead, TILE_THREADS, _checked_grid(grid, b, h, w),
                    16 + (rows + rows // 32) * pitch + 32)


def unskew_band_tiles(h: int, w: int, s: int, td: int, ty: int) -> int:
    """Step tiles of the unskew's widest band: row tile k (rows y0 = k*TY ..
    y_last) holds pixels only in the step tiles s*y0 // TD through
    (s*y_last + W - 1) // TD."""
    widest = 1
    for y0 in range(0, h, ty):
        y_last = min(h, y0 + ty) - 1
        widest = max(widest, (s * y_last + w - 1) // td - (s * y0) // td + 1)
    return widest


@functools.lru_cache(maxsize=64)
def unskew_tile_plan(b: int, h: int, w: int, s: int, kind: str) -> TilePlan:
    """The launch of the unskew tile kernel for B (H, W) frames and skew s,
    by output ``kind`` (``UNSKEW_KINDS``): K3's "nhwc" and "planar" colours,
    K5's "u8" and "u16" index streams, K9's "select" colours (planned as
    "nhwc": three bytes a pixel, the same store phase).

    Of each output row (of each plane, planar), step tile k writes the
    window of U*TD bytes (U = 3 nhwc, 2 u16, else 1 byte a pixel) that
    starts on the sector boundary at or before its first pixel
    x0 = k*TD - s*y, so a block also loads the ``lead`` = ceil(31 / U) steps
    before its tile. Block (x, y, z) takes row tile x, the y-th step tile of
    that row tile's band (``unskew_band_tiles`` over W + lead: tiles that own
    no byte are never launched) and frames z, z + grid[2], ...
    (UNSKEW_FRAMES_PER_BLOCK of them). Shared memory: one int32 tile of TY
    rows of lead + TD steps, a spare word after every 32 and the pitch made
    odd (so the loads along y and the reads along x meet few bank
    conflicts), and each column's range of rows inside the image (an int32
    a column)."""
    td, ty = UNSKEW_TILE
    lead = -(-(SECTOR_BYTES - 1) // _UNSKEW_BYTES[kind])
    cols = lead + td
    grid = (-(-h // ty), unskew_band_tiles(h, w + lead, s, td, ty),
            min(-(-b // UNSKEW_FRAMES_PER_BLOCK), _GRID_Z_MAX))
    return TilePlan(td, ty, lead, TILE_THREADS, _checked_grid(grid, b, h, w),
                    4 * ty * ((cols + cols // 32) | 1) + 4 * cols)


def launch_unskew(col: torch.Tensor, out: torch.Tensor, s: int, kind: str,
                  palette: Optional[torch.Tensor] = None) -> None:
    """The unskew tile kernel from the (D, B, H) int32 stream ``col`` into
    ``out`` (any base address; u16 on a 2-byte boundary), by ``kind``, with
    the plan the kernel checks. The select kind takes the (P, 3) float32
    ``palette``, which the same call first packs into a fresh (P,) int32
    table, one colour a thread."""
    h, w = (out.shape[2:4] if kind == "planar" else out.shape[1:3])
    plan = unskew_tile_plan(col.shape[1], h, w, s, kind)
    table = (None if palette is None else
             torch.empty(palette.shape[0], dtype=torch.int32, device=palette.device))
    build.extension().unskew(col, out, s, UNSKEW_KINDS.index(kind), plan.td, plan.ty,
                             plan.lead, plan.threads, list(plan.grid), plan.smem_bytes,
                             palette, table)


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
         width: int, aux: Optional[torch.Tensor] = None,
         dense_search: str = "exact") -> torch.Tensor:
    """K2 on CUDA tensors, its plain version on CPU tensors. ``palette`` is
    (P, 3) float32 on the stream's device, P <= PACKED_PALETTE_MAX; ``aux``
    the (B, H, W) float32 map of perceptual and adaptive; ``dense_search``
    "exact" or "mxu" (``score_search``)."""
    if palette.shape[0] > PACKED_PALETTE_MAX:
        raise ValueError(
            f"the packed-colour scan serves up to {PACKED_PALETTE_MAX} colours, "
            f"got {palette.shape[0]}: use scan_idx")
    _check_aux(geom, aux, stream, width)
    if not build.on_cuda(stream):
        return scan_plain(stream, palette, geom, width, aux, dense_search)
    return launch_scan(stream, palette, geom, width, aux, False, dense_search)


def scan_idx(stream: torch.Tensor, palette: torch.Tensor, geom: ScanGeometry,
             width: int, aux: Optional[torch.Tensor] = None,
             dense_search: str = "exact") -> torch.Tensor:
    """K8 on CUDA tensors, its plain version on CPU tensors: the scan for
    palettes of up to INDEX_PALETTE_MAX colours, emitting palette indices."""
    if palette.shape[0] > INDEX_PALETTE_MAX:
        raise ValueError(
            f"the index scan serves up to {INDEX_PALETTE_MAX} colours, got "
            f"{palette.shape[0]}")
    _check_aux(geom, aux, stream, width)
    if not build.on_cuda(stream):
        return scan_idx_plain(stream, palette, geom, width, aux, dense_search)
    return launch_scan(stream, palette, geom, width, aux, True, dense_search)


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
    """K3 on CUDA tensors (a shared-memory tile transpose,
    ``unskew_tile_plan``), its plain version on CPU tensors."""
    if not build.on_cuda(col):
        return unskew_unpack_plain(col, s, h, w, planar_out)
    b = col.shape[1]
    out = torch.empty((3, b, h, w) if planar_out else (b, h, w, 3),
                      dtype=torch.uint8, device=col.device)
    launch_unskew(col, out, s, "planar" if planar_out else "nhwc")
    build.count_launch("unskew_unpack")
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
    """K5 on CUDA tensors (the index kinds of K3's tile transpose,
    ``unskew_tile_plan``), its plain version on CPU tensors."""
    if dtype not in (torch.uint8, torch.uint16):
        raise TypeError(f"the index stream is uint8 or uint16, got {dtype}")
    if not build.on_cuda(idx):
        return unskew_idx_plain(idx, s, h, w, dtype)
    out = torch.empty((idx.shape[1], h, w), dtype=dtype, device=idx.device)
    launch_unskew(idx, out, s, "u8" if dtype == torch.uint8 else "u16")
    build.count_launch("unskew_idx")
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
    """K9 on CUDA tensors (the "select" kind of K3's tile transpose,
    ``unskew_tile_plan``, after the palette's packing kernel), its plain
    version on CPU tensors. The indices are the index scan's, 0..P-1: they
    are not checked."""
    if not build.on_cuda(idx):
        return unskew_select_plain(idx, palette, s, h, w)
    out = torch.empty((idx.shape[1], h, w, 3), dtype=torch.uint8,
                      device=idx.device)
    launch_unskew(idx, out, s, "select", palette.contiguous())
    build.count_launch("unskew_select")
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
         planar: bool = False, return_indices: bool = False,
         dense_search: str = "exact") -> torch.Tensor:
    """(B, H, W, 3) uint8 or float32 frames + (P, 3) float32 palette on the
    same device -> (B, H, W, 3) uint8 palette colours. Any B, P from 1 to
    INDEX_PALETTE_MAX: up to PACKED_PALETTE_MAX colours through K1 -> K2 ->
    K3, more through K1 -> K8 -> K9.

    ``planar``: the frames are (3, B, H, W) channel-major planes and so is
    the output (K6 -> K2 -> K3's planar layout). ``return_indices``: the
    result is the (B, H, W) index stream, uint8 up to 256 colours and
    uint16 above (skew -> K8 -> K5), whatever the frames' layout. Both
    serve up to PACKED_PALETTE_MAX colours, as the JAX package does.
    ``dense_search``: "exact" or "mxu", the scan's palette search
    (``score_search``). Frames of either dtype reach the stream through K1,
    planes through K6."""
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
        idx = scan_idx(stream, palette, geom, w, aux, dense_search)
        return unskew_idx(idx, geom.s, h, w, index_dtype(p))
    if p <= PACKED_PALETTE_MAX:
        col = scan(stream, palette, geom, w, aux, dense_search)
        return unskew_unpack(col, geom.s, h, w, planar_out=planar)
    idx = scan_idx(stream, palette, geom, w, aux, dense_search)
    return unskew_select(idx, palette, geom.s, h, w)


# The first-batch gate of dense_search="auto": (mode, variant, factors,
# palette bytes) -> "mxu" or "exact", decided once for the process.
_DENSE_GATE_CACHE: Dict[tuple, str] = {}
# Held while a key is undecided, so that two threads (the video pipeline's
# overlap workers) decide it once.
_DENSE_GATE_LOCK = threading.Lock()
_DENSE_GATE_MAX_KEYS = 64
_DENSE_GATE_MIN_IDENTITY = 0.98
_DENSE_GATE_MAX_BLOCK_MEAN = 2.0
_DENSE_GATE_MAX_BLOCK_MAX = 32.0


def _dense_gate_frames(out: torch.Tensor, palette: torch.Tensor, planar: bool,
                       return_indices: bool) -> torch.Tensor:
    """A batched output as (B, H, W, 3) uint8 frames for the gate's metrics;
    indices gather through the palette exactly."""
    if return_indices:
        if out.dtype == torch.uint16:  # few operators take uint16
            idx = out.view(torch.int16).to(torch.int64) & 0xFFFF
        else:
            idx = out.to(torch.int64)
        return palette.to(torch.uint8)[idx]
    return out.permute(1, 2, 3, 0) if planar else out


def _dense_gated_run(mode: str, images: torch.Tensor, palette: torch.Tensor,
                     variant: str, kw: dict,
                     palette_key: Optional[bytes] = None) -> torch.Tensor:
    """``dense_search="auto"``: the first batch of a (mode, variant,
    factors, palette) runs both searches and compares the score output with
    the exact one on the device, frame by frame: pixel identity >= 0.98, 4x4
    block mean colour within 2.0 on average and 32.0 at worst. The verdict
    holds for the life of the process; later batches run one search. A
    score run that fails raises, it does not lock the exact search.
    ``palette_key``: the palette's bytes where the caller holds them on the
    host; without it they are read back from the tensor on every batch."""
    if palette_key is None:
        palette_key = palette.detach().cpu().numpy().tobytes()
    key = (mode, variant, float(kw["lum_factor"]), float(kw["col_factor"]), palette_key)
    choice = _DENSE_GATE_CACHE.get(key)
    if choice is None:
        with _DENSE_GATE_LOCK:
            choice = _DENSE_GATE_CACHE.get(key)
            if choice is None:
                if len(_DENSE_GATE_CACHE) > _DENSE_GATE_MAX_KEYS:
                    _DENSE_GATE_CACHE.clear()
                return _dense_gate_decide(mode, images, palette, variant, kw, key)
    return _run(mode, images, palette, variant, dense_search=choice, **kw)


def _dense_gate_decide(mode: str, images: torch.Tensor, palette: torch.Tensor,
                       variant: str, kw: dict, key: tuple) -> torch.Tensor:
    """Both searches on the gate's first batch; records and applies the
    verdict."""
    out_exact = _run(mode, images, palette, variant, dense_search="exact", **kw)
    out_score = _run(mode, images, palette, variant, dense_search="mxu", **kw)
    frames_exact, frames_score = (
        _dense_gate_frames(out, palette, kw["planar"], kw["return_indices"])
        for out in (out_exact, out_score))
    idents, means, maxes = [], [], []
    for fa, fb in zip(frames_exact, frames_score):
        idents.append(fidelity.identity_fraction(fa, fb))
        mean, worst = fidelity.block_mean_error(fa, fb, block=4)
        means.append(mean)
        maxes.append(worst)
    ok = (min(idents) >= _DENSE_GATE_MIN_IDENTITY
          and max(means) <= _DENSE_GATE_MAX_BLOCK_MEAN
          and max(maxes) <= _DENSE_GATE_MAX_BLOCK_MAX)
    _DENSE_GATE_CACHE[key] = "mxu" if ok else "exact"
    return out_score if ok else out_exact


def ed_batch_wavefront(images: torch.Tensor, palette: torch.Tensor,
                       mode: str = "fixed", variant: str = "floyd_steinberg",
                       aux: Optional[torch.Tensor] = None,
                       lum_factor: float = 1.0, col_factor: float = 0.2,
                       planar: bool = False, return_indices: bool = False,
                       dense_search: Optional[str] = None,
                       palette_key: Optional[bytes] = None) -> torch.Tensor:
    """Batched entry of the video path: (B, H, W, 3) frames in one scan,
    or with ``planar`` (3, B, H, W) planes in and out; with
    ``return_indices`` the (B, H, W) index stream comes back instead of
    colours. ``aux``: adaptive's (B, H, W) float32 gates; perceptual's
    sensitivity map is built here from the frames.

    ``dense_search``: ``None`` or "exact", the exact palette search; "mxu",
    the score search for palettes of 65 to PACKED_PALETTE_MAX colours
    (outside the bit contract: near ties may flip); "auto", the first-batch
    gate that keeps the score search only where its output matches the
    exact one perceptually (``_dense_gated_run``). ``palette_key``: for
    "auto", the palette's host bytes as the gate's key, so that a decided
    batch costs no read of a palette that lies on the device."""
    _check_mode(mode)
    dense_search = dense_search or "exact"
    if dense_search not in DENSE_SEARCHES + ("auto",):
        raise ValueError(f"dense_search must be None, 'exact', 'mxu' or 'auto', got "
                         f"{dense_search!r}")
    if mode == "perceptual":
        aux = perceptual_sensitivity(images, planar)
    kw = dict(aux=aux, lum_factor=lum_factor, col_factor=col_factor, planar=planar,
              return_indices=return_indices)
    if dense_search == "auto":
        if score_search("mxu", palette.shape[0]):
            return _dense_gated_run(mode, images, palette, variant, kw, palette_key)
        dense_search = "exact"  # small and very large palettes never enter the gate
    return _run(mode, images, palette, variant, dense_search=dense_search, **kw)


def wavefront_device_fn(mode: str, variant: str, h: int, w: int, p: int,
                        batch: int, lum_factor: float = 1.0,
                        col_factor: float = 0.2, planar: bool = False,
                        dense_search: str = "exact") -> Callable:
    """``fn(frames (batch, h, w, 3), palette (p, 3) f32, aux=None) ->
    (batch, h, w, 3) uint8``: the shape-checked device function of one
    configuration, as the JAX package's benchmark builds it (``aux``: the
    (batch, h, w) float32 map of perceptual and adaptive); with ``planar``
    the frames and the result are (3, batch, h, w) planes; ``dense_search``
    "exact" or "mxu". Raises at construction for an unknown mode or search
    and for a planar configuration above PACKED_PALETTE_MAX colours."""
    _check_mode(mode)
    score_search(dense_search, p)  # raises for an unknown search
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
                    planar, dense_search=dense_search)

    return fn

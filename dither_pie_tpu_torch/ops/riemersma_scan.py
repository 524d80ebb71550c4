"""On-device Riemersma dithering: the scan along the Hilbert curve (R1).

The port of ``dither_pie_tpu/ops/riemersma_scan.py``. Riemersma diffuses
each pixel's error along a Hilbert curve with Floyd-Steinberg-style weights
[7, 1, 5, 3]/16 pushed to the next four curve positions: one serial chain
through the frame, with no 2-D wavefront. The facade runs it on the host
engine (``ops/ed_host.py``); ``DITHER_PIE_TPU_RIEMERSMA=scan`` sends it
here instead, as in the JAX package, where a ``lax.scan`` over the curve
carries the batch in the vector lanes. On the card the chain is the kernel
R1 (``kernels/csrc/riemersma_scan.cu``): a block of two warps a frame, a
chain warp that runs the steps with the search split across its lanes,
and a producer warp that stages the curve into a ring of chunks in shared
memory and writes the chosen colours out (``staged_records`` models what
it stages).

Exact semantics, bit for bit those of the host engine's float32 twin
(``ed_host.ed_riemersma_fast``, ``native/ed_scan.cpp`` ``ed_riemersma_f32``)
up to its ``F32_TWIN_MAX_PAL`` colours (above them that twin hands over to
the float64 engine; the scan, like the JAX package's, stays float32):

* the raw curve covers the padded 2^k grid; off-image slots are skipped,
  but the "next 4" receiver window is over RAW slots (off-image receivers
  drop their share);
* no clamp before the search (receivers are clamped at receive time);
* palette search in float32, ``(dr*dr + dg*dg) + db*db``, first strict
  minimum by palette index;
* each receiver add is clamped at once, ``clip(q + e*w, 0, 255)``, and only
  a receiver with ``w > 0`` changes.

The raw window compresses exactly: valid positions keep curve order, so a
valid receiver at raw offset 1 + k lands at compressed offset d in [1, 4],
and distinct k map to distinct d. ``path_maps`` gives, per valid step, a
(4,) weight row whose entry d - 1 carries ``FS_WEIGHTS[k]`` for the
receiver at compressed offset d (0 = no receiver), as the JAX package's
``_path_maps``. Every raw slot between a step and a valid receiver is
itself a valid receiver, so d is the count of valid k' <= k, and the row
is fixed by the 4-bit mask of valid k: the card holds that mask, one byte
a step (``receiver_masks``), and R1 decodes the d-th set bit k into
``FS_WEIGHTS[k]`` at offset d.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dither_pie_tpu_torch.api import transfer
from dither_pie_tpu_torch.kernels import build
from dither_pie_tpu_torch.ops.hilbert import hilbert_path, next_power_of_two

FS_WEIGHTS = (np.float32(7 / 16), np.float32(1 / 16),
              np.float32(5 / 16), np.float32(3 / 16))

# Largest palette R1 takes: 12 bytes of shared memory a colour, 192 KB.
MAX_PALETTE = 16384
# R1's staging (riemersma_scan.cu): chunks of R1_CHUNK curve steps, a ring
# of R1_SLOTS of them in shared memory, a 32-byte record a step.
R1_CHUNK = 160
R1_SLOTS = 4

# R1's search form by palette size: colours a lane in registers up to
# 32 x R1_REG_COLOURS colours, then shared memory in passes of R1_PAL_ALIGN.
R1_REG_COLOURS = 16
R1_PAL_ALIGN = 128


def colours_a_lane(p: int) -> int:
    """R1's search form at ``p`` colours, as riemersma_scan.cu's: 1, 8 or
    R1_REG_COLOURS colours a lane in registers, or 0 for shared memory."""
    return 1 if p <= 32 else 8 if p <= 256 else R1_REG_COLOURS if p <= 32 * R1_REG_COLOURS else 0


def smem_bytes(p: int) -> int:
    """R1's dynamic shared memory at ``p`` colours, as
    ``dpt_riemersma_smem_bytes``: 2 x R1_SLOTS mbarriers, the head's five
    16-byte records, R1_SLOTS slots of R1_CHUNK (32-byte record, order,
    chosen index), then the palette's three float planes as far as the
    search form reads (32 x its colours a lane, or ``p`` rounded up to
    R1_PAL_ALIGN colours), +inf past ``p``."""
    ring = 2 * R1_SLOTS * 8 + 5 * 16 + R1_SLOTS * R1_CHUNK * (32 + 4 + 4)
    npl = colours_a_lane(p)
    padded = 32 * npl if npl else -(-p // R1_PAL_ALIGN) * R1_PAL_ALIGN
    return ring + 3 * padded * 4


def staged_records(frame: np.ndarray, order: np.ndarray, mask: np.ndarray):
    """numpy model of what R1's producer stages for one (H, W, 3) frame:
    (head (5, 4) float32, records (C * R1_CHUNK, 8) float32, orders
    (C * R1_CHUNK,) int32) over the C whole chunks that cover the N curve
    steps. The head holds the pixels of steps 0..4; record t holds step t's
    four receiver weights (the d-th set bit k of its mask puts
    ``FS_WEIGHTS[k]`` in column d - 1) and the pixel of step t + 5, zeros
    past the curve; orders are -1 past it."""
    n = order.shape[0]
    c = -(-n // R1_CHUNK)
    flat = frame.reshape(-1, 3).astype(np.float32)
    px = np.zeros((c * R1_CHUNK + 5, 4), np.float32)
    px[:n, :3] = flat[order]
    rec = np.zeros((c * R1_CHUNK, 8), np.float32)
    d = np.zeros(n, np.int64)
    for k in range(4):
        on = (mask >> k) & 1 == 1
        rec[np.flatnonzero(on), d[on]] = FS_WEIGHTS[k]
        d += on
    rec[:, 4:] = px[5:]
    orders = np.full(c * R1_CHUNK, -1, np.int32)
    orders[:n] = order
    return px[:5].copy(), rec, orders


@functools.lru_cache(maxsize=8)
def _curve_maps(h: int, w: int):
    """(order_lin, wt, mask) of ``path_maps`` and ``receiver_masks``."""
    dim = next_power_of_two(max(h, w))
    path = hilbert_path(dim)  # (n, 2) [row, col]
    valid = (path[:, 0] < h) & (path[:, 1] < w)
    order_lin = (path[valid, 0].astype(np.int64) * w
                 + path[valid, 1].astype(np.int64)).astype(np.int32)
    n_raw = path.shape[0]
    comp = np.cumsum(valid) - 1  # compressed index per raw slot (valid only)
    n = int(valid.sum())
    wt = np.zeros((n, 4), np.float32)
    mask = np.zeros(n, np.uint8)
    vi = np.flatnonzero(valid)
    for k in range(4):
        j = vi + 1 + k
        ok = (j < n_raw)
        jj = j[ok]
        src = comp[vi[ok]]
        tgt_valid = valid[jj]
        d = comp[jj[tgt_valid]] - src[tgt_valid]  # in [1, 4]
        wt[src[tgt_valid], d - 1] = FS_WEIGHTS[k]
        mask[src[tgt_valid]] |= np.uint8(1 << k)
    for a in (order_lin, wt, mask):
        a.flags.writeable = False
    return order_lin, wt, mask


def path_maps(h: int, w: int):
    """(order_lin (N,) int32 curve-ordered linear pixel indices, wt (N, 4)
    float32 per-step compressed receiver weights), N = h * w; read-only,
    cached per shape."""
    order_lin, wt, _ = _curve_maps(h, w)
    return order_lin, wt


def receiver_masks(h: int, w: int) -> np.ndarray:
    """(N,) uint8: bit k set where the raw slot k + 1 after the step is a
    valid receiver; read-only, cached per shape."""
    return _curve_maps(h, w)[2]


@functools.lru_cache(maxsize=8)
def device_maps(h: int, w: int, device: torch.device):
    """(order_lin int32, mask uint8) on ``device``: R1's inputs besides the
    frames and the palette, made once per shape and device (at 1080p 8.3 MB
    and 2.1 MB)."""
    order_lin, _, mask = _curve_maps(h, w)
    return (torch.from_numpy(order_lin.copy()).to(device),
            torch.from_numpy(mask.copy()).to(device))


def riemersma_scan_plain(frames: torch.Tensor, pal: torch.Tensor, order: torch.Tensor,
                         wt: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch R1: (B, H, W, 3) uint8 or float32 frames, a (P, 3)
    float32 palette, the curve's (N,) order and (N, 4) weight rows ->
    (B, H, W, 3) uint8, on the frames' device.

    A Python loop over the N curve steps, the batch a tensor dimension:
    each step is the JAX package's ``one()``, a ring of the 5 working
    values ahead, the search in float32 with the first strict minimum by
    palette index, the error, and each receiver with ``w > 0`` clamped at
    once. Seconds at a few thousand steps; never for full-size frames."""
    b, h, w, _ = frames.shape
    dev = frames.device
    n = order.shape[0]
    p = pal.shape[0]
    pal = pal.to(device=dev, dtype=torch.float32)
    order = order.to(device=dev, dtype=torch.long)
    wt = wt.to(device=dev, dtype=torch.float32)
    x = torch.zeros((n + 5, b, 3), dtype=torch.float32, device=dev)
    x[:n] = frames.reshape(b, h * w, 3)[:, order].to(torch.float32).transpose(0, 1)
    pal_rgb = [pal[:, c][None] for c in range(3)]  # (1, P) each
    iota = torch.arange(p, device=dev)
    weights = wt[:, :, None, None]  # (N, 4, 1, 1)
    receives = weights > 0
    picks = torch.empty((n, b), dtype=torch.long, device=dev)
    for i in range(n):
        old = x[i]  # (B, 3)
        dr = pal_rgb[0] - old[:, 0:1]
        dg = pal_rgb[1] - old[:, 1:2]
        db = pal_rgb[2] - old[:, 2:3]
        d2 = (dr * dr + dg * dg) + db * db  # (B, P), the twin's association
        # amin, not min(dim=): the latter enters a thread pool even on a few
        # elements, which is milliseconds a call on a busy host.
        dmin = d2.amin(dim=1, keepdim=True)
        idx = torch.where(d2 == dmin, iota, p).amin(dim=1)  # (B,)
        err = old - pal[idx]
        ring = x[i + 1:i + 5]
        upd = (ring + err * weights[i]).clamp(0.0, 255.0)
        x[i + 1:i + 5] = torch.where(receives[i], upd, ring)
        picks[i] = idx
    out = torch.empty((b, h * w, 3), dtype=torch.uint8, device=dev)
    out[:, order] = pal[picks].to(torch.uint8).transpose(0, 1)
    return out.reshape(b, h, w, 3)


def riemersma_scan(frames: torch.Tensor, pal: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 or float32 frames and a (P, 3) float32 palette on
    one device -> (B, H, W, 3) uint8 there: R1 on CUDA tensors (counted in
    ``build.LAUNCHES["riemersma_scan"]``; a build or launch failure raises),
    the plain version on CPU tensors. Other frame dtypes are cast to
    float32 first; uint8 frames stay uint8 (R1 widens them at the load,
    which is exact)."""
    if frames.dim() != 4 or frames.shape[-1] != 3:
        raise ValueError(f"frames must be (B, H, W, 3), got {tuple(frames.shape)}")
    if pal.dim() != 2 or pal.shape[1] != 3 or not 1 <= pal.shape[0] <= MAX_PALETTE:
        raise ValueError(f"palette must be (P, 3) with 1 <= P <= {MAX_PALETTE}, "
                         f"got {tuple(pal.shape)}")
    if frames.dtype != torch.uint8:
        frames = frames.to(torch.float32)
    frames = frames.contiguous()
    pal = pal.to(device=frames.device, dtype=torch.float32).contiguous()
    b, h, w, _ = frames.shape
    if not build.on_cuda(frames):
        order, wt = path_maps(h, w)
        return riemersma_scan_plain(frames, pal, torch.from_numpy(order.copy()),
                                    torch.from_numpy(wt.copy()))
    order, mask = device_maps(h, w, frames.device)
    out = torch.empty((b, h, w, 3), dtype=torch.uint8, device=frames.device)
    build.extension().riemersma_scan(frames, pal, order, mask, out)
    build.count_launch("riemersma_scan")
    return out


def riemersma_scan_batch(images, palette, device="cuda") -> np.ndarray:
    """(B, H, W, 3) host frames (uint8 stays uint8, anything else becomes
    float32) and a (P, 3) palette -> (B, H, W, 3) uint8 host frames,
    through ``riemersma_scan`` on ``device``; bit-identical to
    ``ed_host.ed_riemersma_fast`` per frame up to 4096 colours."""
    images = np.asarray(images)
    if images.dtype != np.uint8:
        images = images.astype(np.float32)
    frames = transfer.to_device(np.ascontiguousarray(images), device)
    pal = torch.from_numpy(np.ascontiguousarray(palette, np.float32)).to(device)
    return transfer.to_host(riemersma_scan(frames, pal))

"""Bit-packing of palette-index streams before they leave the device: the
port of ``dither_pie_tpu/ops/idxpack.py``.

The index transfer path (``ImageDitherer.apply_dithering_batch``) ships
(B, H, W) uint8 palette indices instead of RGB, a third of the bytes. A
P-colour palette needs only ceil(log2(P)) bits per pixel: 16 colours (the
reference's most common palette size) fit 2 pixels per byte, 4 colours 4
pixels, 2 colours 8. Packing runs on the indices' device as a handful of
uint8 shift/or ops (plain torch ops here as plain XLA ops in the JAX
package: no kernel of either package), the packed buffer crosses the link
in one copy, and the host unpack (numpy shifts) restores the exact
indices. On by default, as in the JAX package; ``DITHER_PIE_TPU_INDEX_PACK=0``
opts out. Packing pays where the link time of the bytes it saves exceeds
the host unpack's time; ``api/linkspeed.py`` turns the index stream on only
for links slower still (the host gather costs more than the unpack), so
wherever the stream is on by measurement, packing pays too.

Bit order: the FIRST pixel of each group lands in the HIGH bits of the
byte, groups tile the row left to right, rows are padded up to a whole
group with zeros and cropped on unpack.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from dither_pie_tpu_torch.api.transfer import to_host


def pack_bits_for(p: int) -> int:
    """Bits per pixel the packed stream needs for a P-colour palette, or 0
    when packing buys nothing (P > 16 needs >= 5 bits: a 2-pixel byte no
    longer fits, so the plain 8-bit stream is already minimal)."""
    if p <= 2:
        return 1
    if p <= 4:
        return 2
    if p <= 16:
        return 4
    return 0


def pack_enabled() -> bool:
    return os.environ.get("DITHER_PIE_TPU_INDEX_PACK", "1") != "0"


def pack_indices_device(idx: torch.Tensor, bpp: int) -> torch.Tensor:
    """(B, H, W) uint8 indices -> (B, H, ceil(W/per)) uint8 packed, on the
    indices' device. Values must be < 2**bpp (``bpp`` comes from
    ``pack_bits_for(P)`` and indices are < P)."""
    per = 8 // bpp
    b, h, w = idx.shape
    wp = -(-w // per) * per
    if wp != w:
        idx = torch.nn.functional.pad(idx, (0, wp - w))
    r = idx.reshape(b, h, wp // per, per)
    acc = r[..., 0]
    for i in range(1, per):
        acc = (acc << bpp) | r[..., i]
    return acc


def unpack_indices_host(packed: np.ndarray, bpp: int, w: int) -> np.ndarray:
    """Exact inverse of ``pack_indices_device``: (B, H, Wp) uint8 -> (B, H,
    w) uint8 indices, numpy shifts and masks on the host."""
    per = 8 // bpp
    b, h, wp = packed.shape
    mask = np.uint8((1 << bpp) - 1)
    out = np.empty((b, h, wp, per), np.uint8)
    for i in range(per):
        out[..., i] = (packed >> np.uint8(bpp * (per - 1 - i))) & mask
    return np.ascontiguousarray(out.reshape(b, h, wp * per)[..., :w])


def packed_transfer(idx: torch.Tensor, p: int, w: int) -> np.ndarray:
    """The one device-to-host copy of an index tensor: pack on the device
    when the palette qualifies and ``DITHER_PIE_TPU_INDEX_PACK`` allows,
    copy the packed bytes, unpack on the host; otherwise copy the indices
    as they are. Either copy goes through ``api.transfer.to_host``. Returns
    host (B, H, w) indices of ``idx``'s dtype either way."""
    bpp = pack_bits_for(p)
    if not bpp or not pack_enabled() or idx.dtype != torch.uint8:
        return to_host(idx)
    return unpack_indices_host(to_host(pack_indices_device(idx, bpp)), bpp, w)

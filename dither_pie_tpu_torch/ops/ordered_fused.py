"""K4: the fused ordered-dither kernel and its plain PyTorch version.

The port of ``dither_pie_tpu/ops/ordered_pallas.py`` (the Pallas kernel
``_compiled_padded``, body ``_build``). For every pixel of a (B, H, W, 3)
batch, u8 or float32, it keeps a running top-2 of squared palette distances,
``d = (dr*dr + dg*dg) + db*db`` in float32 with strict ``<`` (the lowest
index wins every tie), and picks ``i1`` where ``d1/(d1+d2) <= screen[y, x]``
(0 where both are 0), ``i2`` otherwise. It returns the chosen colours as u8
(truncated from the float32 palette) or, with ``return_indices``, the u8
index. A float32 batch is taken as it is, never truncated: the wavelet
mode's reconstruction is not integer-valued (the TPU kernel's prep cast
every batch to u8; its XLA twin, which served the wavelet mode, did not).

Which implementation runs is a pure function of the tensor's device: a
CUDA tensor launches ``kernels/csrc/ordered.cu`` (counted in
``kernels.build.LAUNCHES["ordered_fused"]``), a CPU tensor runs
``ordered_dither_fused_plain``. There is no fallback between them.

Left out, as TPU artefacts: the shape bucketing, 128-lane padding,
sentinel palette padding and planar (3, rows, W) repack. The kernel reads
NHWC directly and the (H, W) screen once for every frame.
"""

from __future__ import annotations

import torch

from dither_pie_tpu_torch.kernels import build

# Largest palette K4 serves: three float32 planes of 4096 entries fill the
# 48 KB of shared memory a block gets without opting in (and 4096 is the
# golden engine's MAX_PAL).
FUSED_PALETTE_MAX = 4096
# Largest palette whose index fits the u8 index stream.
INDEX_PALETTE_MAX = 256


def _check(images: torch.Tensor, palette: torch.Tensor, screen: torch.Tensor,
           return_indices: bool) -> None:
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"images must be (B, H, W, 3), got {tuple(images.shape)}")
    if images.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"images must be uint8 or float32, got {images.dtype}")
    if palette.dtype != torch.float32 or palette.dim() != 2 or palette.shape[1] != 3:
        raise ValueError("palette must be a (P, 3) float32 tensor")
    p = palette.shape[0]
    if not 1 <= p <= FUSED_PALETTE_MAX:
        raise ValueError(f"palette size {p} outside 1..{FUSED_PALETTE_MAX}")
    if return_indices and p > INDEX_PALETTE_MAX:
        raise ValueError("return_indices requires a palette <= 256 colors")
    if screen.dtype != torch.float32 or tuple(screen.shape) != tuple(images.shape[1:3]):
        raise ValueError(f"screen must be ({images.shape[1]}, {images.shape[2]}) "
                         f"float32, got {tuple(screen.shape)} {screen.dtype}")
    if not (palette.device == screen.device == images.device):
        raise ValueError(f"images on {images.device}, palette on {palette.device}, "
                         f"screen on {screen.device}")


def ordered_dither_fused_plain(images: torch.Tensor, palette: torch.Tensor,
                               screen: torch.Tensor,
                               return_indices: bool = False) -> torch.Tensor:
    """Plain PyTorch K4: the TPU kernel's running top-2 as a loop over the
    palette on (B, H, W) planes. It never materialises (N, P)."""
    _check(images, palette, screen, return_indices)
    r, g, b = images.to(torch.float32).unbind(-1)
    pal_t = palette.t()  # (3, P)
    d1 = torch.full_like(r, float("inf"))
    d2 = torch.full_like(r, float("inf"))
    i1 = torch.zeros(r.shape, dtype=torch.int32, device=r.device)
    i2 = torch.zeros_like(i1)
    for p in range(palette.shape[0]):
        dr = r - pal_t[0, p]
        dg = g - pal_t[1, p]
        db = b - pal_t[2, p]
        d = (dr * dr + dg * dg) + db * db
        better1 = d < d1
        better2 = ~better1 & (d < d2)
        d2 = torch.where(better1, d1, torch.where(better2, d, d2))
        i2 = torch.where(better1, i1, torch.where(better2, p, i2))
        d1 = torch.where(better1, d, d1)
        i1 = torch.where(better1, p, i1)
    tot = d1 + d2
    factor = torch.where(tot == 0, 0.0, d1 / tot)
    idx = torch.where(factor <= screen, i1, i2)
    if return_indices:
        return idx.to(torch.uint8)
    return palette[idx.long()].to(torch.int32).to(torch.uint8)


def ordered_dither_fused(images: torch.Tensor, palette: torch.Tensor,
                         screen: torch.Tensor,
                         return_indices: bool = False) -> torch.Tensor:
    """K4 on CUDA tensors, its plain version on CPU tensors.

    ``images`` (B, H, W, 3) u8 or float32 (float32 pixels enter the
    distances as they are), ``palette`` (P, 3) float32 with P <= 4096, ``screen`` (H, W) float32, all on one
    device. Returns (B, H, W, 3) u8 colours, or (B, H, W) u8 indices with
    ``return_indices`` (P <= 256)."""
    if not build.on_cuda(images):
        return ordered_dither_fused_plain(images, palette, screen, return_indices)
    _check(images, palette, screen, return_indices)
    frames = images.contiguous()
    shape = frames.shape[:3] if return_indices else frames.shape
    out = torch.empty(shape, dtype=torch.uint8, device=frames.device)
    build.extension().ordered_fused(frames, palette.contiguous(),
                                    screen.contiguous(), out, return_indices)
    build.LAUNCHES["ordered_fused"] += 1
    return out

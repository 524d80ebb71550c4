"""Pixelization: the regular nearest-neighbour downscale to even
dimensions. The neural pixelizer is not ported yet (ROADMAP A9)."""

from __future__ import annotations

from typing import Optional

from PIL import Image

from dither_pie_tpu_torch.utils import compute_even_dimensions


def pixelize_regular(image: Image.Image, max_size: int) -> Image.Image:
    """Nearest-neighbour downscale so the smaller side is about
    ``max_size``, both sides even."""
    orig_w, orig_h = image.size
    target_w, target_h = compute_even_dimensions(orig_w, orig_h, max_size)
    return image.resize((target_w, target_h), Image.Resampling.NEAREST).convert("RGB")


def get_neural_pixelizer(checkpoint_dir: Optional[str] = None):
    """The neural pixelizer (c2pGen/AliasNet) is not ported yet."""
    raise NotImplementedError(
        "the neural pixelizer is not ported yet (ROADMAP A9)")

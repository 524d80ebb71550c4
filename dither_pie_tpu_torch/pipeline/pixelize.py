"""Pixelization: the regular nearest-neighbour downscale to even
dimensions, and the process-wide neural pixelizer (``models/``)."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from PIL import Image

from dither_pie_tpu_torch.api.runtime import DeviceLike, resolve_device
from dither_pie_tpu_torch.utils import compute_even_dimensions

# One neural pixelizer a device, loaded at first use.
_neural_singletons: Dict[torch.device, object] = {}


def pixelize_regular(image: Image.Image, max_size: int) -> Image.Image:
    """Nearest-neighbour downscale so the smaller side is about
    ``max_size``, both sides even."""
    orig_w, orig_h = image.size
    target_w, target_h = compute_even_dimensions(orig_w, orig_h, max_size)
    return image.resize((target_w, target_h), Image.Resampling.NEAREST).convert("RGB")


def _key(device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def get_neural_pixelizer(checkpoint_dir: Optional[str] = None, device: DeviceLike = "cuda"):
    """The process-wide neural pixelizer on ``device``: the released
    checkpoints are loaded once (``models.convert.find_checkpoint_dir``
    unless ``checkpoint_dir`` is given). CUDA without a card raises, as
    does a missing checkpoint."""
    key = _key(device)
    if key not in _neural_singletons:
        from dither_pie_tpu_torch.models.pixelizer import NeuralPixelizer

        _neural_singletons[key] = NeuralPixelizer(checkpoint_dir=checkpoint_dir, device=key)
    return _neural_singletons[key]


def install_neural_pixelizer(pixelizer) -> None:
    """Make ``pixelizer`` (a ``NeuralPixelizer``, e.g. one over random
    weights) the process-wide one of its device."""
    _neural_singletons[_key(pixelizer.device)] = pixelizer

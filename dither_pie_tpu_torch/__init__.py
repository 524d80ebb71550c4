"""dither_pie_tpu_torch — the PyTorch and CUDA port of dither_pie_tpu for an
NVIDIA H100.

The package sits beside the JAX package, which stays the reference, and
mirrors its layout (``core/palette.py``, ``ops/wavefront.py``,
``api/ditherer.py``, ...). It imports torch, numpy and PIL, never jax and
never ``dither_pie_tpu``.

This slice serves the main path: k-means palettes and fixed-weight error
diffusion (8 variants, palettes of <= 64 colours) on NHWC uint8 batches,
through three hand-written Hopper kernels (``kernels/csrc``). The device is
explicit: ``ImageDitherer(..., device="cuda")`` (the default) launches the
kernels, ``device="cpu"`` runs their plain PyTorch versions.
"""

from dither_pie_tpu_torch.api.ditherer import (
    BaseDitherStrategy,
    ColorReducer,
    DitherMode,
    ErrorDiffusionDitherStrategy,
    ErrorDiffusionKernel,
    ImageDitherer,
    PaletteSource,
)
from dither_pie_tpu_torch.api.runtime import resolve_device

__all__ = [
    "BaseDitherStrategy",
    "ColorReducer",
    "DitherMode",
    "ErrorDiffusionDitherStrategy",
    "ErrorDiffusionKernel",
    "ImageDitherer",
    "PaletteSource",
    "resolve_device",
]

__version__ = "0.1.0"

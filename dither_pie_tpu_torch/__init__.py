"""dither_pie_tpu_torch — the PyTorch and CUDA port of dither_pie_tpu for an
NVIDIA H100.

The package sits beside the JAX package, which stays the reference, and
mirrors its layout (``core/palette.py``, ``ops/wavefront.py``,
``api/ditherer.py``, ...). It imports torch, numpy and PIL, never jax and
never ``dither_pie_tpu``.

It serves two paths on NHWC uint8 batches and single images, through
hand-written Hopper kernels (``kernels/csrc``):

* the ordered family (none, Bayer 2x2/4x4/8x8/16x16/PSX, blue noise, IGN,
  polka dot; Bayer 4x4 is ``ImageDitherer()``'s default) on K4, palettes of
  up to 4096 colours;
* k-means palettes and fixed-weight error diffusion (8 variants, palettes
  of <= 64 colours) on K1-K3.

Every mode's parameter metadata is served (``get_mode_parameters``); the
modes not ported yet raise NotImplementedError naming their ROADMAP item.
The device is explicit: ``ImageDitherer(..., device="cuda")`` (the
default) launches the kernels, ``device="cpu"`` runs their plain PyTorch
versions.
"""

from dither_pie_tpu_torch.api.ditherer import (
    BaseDitherStrategy,
    BayerDitherStrategy,
    BlueNoiseDitherStrategy,
    ColorReducer,
    DitherMode,
    DitherUtils,
    ErrorDiffusionDitherStrategy,
    ErrorDiffusionKernel,
    ImageDitherer,
    InterleavedGradientNoiseDitherStrategy,
    MatrixDitherStrategy,
    NoDitherStrategy,
    PaletteSource,
    PolkaDotDitherStrategy,
)
from dither_pie_tpu_torch.api.runtime import resolve_device

__all__ = [
    "BaseDitherStrategy",
    "BayerDitherStrategy",
    "BlueNoiseDitherStrategy",
    "ColorReducer",
    "DitherMode",
    "DitherUtils",
    "ErrorDiffusionDitherStrategy",
    "ErrorDiffusionKernel",
    "ImageDitherer",
    "InterleavedGradientNoiseDitherStrategy",
    "MatrixDitherStrategy",
    "NoDitherStrategy",
    "PaletteSource",
    "PolkaDotDitherStrategy",
    "resolve_device",
]

__version__ = "0.1.0"

"""dither_pie_tpu_torch — the PyTorch and CUDA port of dither_pie_tpu for an
NVIDIA H100.

The package sits beside the JAX package, which stays the reference, and
mirrors its layout (``core/palette.py``, ``ops/wavefront.py``,
``api/ditherer.py``, ...). It imports torch, numpy and PIL, never jax and
never ``dither_pie_tpu``.

It serves 12 of the 13 dither modes (all but Riemersma) on NHWC uint8
batches and single images, through hand-written Hopper kernels
(``kernels/csrc``):

* the ordered family (none, Bayer 2x2/4x4/8x8/16x16/PSX, blue noise, IGN,
  polka dot; Bayer 4x4 is ``ImageDitherer()``'s default) on K4, palettes of
  up to 4096 colours;
* k-means palettes and the error-diffusion family (8 fixed-weight variants,
  Ostromoukhov, hybrid, perceptual, adaptive variance; row-major scans) on
  the wavefront kernels: K1-K3 for palettes of up to 1024 colours, K1, K8
  and K9 above;
* wavelet (DWT, randomized subband quantization and IDWT as torch ops, the
  randomized pick on K4's float32 input) and halftone (torch ops), both
  also through the u8 index stream.

Up to 1024 colours ``apply_dithering_batch`` also speaks the video
pipeline's two transfer shapes: planar (3, B, H, W) batches in and out
(K6, K2, K3's planar layout) and the index stream, which leaves the device
as (B, H, W) palette indices (K5, or K4's index output; bit-packed up to
16 colours) where the device-to-host link is slow or
``DITHER_PIE_TPU_INDEX_TRANSFER=1`` asks for it. float32 frames reach the
scan through K7, the transposing skew. ``DITHER_PIE_TPU_DENSE_SEARCH=mxu``
or ``auto`` replaces the scan's exact palette search by the score search
for palettes of 65 to 1024 colours (outside the bit contract; ``auto`` gates
it on the first batch).

Every mode's parameter metadata is served (``get_mode_parameters``);
Riemersma and serpentine scans raise NotImplementedError naming their
ROADMAP item.
The device is explicit: ``ImageDitherer(..., device="cuda")`` (the
default) launches the kernels, ``device="cpu"`` runs their plain PyTorch
versions.
"""

from dither_pie_tpu_torch.api.ditherer import (
    AdaptiveVarianceDitherStrategy,
    BaseDitherStrategy,
    BayerDitherStrategy,
    BlueNoiseDitherStrategy,
    ColorReducer,
    DitherMode,
    DitherUtils,
    ErrorDiffusionDitherStrategy,
    ErrorDiffusionKernel,
    HalftoneDitherStrategy,
    HybridDitherStrategy,
    ImageDitherer,
    InterleavedGradientNoiseDitherStrategy,
    MatrixDitherStrategy,
    NoDitherStrategy,
    OstromoukhovDitherStrategy,
    PaletteSource,
    PerceptualDitherStrategy,
    PolkaDotDitherStrategy,
    WaveletDitherStrategy,
)
from dither_pie_tpu_torch.api.runtime import resolve_device

__all__ = [
    "AdaptiveVarianceDitherStrategy",
    "BaseDitherStrategy",
    "BayerDitherStrategy",
    "BlueNoiseDitherStrategy",
    "ColorReducer",
    "DitherMode",
    "DitherUtils",
    "ErrorDiffusionDitherStrategy",
    "ErrorDiffusionKernel",
    "HalftoneDitherStrategy",
    "HybridDitherStrategy",
    "ImageDitherer",
    "InterleavedGradientNoiseDitherStrategy",
    "MatrixDitherStrategy",
    "NoDitherStrategy",
    "OstromoukhovDitherStrategy",
    "PaletteSource",
    "PerceptualDitherStrategy",
    "PolkaDotDitherStrategy",
    "WaveletDitherStrategy",
    "resolve_device",
]

__version__ = "0.1.0"

"""dither_pie_tpu_torch — the PyTorch and CUDA port of dither_pie_tpu for an
NVIDIA H100.

The package sits beside the JAX package, which stays the reference, and
mirrors its layout (``core/palette.py``, ``ops/wavefront.py``,
``api/ditherer.py``, ...). It imports torch, numpy and PIL, never jax and
never ``dither_pie_tpu``.

It serves all 13 dither modes on NHWC uint8 batches and single images,
through hand-written Hopper kernels (``kernels/csrc``) and, for the scans
that have no wavefront, the host engine:

* the ordered family (none, Bayer 2x2/4x4/8x8/16x16/PSX, blue noise, IGN,
  polka dot; Bayer 4x4 is ``ImageDitherer()``'s default) on K4, palettes of
  up to 4096 colours;
* k-means palettes and the error-diffusion family (8 fixed-weight variants,
  Ostromoukhov, hybrid, perceptual, adaptive variance; row-major scans) on
  the wavefront kernels: K1-K3 for palettes of up to 1024 colours, K1, K8
  and K9 above;
* wavelet (DWT, randomized subband quantization and IDWT as torch ops, the
  randomized pick on K4's float32 input) and halftone (torch ops), both
  also through the u8 index stream;
* serpentine error diffusion (8 variants, Ostromoukhov) and Riemersma on
  the host engine (``native/ed_scan.cpp``, compiled with g++ at first use),
  as in the JAX package.

Above the facade sit the config-driven image pipeline
(``pipeline/image.py``) and the streaming video pipeline
(``pipeline/video.py``: ``process_frames``, ``VideoProcessor``,
``process_single_video``; ffmpeg rawvideo pipes in ``pipeline/ffio.py``),
both with regular and neural pixelization. The neural pixelizer
(``models/``: C2PGen, AliasNet and the VGG19 taps as torch modules with
the reference checkpoints' keys; ``PixelizationModel``,
``NeuralPixelizer``, ``get_neural_pixelizer``) runs on the card in
"float32" (TF32 off), "tensorfloat32" or "bfloat16", behind the JAX
package's first-batch gates.

Up to 1024 colours ``apply_dithering_batch`` also speaks the video
pipeline's two transfer shapes: planar (3, B, H, W) batches in and out
(K6, K2, K3's planar layout) and the index stream, which leaves the device
as (B, H, W) palette indices (K5, or K4's index output; bit-packed up to
16 colours) where the device-to-host link is slow or
``DITHER_PIE_TPU_INDEX_TRANSFER=1`` asks for it. float32 frames (a single
image) reach the scan through K1, as uint8 ones do. ``DITHER_PIE_TPU_DENSE_SEARCH=mxu
or ``auto`` replaces the scan's exact palette search by the score search
for palettes of 65 to 1024 colours (outside the bit contract; ``auto`` gates
it on the first batch).

Every mode's parameter metadata is served (``get_mode_parameters``).
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
    PixelizeMethod,
    PolkaDotDitherStrategy,
    RiemersmaDitherStrategy,
    WaveletDitherStrategy,
)
from dither_pie_tpu_torch.api.runtime import resolve_device
from dither_pie_tpu_torch.models.inference import PixelizationModel
from dither_pie_tpu_torch.models.pixelizer import NeuralPixelizer
from dither_pie_tpu_torch.pipeline.pixelize import get_neural_pixelizer

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
    "NeuralPixelizer",
    "NoDitherStrategy",
    "OstromoukhovDitherStrategy",
    "PaletteSource",
    "PerceptualDitherStrategy",
    "PixelizationModel",
    "PixelizeMethod",
    "PolkaDotDitherStrategy",
    "RiemersmaDitherStrategy",
    "WaveletDitherStrategy",
    "get_neural_pixelizer",
    "resolve_device",
]

__version__ = "0.1.0"

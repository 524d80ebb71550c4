"""Compatibility alias: the original application exposes everything through
a module named ``dithering_lib``; this lets ``from
dither_pie_tpu_torch.dithering_lib import ImageDitherer`` style imports
work. The names are those of the JAX package's shim: the facade, its
strategies and enums, and ``generate_blue_noise``."""

from dither_pie_tpu_torch.api.ditherer import (  # noqa: F401
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
from dither_pie_tpu_torch.core.thresholds import generate_blue_noise  # noqa: F401

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
    "PixelizeMethod",
    "PolkaDotDitherStrategy",
    "RiemersmaDitherStrategy",
    "WaveletDitherStrategy",
    "generate_blue_noise",
]

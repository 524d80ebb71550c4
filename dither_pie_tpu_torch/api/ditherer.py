"""Public dithering API of the port: enums, the error-diffusion strategy,
palette building and the ImageDitherer facade.

Mirrors ``dither_pie_tpu/api/ditherer.py`` for the slice it ports:
``ImageDitherer(dither_mode=DitherMode.ERROR_DIFFUSION)`` with
``apply_dithering``, ``apply_dithering_array`` and ``apply_dithering_batch``
(the RGB path), and ``ColorReducer``'s palettes. Frames are numpy uint8 in
and out, as in the JAX package; the work runs on the ditherer's explicit
``device`` ("cuda" by default: the hand-written kernels; "cpu": their plain
PyTorch versions). The gamma path converts frames and palette on the host
exactly as the JAX package does.
"""

from __future__ import annotations

import os
from enum import Enum
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from PIL import Image

from dither_pie_tpu_torch import convert
from dither_pie_tpu_torch.api.runtime import DeviceLike, resolve_device
from dither_pie_tpu_torch.core import colors as _colors
from dither_pie_tpu_torch.core import palette as _palette
from dither_pie_tpu_torch.ops import ed_kernels as _ed_kernels
from dither_pie_tpu_torch.ops import wavefront as _wf


class DitherMode(Enum):
    """Dithering algorithms (names are the config-file vocabulary). The
    port serves ERROR_DIFFUSION; the others raise NotImplementedError."""

    NONE = "none"
    BAYER = "bayer"
    ERROR_DIFFUSION = "error_diffusion"
    RIEMERSMA = "riemersma"
    BLUE_NOISE = "blue_noise"
    INTERLEAVED_GRADIENT_NOISE = "IGN"
    POLKA_DOT = "polka_dot"
    WAVELET = "wavelet"
    ADAPTIVE_VARIANCE = "adaptive_variance"
    PERCEPTUAL = "perceptual"
    HYBRID = "hybrid"
    HALFTONE = "halftone"
    OSTROMOUKHOV = "ostromoukhov"


class PaletteSource(Enum):
    MEDIAN_CUT = "median_cut"
    KMEANS = "kmeans"
    UNIFORM = "uniform"
    CUSTOM = "custom"
    FROM_FILE = "file"


class ErrorDiffusionKernel:
    """Named access to the classic kernel tables (see ops/ed_kernels.py)."""

    FLOYD_STEINBERG = _ed_kernels.KERNELS["floyd_steinberg"]
    JJN = _ed_kernels.KERNELS["jjn"]
    STUCKI = _ed_kernels.KERNELS["stucki"]
    BURKES = _ed_kernels.KERNELS["burkes"]
    ATKINSON = _ed_kernels.KERNELS["atkinson"]
    SIERRA = _ed_kernels.KERNELS["sierra"]
    SIERRA_TWO_ROW = _ed_kernels.KERNELS["sierra_two_row"]
    SIERRA_LITE = _ed_kernels.KERNELS["sierra_lite"]

    @classmethod
    def get_kernel(cls, name: str) -> Dict[str, Any]:
        return _ed_kernels.get_kernel(name)

    @classmethod
    def list_kernels(cls) -> List[str]:
        return list(_ed_kernels.KERNEL_NAMES)


class BaseDitherStrategy:
    """Interface: ``dither(pixels (N,3) f32, palette (P,3) f32, (h, w)) ->
    (N,3) f32`` and ``dither_batch(images (B,H,W,3), palette) -> (B,H,W,3)
    uint8``; parameter metadata drives settings UIs and the CLI."""

    def dither(self, pixels: np.ndarray, palette_arr: np.ndarray,
               image_size: Tuple[int, int]) -> np.ndarray:
        raise NotImplementedError

    def dither_batch(self, images: np.ndarray, palette_arr: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    @staticmethod
    def get_parameter_info() -> Optional[Dict[str, Any]]:
        return None

    def get_current_parameters(self) -> Dict[str, Any]:
        return {}


class ErrorDiffusionDitherStrategy(BaseDitherStrategy):
    """Unified 8-variant fixed-weight error diffusion on the wavefront
    kernels of ``device``."""

    @staticmethod
    def get_parameter_info() -> Dict[str, Any]:
        return {
            "variant": {
                "type": "choice",
                "default": "atkinson",
                "choices": ErrorDiffusionKernel.list_kernels(),
                "label": "Algorithm",
                "description": "Error diffusion algorithm variant",
            },
            "serpentine": {
                "type": "choice",
                "default": "false",
                "choices": ["true", "false"],
                "label": "Serpentine Scan",
                "description": "Alternates direction each row to reduce artifacts",
            },
        }

    def __init__(self, variant: str = "atkinson", serpentine: str = "false",
                 device: DeviceLike = "cuda"):
        if serpentine == "true":
            # A reversed row depends on the LAST pixel of the row above, so
            # no wavefront exists; the JAX package runs it on its host
            # engine, which the port does not bind yet.
            raise NotImplementedError(
                "serpentine error diffusion is not ported yet (ROADMAP A5)")
        self.variant = variant
        self.device = resolve_device(device)

    def get_current_parameters(self) -> Dict[str, Any]:
        return {"variant": self.variant, "serpentine": "false"}

    def _palette(self, palette_arr) -> torch.Tensor:
        pal = _palette.as_palette_array([tuple(c) for c in np.asarray(palette_arr)])
        return convert.palette_to_torch(pal, self.device)

    def dither(self, pixels, palette_arr, image_size):
        h, w = image_size
        img = np.asarray(pixels, dtype=np.float32).reshape(h, w, 3)
        out = _wf.ed_fixed_wavefront(torch.from_numpy(img).to(self.device),
                                     self._palette(palette_arr), self.variant)
        return out.cpu().numpy().astype(np.float32).reshape(-1, 3)

    def dither_batch(self, images, palette_arr):
        arr = np.asarray(images)
        if arr.dtype != np.uint8:
            arr = arr.astype(np.float32)
        frames = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
        out = _wf.ed_batch_wavefront(frames, self._palette(palette_arr),
                                     "fixed", self.variant)
        return out.cpu().numpy()


class ColorReducer:
    """Palette building: median-cut (host), k-means (device), uniform cube."""

    @staticmethod
    def find_dominant_channel(colors: List[Tuple[int, int, int]]) -> int:
        return _palette._dominant_channel(colors)

    @staticmethod
    def median_cut(colors: List[Tuple[int, int, int]], depth: int) -> List[Tuple[int, int, int]]:
        return _palette._median_cut(colors, depth)

    @staticmethod
    def reduce_colors(image: Image.Image, num_colors: int) -> List[Tuple[int, int, int]]:
        arr = np.array(image.convert("RGB"), dtype=np.uint8)
        return _palette.median_cut_palette(arr, num_colors)

    @staticmethod
    def generate_kmeans_palette(img: Image.Image, num_colors: int,
                                random_state=42,
                                device: DeviceLike = "cuda") -> List[Tuple[int, int, int]]:
        arr = np.array(img.convert("RGB"), dtype=np.uint8)
        return _palette.kmeans_palette(arr, num_colors, random_state=random_state,
                                       device=device)

    @staticmethod
    def generate_uniform_palette(num_colors: int) -> List[Tuple[int, int, int]]:
        return _palette.uniform_palette(num_colors)


_STRATEGY_CLASSES = {
    DitherMode.ERROR_DIFFUSION: ErrorDiffusionDitherStrategy,
}

# Where each mode that the port does not serve yet sits in ROADMAP Queue A.
_NOT_PORTED = {
    DitherMode.NONE: "A4",
    DitherMode.BAYER: "A4",
    DitherMode.BLUE_NOISE: "A4",
    DitherMode.INTERLEAVED_GRADIENT_NOISE: "A4",
    DitherMode.POLKA_DOT: "A4",
    DitherMode.RIEMERSMA: "A5",
    DitherMode.ADAPTIVE_VARIANCE: "A5",
    DitherMode.PERCEPTUAL: "A5",
    DitherMode.HYBRID: "A5",
    DitherMode.OSTROMOUKHOV: "A5",
    DitherMode.WAVELET: "A7",
    DitherMode.HALFTONE: "A7",
}


class ImageDitherer:
    """Orchestrates palette building plus dithering with a chosen strategy.

    Keeps the reference's behavioural quirks: the gamma path quantizes to
    8-bit *linear* before dithering (and converts the palette the same way),
    and ``apply_dithering`` caches an auto-generated palette on the
    instance. ``device`` is explicit: "cuda" (default) or "cpu"; CUDA on a
    machine without a GPU raises here.
    """

    def __init__(self,
                 num_colors: int = 16,
                 dither_mode: Optional[DitherMode] = DitherMode.BAYER,
                 palette: Optional[List[Tuple[int, int, int]]] = None,
                 use_gamma: bool = False,
                 dither_params: Optional[Dict[str, Any]] = None,
                 device: DeviceLike = "cuda"):
        self.num_colors = num_colors
        self.dither_mode = dither_mode
        self.palette = palette
        self.use_gamma = use_gamma
        self.dither_params = dither_params or {}
        self.device = resolve_device(device)
        if os.environ.get("DITHER_PIE_TPU_AUTO_MESH") == "1":
            # The JAX package's switch for sharding batches over every local
            # device; the port runs on the one device it is given.
            raise NotImplementedError(
                "DITHER_PIE_TPU_AUTO_MESH=1: multi-GPU sharding is not ported "
                "yet (ROADMAP A11)")

    def _get_dither_strategy(self, mode: DitherMode) -> BaseDitherStrategy:
        strategy_class = _STRATEGY_CLASSES.get(mode)
        if strategy_class is None:
            if mode in _NOT_PORTED:
                raise NotImplementedError(
                    f"dither mode {mode.value!r} is not ported yet "
                    f"(ROADMAP {_NOT_PORTED[mode]})")
            raise ValueError(f"Unrecognized DitherMode: {mode}")
        settings = {key: info["default"]
                    for key, info in strategy_class.get_parameter_info().items()}
        settings.update(self.dither_params)
        return strategy_class(**settings, device=self.device)

    def apply_dithering_array(self, arr_srgb_8: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8 in, (H, W, 3) uint8 out. Core of apply_dithering."""
        if self.use_gamma:
            arr_01 = arr_srgb_8.astype(np.float32) / 255.0
            arr_lin_01 = _colors.srgb_to_linear_np(arr_01)
            # Reference quirk: quantizes the LINEAR image to 8 bits before
            # dithering.
            arr_for_dith = np.clip(arr_lin_01 * 255.0, 0, 255).astype(np.uint8)
            if self.palette is None:
                self.palette = _palette.median_cut_palette(arr_for_dith, self.num_colors)
        else:
            if self.palette is None:
                self.palette = _palette.median_cut_palette(arr_srgb_8, self.num_colors)
            arr_for_dith = arr_srgb_8

        palette_arr = self._palette_for_dither()
        h, w, _ = arr_for_dith.shape
        flat_pixels = arr_for_dith.reshape(-1, 3).astype(np.float32)

        strategy = self._get_dither_strategy(self.dither_mode or DitherMode.NONE)
        dithered_flat = strategy.dither(flat_pixels, palette_arr, (h, w))
        return self._from_dither(dithered_flat.reshape(h, w, 3).astype(np.uint8))

    def apply_dithering_batch(self, arrs_srgb_8: np.ndarray,
                              planar: bool = False) -> np.ndarray:
        """Batched device path: (B, H, W, 3) uint8 -> (B, H, W, 3) uint8.

        Requires an explicit palette (the video pipeline computes one from
        the first frame, matching reference semantics)."""
        if planar:
            raise NotImplementedError(
                "planar (3, B, H, W) batches are not ported yet (ROADMAP A5)")
        if self.palette is None:
            raise ValueError("apply_dithering_batch requires a palette; "
                             "compute one from the first frame first")
        if self.use_gamma:
            lin = _colors.srgb_to_linear_np(arrs_srgb_8.astype(np.float32) / 255.0)
            work = np.clip(lin * 255.0, 0, 255).astype(np.uint8)
        else:
            work = arrs_srgb_8
        palette_arr = self._palette_for_dither()
        strategy = self._get_dither_strategy(self.dither_mode or DitherMode.NONE)
        out = strategy.dither_batch(work, palette_arr)
        return self._from_dither(out.astype(np.uint8))

    def apply_dithering(self, image: Image.Image) -> Image.Image:
        arr = np.array(image.convert("RGB"), dtype=np.uint8)
        return Image.fromarray(self.apply_dithering_array(arr), "RGB")

    def _palette_for_dither(self) -> np.ndarray:
        """(P, 3) float32 palette; linearised (not rounded) on the gamma
        path."""
        palette_arr = np.array(self.palette, dtype=np.float32)
        if self.use_gamma:
            pal_lin = _colors.srgb_to_linear_np(palette_arr / 255.0)
            palette_arr = np.clip(pal_lin * 255.0, 0, 255).astype(np.float32)
        return palette_arr

    def _from_dither(self, out8: np.ndarray) -> np.ndarray:
        """Dithered uint8 back to sRGB on the gamma path."""
        if self.use_gamma:
            out_lin_01 = out8.astype(np.float32) / 255.0
            out_srgb_01 = _colors.linear_to_srgb_np(np.clip(out_lin_01, 0, 1))
            out8 = np.clip(out_srgb_01 * 255.0, 0, 255).astype(np.uint8)
        return out8

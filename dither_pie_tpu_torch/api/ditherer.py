"""Public dithering API of the port: enums, the ordered and
error-diffusion strategies, palette building and the ImageDitherer facade.

Mirrors ``dither_pie_tpu/api/ditherer.py`` for all 13 modes: NONE,
BAYER (the default), BLUE_NOISE, INTERLEAVED_GRADIENT_NOISE and POLKA_DOT
on the ordered kernel K4, ERROR_DIFFUSION, OSTROMOUKHOV, HYBRID,
PERCEPTUAL and ADAPTIVE_VARIANCE on the wavefront kernels (K1-K3 for
palettes of up to 1024 colours, K1, K8 and K9 above), WAVELET (torch ops
for the transform and the subband quantiser, K4 on the float32
reconstruction for the pick) and HALFTONE (torch ops); the scans with no
wavefront, serpentine ERROR_DIFFUSION and OSTROMOUKHOV and RIEMERSMA, on
the host engine (``ops/ed_host.py``: the float64 engine for a single
image, the float32 twins for a batch, one thread a frame, at most
``DITHER_PIE_TPU_NATIVE_THREADS``), as the JAX package runs them; ``ImageDitherer``
with ``apply_dithering``,
``apply_dithering_array`` and ``apply_dithering_batch``;
``ColorReducer``'s palettes; and every mode's parameter metadata. Frames
are numpy uint8 in and out, as in the JAX package; the work runs on the
ditherer's explicit ``device`` ("cuda" by default: the hand-written
kernels; "cpu": their plain PyTorch versions). The gamma path converts
frames and palette on the host exactly as the JAX package does.

``apply_dithering_batch`` talks to the video pipeline in the JAX
package's two transfer shapes: ``planar=True`` takes and returns
(3, B, H, W) planes (the error-diffusion strategies, K6 -> K2 -> K3's
planar layout), and on a slow device-to-host link (``api/linkspeed.py``)
the batch leaves the device as palette indices (K4's index output, or K5's
stream; bit-packed up to 16 colours, ``ops/idxpack.py``) and one exact
palette gather on the host rebuilds the colours. Nothing falls back: a
failing index path raises.

``DITHER_PIE_TPU_DENSE_SEARCH`` picks the error-diffusion scan's palette
search for palettes of 65 to 1024 colours: ``exact`` (the default, the bit
contract with the golden engine), ``mxu`` (the score search: near ties may
flip) or ``auto`` (batches run both on the first call and keep the score
search only if its output matches the exact one perceptually; single images
stay exact). It is read here; the entry points in ``ops/`` take an argument.

``DITHER_PIE_TPU_RIEMERSMA=scan``, read at each call as in the JAX
package, runs RIEMERSMA on the ditherer's device through the scan R1
(``ops/riemersma_scan.py``) instead of the host engine; unset or any other
value keeps the host engine.

With more than one local device (or ``DITHER_PIE_TPU_AUTO_MESH=1``; ``=0``
turns it off) ``apply_dithering_batch`` shards the batch over every local
device, as the JAX package does (``parallel/auto.py``): the ordered family,
the wavefront ED modes on NHWC colours, wavelet and halftone, bit for bit
the single-device output. Where the mesh can serve a batch it wins over the
index stream, unless ``DITHER_PIE_TPU_INDEX_TRANSFER=1`` forces the stream
or the batch is planar.
"""

from __future__ import annotations

import os
from enum import Enum
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from PIL import Image

from dither_pie_tpu_torch import convert
from dither_pie_tpu_torch.api import linkspeed as _linkspeed
from dither_pie_tpu_torch.api import transfer as _transfer
from dither_pie_tpu_torch.api.profiling import count, stage
from dither_pie_tpu_torch.api.runtime import DeviceLike, resolve_device
from dither_pie_tpu_torch.core import colors as _colors
from dither_pie_tpu_torch.core import palette as _palette
from dither_pie_tpu_torch.core import thresholds as _thresholds
from dither_pie_tpu_torch.ops import adaptive as _adaptive
from dither_pie_tpu_torch.ops import ed_host as _ed_host
from dither_pie_tpu_torch.ops import ed_kernels as _ed_kernels
from dither_pie_tpu_torch.ops import halftone as _halftone
from dither_pie_tpu_torch.ops import idxpack as _idxpack
from dither_pie_tpu_torch.ops import ordered as _ordered
from dither_pie_tpu_torch.ops import riemersma_scan as _riemersma_scan
from dither_pie_tpu_torch.ops import wavefront as _wf
from dither_pie_tpu_torch.ops import wavelet as _wavelet
from dither_pie_tpu_torch.parallel import auto as _auto
from dither_pie_tpu_torch.parallel import sharding as _sharding


class DitherMode(Enum):
    """Dithering algorithms (names are the config-file vocabulary)."""

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


class PixelizeMethod(Enum):
    NONE = "none"
    REGULAR = "regular"
    NEURAL = "neural"


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


class DitherUtils:
    """Threshold matrices + gamma transfer helpers (host-side NumPy)."""

    BAYER2x2 = _thresholds.BAYER2x2
    BAYER4x4 = _thresholds.BAYER4x4
    BAYER8x8 = _thresholds.BAYER8x8
    BAYER16x16 = _thresholds.BAYER16x16
    PSX4x4 = _thresholds.PSX4x4

    @staticmethod
    def get_threshold_matrix(mode: DitherMode, size: str = "4x4") -> np.ndarray:
        if mode == DitherMode.NONE:
            return np.ones((1, 1), dtype=np.float32)
        elif mode == DitherMode.BAYER:
            return _thresholds.bayer_matrix(size)
        raise ValueError(f"Unsupported matrix mode: {mode}")

    @staticmethod
    def srgb_to_linear(c: np.ndarray) -> np.ndarray:
        return _colors.srgb_to_linear_np(c)

    @staticmethod
    def linear_to_srgb(c: np.ndarray) -> np.ndarray:
        return _colors.linear_to_srgb_np(c)


class BaseDitherStrategy:
    """Interface: ``dither(pixels (N,3) f32, palette (P,3) f32, (h, w)) ->
    (N,3) f32`` and ``dither_batch(images (B,H,W,3), palette) -> (B,H,W,3)
    uint8``; parameter metadata drives settings UIs and the CLI. A strategy
    with a planar path adds ``dither_batch_planar(planes (3,B,H,W),
    palette) -> (3,B,H,W) uint8``; the facade asks with ``hasattr``."""

    def dither(self, pixels: np.ndarray, palette_arr: np.ndarray,
               image_size: Tuple[int, int]) -> np.ndarray:
        raise NotImplementedError

    def dither_batch(self, images: np.ndarray, palette_arr: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def dither_batch_indices(self, images: np.ndarray, palette_arr: np.ndarray,
                             planar: bool = False) -> Optional[np.ndarray]:
        """Host (B, H, W) palette indices whose ``palette.astype(uint8)[idx]``
        is ``dither_batch``'s output, or ``None`` where the strategy has no
        index output for this batch."""
        return None

    @staticmethod
    def get_parameter_info() -> Optional[Dict[str, Any]]:
        return None

    def get_current_parameters(self) -> Dict[str, Any]:
        return {}


def _palette_array(palette_arr) -> np.ndarray:
    """(P, 3) float32 host palette, a singleton padded by duplicating its
    colour (as the JAX package's ``as_palette_array``)."""
    return _palette.as_palette_array([tuple(c) for c in np.asarray(palette_arr)])


def _palette_tensor(palette_arr, device: torch.device) -> torch.Tensor:
    """``_palette_array`` on ``device``."""
    return convert.palette_to_torch(_palette_array(palette_arr), device)


def _one_frame_as_batch(dither_batch, pixels, palette_arr, image_size,
                        dtype) -> np.ndarray:
    """``dither`` through ``dither_batch``: the (N, 3) pixels as one (1, H,
    W, 3) frame of ``dtype``, the output back as (N, 3) float32."""
    h, w = image_size
    with stage("facade.host_in"):
        img = np.asarray(pixels).astype(dtype, copy=False).reshape(1, h, w, 3)
    out = dither_batch(img, palette_arr)
    with stage("facade.host_out"):
        return out.astype(np.float32).reshape(-1, 3)


def _frames_tensor(images, device: torch.device) -> torch.Tensor:
    """(B, H, W, 3) frames on ``device``: uint8 stays uint8, anything else
    becomes float32 (a host copy, float32 frames included)."""
    with stage("facade.host_in"):
        frames = np.ascontiguousarray(_sharding.host_frames(images))
    return _transfer.to_device(frames, device)


class _ScreenDitherStrategy(BaseDitherStrategy):
    """Ordered dithering against an (H, W) screen on ``self.device``: every
    frame goes through K4 (its plain version on the CPU)."""

    device: torch.device

    def _screen(self, h: int, w: int) -> torch.Tensor:
        raise NotImplementedError

    def dither(self, pixels, palette_arr, image_size):
        # The pixels are integer-valued (8-bit sRGB or 8-bit linear): cast
        # to uint8 here so the card gets a quarter of the bytes.
        return _one_frame_as_batch(self.dither_batch, pixels, palette_arr, image_size,
                                   np.uint8)

    def dither_batch(self, images, palette_arr):
        _, h, w, _ = np.shape(images)
        pal, screen = _palette_tensor(palette_arr, self.device), self._screen(h, w)
        out = _auto.maybe_sharded_ordered(images, pal, screen, self.device)
        if out is not None:
            return out
        frames = _frames_tensor(images, self.device)
        return _transfer.to_host(_ordered.dispatch_ordered_batch(frames, pal, screen))

    def dither_batch_indices(self, images, palette_arr, planar=False):
        """Host (B, H, W) uint8 palette indices from K4's index output, or
        ``None`` for planar batches and more than 256 colours. Palettes of
        up to 16 colours cross the link bit-packed."""
        if planar or len(palette_arr) > 256:
            return None
        _, h, w, _ = np.shape(images)
        pal = _palette_tensor(palette_arr, self.device)
        idx = _ordered.dispatch_ordered_batch(
            _frames_tensor(images, self.device), pal, self._screen(h, w),
            return_indices=True)
        return _idxpack.packed_transfer(idx, pal.shape[0], w)


class NoDitherStrategy(_ScreenDitherStrategy):
    """Nearest palette colour per pixel (argmin over exact distances)."""

    def __init__(self, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)

    def _screen(self, h: int, w: int) -> torch.Tensor:
        # Nearest colour IS an ordered dither with a saturated screen: the
        # factor d1/(d1+d2) is at most 0.5, so screen = 1 always picks the
        # nearest (lowest index on ties, as the JAX package's
        # map_to_palette), and single images and batches both run on K4
        # without an (N, P) distance matrix.
        return torch.ones((h, w), dtype=torch.float32, device=self.device)


class MatrixDitherStrategy(_ScreenDitherStrategy):
    """Distance-ratio ordered dithering against a tiled threshold matrix.

    Note: this is the reference's distance-ratio form (factor = d1^2 /
    (d1^2 + d2^2) compared against the screen), not the textbook
    add-threshold-then-quantize form; reproducing it is required for output
    parity.
    """

    def __init__(self, threshold_matrix: np.ndarray, device: DeviceLike = "cuda"):
        self.threshold_matrix = np.asarray(threshold_matrix, dtype=np.float32)
        self.device = resolve_device(device)

    def _screen(self, h: int, w: int) -> torch.Tensor:
        return _ordered.screen_for_matrix(self.threshold_matrix, h, w, self.device)


class BayerDitherStrategy(MatrixDitherStrategy):
    """Bayer ordered dithering with configurable matrix size."""

    @staticmethod
    def get_parameter_info() -> Dict[str, Any]:
        return {
            "size": {
                "type": "choice",
                "default": "4x4",
                "choices": ["2x2", "4x4", "8x8", "16x16", "psx4x4"],
                "label": "Matrix",
                "description": "Bayer matrix size or PSX 4x4 variant (larger = finer patterns)",
            }
        }

    def __init__(self, size: str = "4x4", device: DeviceLike = "cuda"):
        self.size = size
        super().__init__(_thresholds.bayer_matrix(size), device)

    def get_current_parameters(self) -> Dict[str, Any]:
        return {"size": self.size}


class BlueNoiseDitherStrategy(MatrixDitherStrategy):
    """Blue-noise ordered dithering (cached generated matrices)."""

    _cache = _thresholds._BLUE_NOISE_CACHE  # shared per-process cache

    @staticmethod
    def get_parameter_info() -> Dict[str, Any]:
        return {
            "size": {
                "type": "int",
                "default": 64,
                "min": 32,
                "max": 128,
                "label": "Matrix Size",
                "description": "Size of the blue noise matrix (larger = more detail but slower)",
            },
            "seed": {
                "type": "int",
                "default": 42,
                "min": 0,
                "max": 9999,
                "label": "Random Seed",
                "description": "Seed for noise generation (different seeds = different patterns)",
            },
        }

    def __init__(self, size: int = 64, seed: int = 42, device: DeviceLike = "cuda"):
        self.size = int(size)
        self.seed = int(seed)
        super().__init__(_thresholds.blue_noise_cached(self.size, self.seed), device)

    def get_current_parameters(self) -> Dict[str, Any]:
        return {"size": self.size, "seed": self.seed}


class InterleavedGradientNoiseDitherStrategy(_ScreenDitherStrategy):
    """IGN per-pixel threshold dithering (computed screen, no tile)."""

    @staticmethod
    def get_parameter_info() -> Dict[str, Any]:
        return {
            "scale": {
                "type": "float",
                "default": 1.0,
                "min": 0.1,
                "max": 10.0,
                "step": 0.1,
                "label": "Scale",
                "description": "Noise frequency (lower = larger pattern, higher = finer grain)",
            },
            "seed": {
                "type": "int",
                "default": 0,
                "min": 0,
                "max": 9999,
                "label": "Seed",
                "description": "Deterministic offset to shift the pattern",
            },
        }

    def __init__(self, scale: float = 1.0, seed: int = 0, device: DeviceLike = "cuda"):
        self.scale = float(scale)
        self.seed = int(seed)
        self.device = resolve_device(device)

    def _screen(self, h: int, w: int) -> torch.Tensor:
        return _thresholds.ign_thresholds(h, w, self.scale, self.seed, self.device)

    def get_current_parameters(self) -> Dict[str, Any]:
        return {"scale": self.scale, "seed": self.seed}


class PolkaDotDitherStrategy(MatrixDitherStrategy):
    """Polka-dot radial threshold tiles."""

    @staticmethod
    def get_parameter_info() -> Dict[str, Any]:
        return {
            "tile_size": {
                "type": "int",
                "default": 8,
                "min": 4,
                "max": 32,
                "label": "Tile Size",
                "description": "Size of the repeating dot pattern",
            },
            "gamma": {
                "type": "float",
                "default": 1.5,
                "min": 0.5,
                "max": 3.0,
                "step": 0.1,
                "label": "Gamma",
                "description": "Controls dot shape curve (higher = sharper edges)",
            },
        }

    def __init__(self, tile_size: int = 8, gamma: float = 1.5, device: DeviceLike = "cuda"):
        self.tile_size = int(tile_size)
        self.gamma = float(gamma)
        super().__init__(_thresholds.polka_dot_matrix(self.tile_size, self.gamma), device)

    def get_current_parameters(self) -> Dict[str, Any]:
        return {"tile_size": self.tile_size, "gamma": self.gamma}


_DENSE_SEARCH_VALUES = ("exact", "mxu", "auto")


def _dense_search_mode() -> str:
    """DITHER_PIE_TPU_DENSE_SEARCH: "exact" (default), "mxu" or "auto"."""
    value = os.environ.get("DITHER_PIE_TPU_DENSE_SEARCH", "exact")
    if value not in _DENSE_SEARCH_VALUES:
        raise ValueError(f"DITHER_PIE_TPU_DENSE_SEARCH must be one of "
                         f"{_DENSE_SEARCH_VALUES}, got {value!r}")
    return value


def _serpentine_choice() -> Dict[str, Any]:
    return {
        "type": "choice",
        "default": "false",
        "choices": ["true", "false"],
        "label": "Serpentine Scan",
        "description": "Alternates direction each row to reduce artifacts",
    }


def _native_thread_cap() -> int:
    """Worker cap of the threaded host-engine frame map: every core (the
    ctypes calls release the GIL for the whole scan), or
    DITHER_PIE_TPU_NATIVE_THREADS."""
    env = os.environ.get("DITHER_PIE_TPU_NATIVE_THREADS")
    if env:
        return max(1, int(env))
    return max(1, os.cpu_count() or 1)


def _host_frame(pixels, palette_arr, image_size):
    """A single image for the host engine: the (H, W, 3) float32 frame and
    the (P, 3) float32 palette."""
    h, w = image_size
    img = np.asarray(pixels, dtype=np.float32).reshape(h, w, 3)
    return img, _palette_array(palette_arr)


def _host_batch(scan, images, palette_arr) -> np.ndarray:
    """A (B, H, W, 3) batch through ``scan(frame f32, palette)`` on the
    host engine, one thread a frame (the ctypes calls release the GIL).
    The output has the input's dtype: uint8 frames in, the float32 results
    truncated into it, as in the JAX package."""
    from concurrent.futures import ThreadPoolExecutor

    pal = _palette_array(palette_arr)
    images = np.asarray(images)
    out = np.empty_like(images)
    with ThreadPoolExecutor(max_workers=min(_native_thread_cap(), len(images))) as ex:
        for i, res in enumerate(ex.map(lambda im: scan(im.astype(np.float32), pal), images)):
            out[i] = res
    return out


class _WavefrontDitherStrategy(BaseDitherStrategy):
    """Error diffusion of one wavefront mode on ``self.device``: single
    images go to the card as one float32 frame, batches as they are,
    (B, H, W, 3) or planar (3, B, H, W).

    A serpentine scan has no wavefront: it runs on the host engine, as in
    the JAX package, and never moves a frame to the device. A single image
    takes the float64 engine (``_host_scan(..., exact=True)``), a batch the
    float32 twin, one thread a frame; it has no planar and no index
    output."""

    device: torch.device
    mode: str
    serpentine = False

    def _host_scan(self, work: np.ndarray, pal: np.ndarray, exact: bool) -> np.ndarray:
        """One float32 (H, W, 3) frame through the host engine's serpentine
        scan of this mode."""
        raise NotImplementedError

    def _mode_args(self, images: np.ndarray, planar: bool = False) -> Dict[str, Any]:
        """Keyword arguments of ``ed_batch_wavefront`` beyond the mode and
        the layout, for a (B, H, W, 3) or planar (3, B, H, W) numpy batch;
        an ``aux`` stream stays a host array here."""
        return {}

    def _on_device(self, images, palette_arr, planar: bool = False,
                   return_indices: bool = False, gate: bool = True,
                   args: Optional[Dict[str, Any]] = None):
        """One batch through ``ed_batch_wavefront`` with the environment's
        dense search; without ``gate``, "auto" means "exact". Returns the
        output and the palette tensor it ran with. The gate is keyed by the
        host palette's bytes, so a decided batch reads nothing back.
        ``args``: ``_mode_args`` of this batch, where the caller has them."""
        images = np.asarray(images)
        pal = _palette_tensor(palette_arr, self.device)
        args = dict(self._mode_args(images, planar) if args is None else args)
        if args.get("aux") is not None:
            args["aux"] = torch.from_numpy(args["aux"]).to(self.device).to(torch.float32)
        dense_search = _dense_search_mode()
        if dense_search == "auto" and not gate:
            dense_search = "exact"
        palette_key = None
        if dense_search == "auto":
            palette_key = np.asarray(palette_arr, dtype=np.float32).tobytes()
        frames = _frames_tensor(images, self.device)
        with stage("ops.ed_dispatch"):
            out = _wf.ed_batch_wavefront(
                frames, pal, self.mode, planar=planar, return_indices=return_indices,
                dense_search=dense_search, palette_key=palette_key, **args)
        return out, pal

    def dither(self, pixels, palette_arr, image_size):
        if self.serpentine:
            img, pal = _host_frame(pixels, palette_arr, image_size)
            return self._host_scan(img, pal, exact=True).reshape(-1, 3)
        # One float32 frame; as in the JAX package a single image never
        # enters the first-batch gate.
        h, w = image_size
        with stage("facade.host_in"):
            img = np.asarray(pixels, dtype=np.float32).reshape(1, h, w, 3)
        out = _transfer.to_host(self._on_device(img, palette_arr, gate=False)[0])
        with stage("facade.host_out"):
            return out[0].astype(np.float32).reshape(-1, 3)

    def dither_batch(self, images, palette_arr):
        if self.serpentine:
            return _host_batch(lambda im, pal: self._host_scan(im, pal, exact=False),
                               images, palette_arr)
        # NHWC colours shard over the local mesh where it is on (the JAX
        # package's rule: never planar, never the index stream).
        images = np.asarray(images)
        args = self._mode_args(images)
        out = _auto.maybe_sharded_ed(images, _palette_array(palette_arr), mode=self.mode,
                                     dense_search=_dense_search_mode(), device=self.device,
                                     **args)
        if out is not None:
            return out
        return _transfer.to_host(self._on_device(images, palette_arr, args=args)[0])

    def dither_batch_planar(self, planes, palette_arr):
        """(3, B, H, W) channel-major planes in, planes out: the layout of
        the video pipeline's zero-copy flow (the wavefront kernels only)."""
        if self.serpentine:
            raise RuntimeError("planar batches require the wavefront kernels, and a "
                               "serpentine scan has none: ask supports_planar_batch() first")
        return _transfer.to_host(self._on_device(planes, palette_arr, planar=True)[0])

    def dither_batch_indices(self, images, palette_arr, planar=False):
        """Host (B, H, W) palette indices, uint8 up to 256 colours and
        uint16 up to 1024: a third (two thirds) of the RGB path's
        device-to-host bytes, less when bit-packed (up to 16 colours).
        ``None`` above ``PACKED_PALETTE_MAX`` colours and for a serpentine
        scan."""
        if self.serpentine or len(palette_arr) > _wf.PACKED_PALETTE_MAX:
            return None
        idx, pal = self._on_device(images, palette_arr, planar, return_indices=True)
        return _idxpack.packed_transfer(idx, pal.shape[0], idx.shape[2])


class ErrorDiffusionDitherStrategy(_WavefrontDitherStrategy):
    """Unified 8-variant fixed-weight error diffusion on the wavefront
    kernels of ``device``; serpentine on the host engine."""

    mode = "fixed"

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
            "serpentine": _serpentine_choice(),
        }

    def __init__(self, variant: str = "atkinson", serpentine: str = "false",
                 device: DeviceLike = "cuda"):
        self.variant = variant
        self.serpentine = serpentine == "true"
        self.device = resolve_device(device)

    def get_current_parameters(self) -> Dict[str, Any]:
        return {"variant": self.variant,
                "serpentine": "true" if self.serpentine else "false"}

    def _mode_args(self, images, planar=False):
        return {"variant": self.variant}

    def _host_scan(self, work, pal, exact):
        scan = _ed_host.ed_fixed if exact else _ed_host.ed_fixed_fast
        return scan(work, pal, self.variant, True)


class OstromoukhovDitherStrategy(_WavefrontDitherStrategy):
    """Ostromoukhov variable-coefficient error diffusion (SIGGRAPH 2001)."""

    COEFFS_TABLE = _ed_kernels.OSTROMOUKHOV_TABLE
    mode = "ostromoukhov"

    @staticmethod
    def get_parameter_info() -> Dict[str, Any]:
        return {"serpentine": _serpentine_choice()}

    def __init__(self, serpentine: str = "false", device: DeviceLike = "cuda"):
        self.serpentine = serpentine == "true"
        self.device = resolve_device(device)

    def get_current_parameters(self) -> Dict[str, Any]:
        return {"serpentine": "true" if self.serpentine else "false"}

    def _host_scan(self, work, pal, exact):
        scan = _ed_host.ed_ostromoukhov if exact else _ed_host.ed_ostromoukhov_fast
        return scan(work, pal, True)


class HybridDitherStrategy(_WavefrontDitherStrategy):
    """Luminance/chroma-split Floyd-Steinberg diffusion."""

    mode = "hybrid"

    @staticmethod
    def get_parameter_info() -> Dict[str, Any]:
        return {
            "lum_factor": {
                "type": "float",
                "default": 1.0,
                "min": 0.0,
                "max": 2.0,
                "step": 0.1,
                "label": "Luminance Factor",
                "description": "Strength of luminance error diffusion (1.0 = full, 0.0 = none)",
            },
            "col_factor": {
                "type": "float",
                "default": 0.2,
                "min": 0.0,
                "max": 2.0,
                "step": 0.1,
                "label": "Color Factor",
                "description": "Strength of color error diffusion (lower = less color noise)",
            },
        }

    def __init__(self, lum_factor: float = 1.0, col_factor: float = 0.2,
                 device: DeviceLike = "cuda"):
        self.lum_factor = float(lum_factor)
        self.col_factor = float(col_factor)
        self.device = resolve_device(device)

    def get_current_parameters(self) -> Dict[str, Any]:
        return {"lum_factor": self.lum_factor, "col_factor": self.col_factor}

    def _mode_args(self, images, planar=False):
        return {"lum_factor": self.lum_factor, "col_factor": self.col_factor}


class PerceptualDitherStrategy(_WavefrontDitherStrategy):
    """FS diffusion with luminance-scaled error weights (no parameters);
    the sensitivity map is built on the device from the frames."""

    mode = "perceptual"

    def __init__(self, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)


class AdaptiveVarianceDitherStrategy(_WavefrontDitherStrategy):
    """FS diffusion gated by local grayscale variance. The gates are
    computed on the host (scipy's uniform filter), as the JAX package
    computes them, and go to the device as one byte per pixel."""

    mode = "adaptive"

    @staticmethod
    def get_parameter_info() -> Dict[str, Any]:
        return {
            "var_threshold": {
                "type": "float",
                "default": 300.0,
                "min": 0.0,
                "max": 1000.0,
                "step": 10.0,
                "label": "Variance Threshold",
                "description": "Threshold for local variance to trigger error diffusion",
            },
            "window_radius": {
                "type": "int",
                "default": 1,
                "min": 1,
                "max": 5,
                "label": "Window Radius",
                "description": "Radius of window for computing local variance",
            },
        }

    def __init__(self, var_threshold: float = 300.0, window_radius: int = 1,
                 device: DeviceLike = "cuda"):
        self.var_threshold = float(var_threshold)
        self.window_radius = int(window_radius)
        self.device = resolve_device(device)

    def get_current_parameters(self) -> Dict[str, Any]:
        return {"var_threshold": self.var_threshold, "window_radius": self.window_radius}

    def _gates(self, images: np.ndarray, planar: bool = False) -> np.ndarray:
        """(B, H, W) bool: where the local variance reaches the threshold;
        ``images`` is (B, H, W, 3), or with ``planar`` (3, B, H, W)."""
        r, g, b = images if planar else np.moveaxis(images, -1, 0)
        gray = np.float32(0.299) * r + np.float32(0.587) * g + np.float32(0.114) * b
        return np.stack([
            _adaptive.variance_map_np(g, self.window_radius) >= self.var_threshold
            for g in gray])

    def _mode_args(self, images, planar=False):
        # One byte a pixel crosses to the device; float32 there.
        return {"aux": self._gates(images, planar).astype(np.uint8)}


class RiemersmaDitherStrategy(BaseDitherStrategy):
    """Error diffusion along a Hilbert curve: one dependency chain through
    the frame (no parameters, as the reference). By default it runs on the
    host engine, as in the JAX package: a single image on the float64
    engine, a batch on the float32 twin, one thread a frame, and no frame
    moves to ``device``. ``DITHER_PIE_TPU_RIEMERSMA=scan``, read at each
    call, runs the scan instead, bitwise the float32 twin's output up to
    4096 colours, as uint8 colours: on a CUDA device R1
    (``ops/riemersma_scan.py``), a single image as a batch of one; on a CPU
    device the float32 twin itself up to its ``F32_TWIN_MAX_PAL`` colours
    (the same bits, where the JAX package runs its compiled ``lax.scan``),
    and the scan's plain loop above them. The default is the JAX
    package's, which chose the host on a TPU measurement; the switch is
    there to measure the scan (``tools/riemersma_ab.py``)."""

    def __init__(self, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)

    def _twin_route(self, pal: np.ndarray) -> bool:
        """The switch's CPU route: the float32 twin where it serves."""
        return self.device.type == "cpu" and pal.shape[0] <= _ed_host.F32_TWIN_MAX_PAL

    def dither(self, pixels, palette_arr, image_size):
        img, pal = _host_frame(pixels, palette_arr, image_size)
        if os.environ.get("DITHER_PIE_TPU_RIEMERSMA") == "scan":
            if self._twin_route(pal):
                out = _ed_host.ed_riemersma_fast(img, pal).astype(np.uint8)
            else:
                out = _riemersma_scan.riemersma_scan_batch(img[None], pal, self.device)[0]
            return out.astype(np.float32).reshape(-1, 3)
        return _ed_host.ed_riemersma(img, pal).reshape(-1, 3)

    def dither_batch(self, images, palette_arr):
        if os.environ.get("DITHER_PIE_TPU_RIEMERSMA") == "scan":
            pal = _palette_array(palette_arr)
            if self._twin_route(pal):
                return _host_batch(_ed_host.ed_riemersma_fast, images, pal).astype(np.uint8)
            return _riemersma_scan.riemersma_scan_batch(images, pal, self.device)
        return _host_batch(_ed_host.ed_riemersma_fast, images, palette_arr)


# -------------------- Wavelet --------------------


def _quant_subband(sub: torch.Tensor, noise: torch.Tensor, q_levels: int) -> torch.Tensor:
    """Randomized uniform quantization of (B, 3, hs, ws) subbands, float32
    on the tensor's device. The minimum and the maximum are those of one
    subband of one channel of one frame, never of the batch. The two
    epsilons stay float32 (they vanish unless the scale is tiny), as the JAX
    package's weak scalars do; the division by the level count takes a
    tensor divisor, since PyTorch's CUDA division by a Python scalar
    multiplies by the reciprocal."""
    mn = sub.amin((-2, -1), keepdim=True)
    mx = sub.amax((-2, -1), keepdim=True)
    scale = mx - mn
    norm = (sub - mn) / (scale + 1e-9)
    q = torch.floor(norm * q_levels + noise)
    q = q.clamp(0, q_levels - 1)
    qn = q / torch.tensor(q_levels - 1 + 1e-9, dtype=torch.float32, device=sub.device)
    out = qn * scale + mn
    return torch.where(scale == 0, sub, out)


def wavelet_reconstruct(frames: torch.Tensor, noises: torch.Tensor, wavelet: str,
                        q_levels: int) -> torch.Tensor:
    """(B, H, W, 3) frames on the device -> the (B, H, W, 3) float32
    reconstruction the pick runs on: DWT, quantized subbands, IDWT,
    cropped to the image and clipped to 0..255. Not integer-valued."""
    _, h, w, _ = frames.shape
    planes = frames.permute(0, 3, 1, 2).to(torch.float32)  # (B, 3, H, W)
    cA, details = _wavelet.dwt2(planes, wavelet)
    subs = [_quant_subband(sub, noises[:, k], q_levels)
            for k, sub in enumerate((cA, *details))]
    rec = _wavelet.idwt2(subs[0], subs[1:], wavelet)
    rec = rec[:, :, :h, :w].clamp(0, 255)
    return rec.permute(0, 2, 3, 1).contiguous()


def wavelet_batch(frames: torch.Tensor, palette: torch.Tensor, noises: torch.Tensor,
                  thr: torch.Tensor, wavelet: str, q_levels: int,
                  return_indices: bool = False) -> torch.Tensor:
    """The wavelet mode on a batch on one device: ``wavelet_reconstruct``,
    then K4's randomized pick against the (H, W) thresholds ``thr``;
    (B, H, W, 3) uint8 colours, or with ``return_indices`` (B, H, W) uint8
    indices."""
    rec = wavelet_reconstruct(frames, noises, wavelet, q_levels)
    return _ordered.dispatch_ordered_batch(rec, palette, thr, return_indices=return_indices)


class WaveletDitherStrategy(BaseDitherStrategy):
    """DWT -> randomized subband quantization -> IDWT -> randomized top-2 pick.

    Noise is drawn on host with ``np.random.RandomState(seed)`` in the exact
    order the reference draws it (per channel: cA, cH, cV, cD; then the final
    per-pixel thresholds), so results are reproducible, and the draws depend
    only on (seed, h, w): every frame of a batch, and a single image of the
    same size, share them. The transform and the quantization are torch ops
    on ``device``; the pick is K4 on the float32 reconstruction (its plain
    version on the CPU).
    """

    @staticmethod
    def get_parameter_info() -> Dict[str, Any]:
        return {
            "wavelet": {
                "type": "choice",
                "default": "haar",
                "choices": ["haar", "db1", "db2", "db4", "sym2", "sym4", "coif1", "bior1.3", "bior2.2"],
                "label": "Wavelet Type",
                "description": "Type of wavelet basis function",
            },
            "subband_quant": {
                "type": "int",
                "default": 8,
                "min": 2,
                "max": 32,
                "label": "Subband Quantization",
                "description": "Number of quantization levels for wavelet subbands",
            },
            "seed": {
                "type": "int",
                "default": 42,
                "min": 0,
                "max": 9999,
                "label": "Random Seed",
                "description": "Seed for random threshold generation (same seed = same output)",
            },
        }

    def __init__(self, wavelet: str = "haar", subband_quant: int = 8, seed: int = 42,
                 device: DeviceLike = "cuda"):
        self.wavelet = wavelet
        self.subband_quant = int(subband_quant)
        self.seed = int(seed)
        self.device = resolve_device(device)

    def get_current_parameters(self) -> Dict[str, Any]:
        return {"wavelet": self.wavelet, "subband_quant": self.subband_quant, "seed": self.seed}

    def _draw_noise(self, h: int, w: int):
        """Host RNG in the exact order the reference draws it (per channel:
        cA, cH, cV, cD; then the final per-pixel thresholds). The draws
        depend only on (seed, h, w) — identical for every video frame."""
        L = len(_wavelet.filter_bank(self.wavelet)[0])
        hs, ws = (h + L - 1) // 2, (w + L - 1) // 2
        rng = np.random.RandomState(self.seed)
        noises = np.empty((3, 4, hs, ws), np.float32)
        for ch in range(3):
            for k in range(4):
                noises[ch, k] = rng.rand(hs, ws).astype(np.float32)
        thr = rng.rand(h * w).astype(np.float32).reshape(h, w)
        return noises, thr

    def reconstruct(self, frames: torch.Tensor, noises: torch.Tensor) -> torch.Tensor:
        """``wavelet_reconstruct`` with this strategy's wavelet and levels."""
        return wavelet_reconstruct(frames, noises, self.wavelet, self.subband_quant)

    def _on_device(self, images, palette_arr, return_indices: bool,
                   noise=None) -> torch.Tensor:
        _, h, w, _ = np.shape(images)
        noises, thr = self._draw_noise(h, w) if noise is None else noise
        return wavelet_batch(
            _frames_tensor(images, self.device), _palette_tensor(palette_arr, self.device),
            torch.from_numpy(noises).to(self.device), torch.from_numpy(thr).to(self.device),
            self.wavelet, self.subband_quant, return_indices)

    def dither(self, pixels, palette_arr, image_size):
        return _one_frame_as_batch(self.dither_batch, pixels, palette_arr, image_size,
                                   np.float32)

    def dither_batch(self, images, palette_arr):
        # Over the local mesh where it is on: the noise and the thresholds
        # depend only on (seed, h, w), so they replicate.
        _, h, w, _ = np.shape(images)
        noise = self._draw_noise(h, w)
        out = _auto.maybe_sharded_map("wavelet", (self.wavelet, self.subband_quant), images,
                                      _palette_array(palette_arr), *noise, device=self.device)
        if out is not None:
            return out
        return _transfer.to_host(self._on_device(images, palette_arr, False, noise))

    def dither_batch_indices(self, images, palette_arr, planar=False):
        if planar or len(palette_arr) > 256:
            return None  # NHWC-only; u8 index stream
        return _transfer.to_host(self._on_device(images, palette_arr, True))


# -------------------- Halftone --------------------


class HalftoneDitherStrategy(BaseDitherStrategy):
    """Rotated-screen newspaper halftone (torch ops on ``device``; the
    screen and the cell layout come from the host, cached by shape)."""

    @staticmethod
    def get_parameter_info() -> Dict[str, Any]:
        return {
            "cell_size": {
                "type": "int", "default": 8, "min": 2, "max": 32,
                "label": "Cell Size",
                "description": "Distance between dot centers (smaller = finer detail)",
            },
            "angle": {
                "type": "float", "default": 45.0, "min": 0.0, "max": 90.0,
                "label": "Screen Angle",
                "description": "Rotation angle in degrees (45° is classic newspaper)",
            },
            "dot_gain": {
                "type": "float", "default": 1.0, "min": 0.5, "max": 3.0, "step": 0.1,
                "label": "Dot Gain",
                "description": "Controls dot growth (1.0 = linear, higher = more contrast)",
            },
            "min_dot_size": {
                "type": "float", "default": 0.0, "min": 0.0, "max": 0.5, "step": 0.05,
                "label": "Min Dot Size",
                "description": "Minimum dot threshold (0 = pure white possible)",
            },
            "max_dot_size": {
                "type": "float", "default": 1.0, "min": 0.5, "max": 1.0, "step": 0.05,
                "label": "Max Dot Size",
                "description": "Maximum dot threshold (1.0 = pure black possible)",
            },
            "shape": {
                "type": "choice", "default": "circle",
                "choices": ["circle", "square", "diamond"],
                "label": "Dot Shape",
                "description": "Shape of halftone dots",
            },
            "sharpness": {
                "type": "float", "default": 1.5, "min": 0.5, "max": 4.0, "step": 0.1,
                "label": "Sharpness",
                "description": "Edge sharpness (higher = crisper dots)",
            },
        }

    def __init__(self, cell_size: int = 8, angle: float = 45.0, dot_gain: float = 1.0,
                 min_dot_size: float = 0.0, max_dot_size: float = 1.0,
                 shape: str = "circle", sharpness: float = 1.5,
                 device: DeviceLike = "cuda"):
        self.cell_size = int(cell_size)
        self.angle = float(angle)
        self.dot_gain = float(dot_gain)
        self.min_dot_size = float(min_dot_size)
        self.max_dot_size = float(max_dot_size)
        self.shape = shape
        self.sharpness = float(sharpness)
        self.device = resolve_device(device)

    def get_current_parameters(self) -> Dict[str, Any]:
        return {
            "cell_size": self.cell_size, "angle": self.angle,
            "dot_gain": self.dot_gain, "min_dot_size": self.min_dot_size,
            "max_dot_size": self.max_dot_size, "shape": self.shape,
            "sharpness": self.sharpness,
        }

    def _layout(self, h: int, w: int):
        """(screen, cell_idx, n_cells) of an (h, w) frame (host, cached)."""
        return _halftone.halftone_screen(
            h, w, self.cell_size, self.angle, self.dot_gain,
            self.min_dot_size, self.max_dot_size, self.shape, self.sharpness,
        )

    def _on_device(self, images, palette_arr, op) -> torch.Tensor:
        """``op`` (``halftone_dither_batch`` or its index twin) on the
        batch, with this strategy's screen and cell layout."""
        _, h, w, _ = np.shape(images)
        screen, cell_idx, n_cells = self._layout(h, w)
        return op(_frames_tensor(images, self.device),
                  _palette_tensor(palette_arr, self.device),
                  torch.from_numpy(screen).to(self.device),
                  torch.from_numpy(cell_idx).to(self.device), n_cells)

    def dither(self, pixels, palette_arr, image_size):
        return _one_frame_as_batch(self.dither_batch, pixels, palette_arr, image_size,
                                   np.float32)

    def dither_batch(self, images, palette_arr):
        # Over the local mesh where it is on: the screen and the cell layout
        # depend only on the shape, so they replicate.
        _, h, w, _ = np.shape(images)
        screen, cell_idx, n_cells = self._layout(h, w)
        out = _auto.maybe_sharded_map("halftone", (n_cells,), images,
                                      _palette_array(palette_arr), screen, cell_idx,
                                      device=self.device)
        if out is not None:
            return out
        return _transfer.to_host(self._on_device(images, palette_arr,
                                                 _halftone.halftone_dither_batch))

    def dither_batch_indices(self, images, palette_arr, planar=False):
        if planar or len(palette_arr) > 256:
            return None  # NHWC-only; u8 index stream
        return _transfer.to_host(self._on_device(images, palette_arr,
                                                 _halftone.halftone_dither_batch_indices))


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
    DitherMode.NONE: NoDitherStrategy,
    DitherMode.BAYER: BayerDitherStrategy,
    DitherMode.BLUE_NOISE: BlueNoiseDitherStrategy,
    DitherMode.INTERLEAVED_GRADIENT_NOISE: InterleavedGradientNoiseDitherStrategy,
    DitherMode.POLKA_DOT: PolkaDotDitherStrategy,
    DitherMode.ERROR_DIFFUSION: ErrorDiffusionDitherStrategy,
    DitherMode.RIEMERSMA: RiemersmaDitherStrategy,
    DitherMode.OSTROMOUKHOV: OstromoukhovDitherStrategy,
    DitherMode.HYBRID: HybridDitherStrategy,
    DitherMode.PERCEPTUAL: PerceptualDitherStrategy,
    DitherMode.ADAPTIVE_VARIANCE: AdaptiveVarianceDitherStrategy,
    DitherMode.WAVELET: WaveletDitherStrategy,
    DitherMode.HALFTONE: HalftoneDitherStrategy,
}

# Parameter metadata of the modes that expose parameters (NONE, RIEMERSMA
# and PERCEPTUAL do not), as the JAX package's table.
_PARAM_MODES = {
    DitherMode.BAYER: BayerDitherStrategy.get_parameter_info,
    DitherMode.HALFTONE: HalftoneDitherStrategy.get_parameter_info,
    DitherMode.POLKA_DOT: PolkaDotDitherStrategy.get_parameter_info,
    DitherMode.BLUE_NOISE: BlueNoiseDitherStrategy.get_parameter_info,
    DitherMode.INTERLEAVED_GRADIENT_NOISE:
        InterleavedGradientNoiseDitherStrategy.get_parameter_info,
    DitherMode.WAVELET: WaveletDitherStrategy.get_parameter_info,
    DitherMode.ADAPTIVE_VARIANCE: AdaptiveVarianceDitherStrategy.get_parameter_info,
    DitherMode.HYBRID: HybridDitherStrategy.get_parameter_info,
    DitherMode.ERROR_DIFFUSION: ErrorDiffusionDitherStrategy.get_parameter_info,
    DitherMode.OSTROMOUKHOV: OstromoukhovDitherStrategy.get_parameter_info,
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

    @staticmethod
    def get_mode_parameters(mode: DitherMode) -> Optional[Dict[str, Any]]:
        info = _PARAM_MODES.get(mode)
        return info() if info else None

    @staticmethod
    def mode_has_parameters(mode: DitherMode) -> bool:
        return ImageDitherer.get_mode_parameters(mode) is not None

    def _get_dither_strategy(self, mode: DitherMode) -> BaseDitherStrategy:
        strategy_class = _STRATEGY_CLASSES.get(mode)
        if strategy_class is None:
            raise ValueError(f"Unrecognized DitherMode: {mode}")
        param_info = strategy_class.get_parameter_info()
        if param_info:
            settings = {key: info["default"] for key, info in param_info.items()}
            settings.update(self.dither_params)
            return strategy_class(**settings, device=self.device)
        return strategy_class(device=self.device)

    def apply_dithering_array(self, arr_srgb_8: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8 in, (H, W, 3) uint8 out. Core of apply_dithering."""
        count("facade.frames")
        if self.use_gamma:
            with stage("facade.host_in"):
                arr_01 = arr_srgb_8.astype(np.float32) / 255.0
                arr_lin_01 = _colors.srgb_to_linear_np(arr_01)
                # Reference quirk: quantizes the LINEAR image to 8 bits
                # before dithering.
                arr_for_dith = np.clip(arr_lin_01 * 255.0, 0, 255).astype(np.uint8)
            if self.palette is None:
                self.palette = _palette.median_cut_palette(arr_for_dith, self.num_colors)
        else:
            if self.palette is None:
                self.palette = _palette.median_cut_palette(arr_srgb_8, self.num_colors)
            arr_for_dith = arr_srgb_8

        palette_arr = self._palette_for_dither()
        h, w, _ = arr_for_dith.shape
        with stage("facade.host_in"):
            flat_pixels = arr_for_dith.reshape(-1, 3).astype(np.float32)

        strategy = self._get_dither_strategy(self.dither_mode or DitherMode.NONE)
        dithered_flat = strategy.dither(flat_pixels, palette_arr, (h, w))
        with stage("facade.host_out"):
            return self._from_dither(dithered_flat.reshape(h, w, 3).astype(np.uint8))

    def supports_planar_batch(self) -> bool:
        """True when ``apply_dithering_batch(..., planar=True)`` is
        available: an error-diffusion strategy (row-major) with a palette
        within the planar path's cap. The video pipeline asks this to pick
        zero-copy planar ingestion."""
        if self.palette is not None and len(self.palette) > _wf.PACKED_PALETTE_MAX:
            return False
        strategy_class = _STRATEGY_CLASSES.get(self.dither_mode or DitherMode.NONE)
        if strategy_class is None or not hasattr(strategy_class, "dither_batch_planar"):
            return False
        param_info = strategy_class.get_parameter_info()
        if param_info is None:
            return True  # a strategy without parameters ignores dither_params
        if set(self.dither_params) - set(param_info):
            return False  # the strategy cannot be built with these parameters
        return self.dither_params.get("serpentine") != "true"

    def apply_dithering_batch(self, arrs_srgb_8: np.ndarray,
                              planar: bool = False) -> np.ndarray:
        """Batched device path: (B, H, W, 3) uint8 -> (B, H, W, 3) uint8.

        Requires an explicit palette (the video pipeline computes one from
        the first frame, matching reference semantics).

        ``planar=True``: frames are (3, B, H, W) channel-major planes, in
        and out; only strategies with a planar path accept it
        (``supports_planar_batch``).

        Index transfer: where the device-to-host link is slow (measured
        once per device, ``api/linkspeed.py``;
        ``DITHER_PIE_TPU_INDEX_TRANSFER=1/0`` forces it) a strategy with an
        index output returns (B, H, W) palette indices, a third of the
        bytes or less, and one palette gather on the host rebuilds the
        colour output bit for bit. Gamma folds into the palette: output
        pixels only ever take palette values, so the per-entry
        linear-to-sRGB map equals the per-pixel map exactly.

        The local mesh (``parallel/auto.py``) returns colours, and where it
        may serve the batch it wins over a measured link: the index stream
        runs under the mesh only where ``DITHER_PIE_TPU_INDEX_TRANSFER=1``
        asks for it or the batch is planar, which the mesh never serves."""
        if self.palette is None:
            raise ValueError("apply_dithering_batch requires a palette; "
                             "compute one from the first frame first")
        count("facade.frames", np.shape(arrs_srgb_8)[1 if planar else 0])
        if self.use_gamma:
            with stage("facade.host_in"):
                lin = _colors.srgb_to_linear_np(arrs_srgb_8.astype(np.float32) / 255.0)
                work = np.clip(lin * 255.0, 0, 255).astype(np.uint8)
        else:
            work = arrs_srgb_8
        palette_arr = self._palette_for_dither()
        strategy = self._get_dither_strategy(self.dither_mode or DitherMode.NONE)
        index_forced = os.environ.get("DITHER_PIE_TPU_INDEX_TRANSFER") == "1"
        mesh_may_serve = _auto.auto_mesh_enabled(self.device) and not planar
        if ((index_forced or not mesh_may_serve)
                and _linkspeed.index_transfer_wins(self.device)):
            idx = strategy.dither_batch_indices(work, palette_arr, planar=planar)
            if idx is not None:
                with stage("facade.host_out"):
                    # Truncation, as the device epilogue's float32 -> int cast.
                    pal_u8 = self._from_dither(palette_arr.astype(np.uint8))
                    if planar:
                        return pal_u8.T[:, idx]  # (3, B, H, W)
                    return pal_u8[idx]  # (B, H, W, 3)
        if planar:
            if not hasattr(strategy, "dither_batch_planar"):
                raise ValueError(
                    f"{type(strategy).__name__} has no planar batch path: ask "
                    "supports_planar_batch() first")
            out = strategy.dither_batch_planar(work, palette_arr)
        else:
            out = strategy.dither_batch(work, palette_arr)
        with stage("facade.host_out"):
            # A uint8 result is returned as it is: on a CUDA device, the
            # pinned block the copy back landed in (``api/transfer.py``).
            return self._from_dither(out.astype(np.uint8, copy=False))

    def apply_dithering(self, image: Image.Image) -> Image.Image:
        with stage("facade.host_in"):
            arr = np.array(image.convert("RGB"), dtype=np.uint8)
        out = self.apply_dithering_array(arr)
        with stage("facade.host_out"):
            return Image.fromarray(out, "RGB")

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

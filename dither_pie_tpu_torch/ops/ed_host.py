"""Host-engine error diffusion: the scans that have no wavefront.

A serpentine row runs against the direction of the row above, so it
depends on that row's last pixel, and the Riemersma scan follows a Hilbert
curve: neither splits into anti-diagonals, so both run on the host engine
(``native/ed_scan.cpp``, bound in ``native/build.py``), as in the JAX
package. These are the wrappers of ``dither_pie_tpu/ops/ed_host.py`` that
the facade routes to, with one difference: there is no numpy loop behind
the engine; a failed build raises.

Each function takes a float32 (H, W, 3) frame in [0, 255] (values may pass
the bounds on the way, as in the reference) and a (P, 3) float32 palette,
and returns the dithered frame; it works in place when ``work`` is already
a C-contiguous float32 array. ``ed_*`` search the palette in float64 (the
exact engine, single images); ``ed_*_fast`` are the float32 twins (video
batches), which hand palettes above ``F32_TWIN_MAX_PAL`` colours to the
exact engine: that route is part of the semantics.
"""

from __future__ import annotations

import numpy as np

from dither_pie_tpu_torch.native.build import get_lib
from dither_pie_tpu_torch.ops.ed_kernels import OSTROMOUKHOV_ARRAY, kernel_arrays
from dither_pie_tpu_torch.ops.hilbert import hilbert_path, next_power_of_two

# Largest palette the engine's float32 twins serve (ed_scan.cpp MAX_PAL).
F32_TWIN_MAX_PAL = 4096


def _contiguous(work: np.ndarray, palette: np.ndarray):
    return (np.ascontiguousarray(work, dtype=np.float32),
            np.ascontiguousarray(palette, dtype=np.float32))


def ed_fixed(work: np.ndarray, palette: np.ndarray, variant: str = "atkinson",
             serpentine: bool = False) -> np.ndarray:
    """Fixed-weight error diffusion (the 8 classic kernels), float64
    search."""
    work, pal = _contiguous(work, palette)
    offs, wts = kernel_arrays(variant)
    h, w, _ = work.shape
    get_lib().ed_fixed(work, h, w, pal, pal.shape[0], offs, wts, len(wts), int(serpentine))
    return work


def ed_fixed_fast(work: np.ndarray, palette: np.ndarray, variant: str = "atkinson",
                  serpentine: bool = False) -> np.ndarray:
    """float32 twin of ``ed_fixed`` (video throughput)."""
    if palette.shape[0] > F32_TWIN_MAX_PAL:
        return ed_fixed(work, palette, variant, serpentine)
    work, pal = _contiguous(work, palette)
    offs, wts = kernel_arrays(variant)
    h, w, _ = work.shape
    get_lib().ed_fixed_f32(work, h, w, pal, pal.shape[0], offs, wts, len(wts),
                           int(serpentine))
    return work


def ed_ostromoukhov(work: np.ndarray, palette: np.ndarray,
                    serpentine: bool = False) -> np.ndarray:
    """Ostromoukhov's variable-coefficient diffusion, float64 search."""
    work, pal = _contiguous(work, palette)
    h, w, _ = work.shape
    get_lib().ed_ostromoukhov(work, h, w, pal, pal.shape[0],
                              np.ascontiguousarray(OSTROMOUKHOV_ARRAY), int(serpentine))
    return work


def ed_ostromoukhov_fast(work: np.ndarray, palette: np.ndarray,
                         serpentine: bool = False) -> np.ndarray:
    """float32 twin of ``ed_ostromoukhov``."""
    if palette.shape[0] > F32_TWIN_MAX_PAL:
        return ed_ostromoukhov(work, palette, serpentine)
    work, pal = _contiguous(work, palette)
    h, w, _ = work.shape
    get_lib().ed_ostromoukhov_f32(work, h, w, pal, pal.shape[0],
                                  np.ascontiguousarray(OSTROMOUKHOV_ARRAY), int(serpentine))
    return work


def _curve(h: int, w: int) -> np.ndarray:
    """The Hilbert path over the 2^k square that covers the frame."""
    return np.ascontiguousarray(hilbert_path(next_power_of_two(max(h, w))))


def ed_riemersma(work: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """Error diffusion along a Hilbert curve over the padded 2^k grid,
    float64 search."""
    work, pal = _contiguous(work, palette)
    h, w, _ = work.shape
    path = _curve(h, w)
    get_lib().ed_riemersma(work, h, w, pal, pal.shape[0], path, path.shape[0])
    return work


def ed_riemersma_fast(work: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """float32 twin of ``ed_riemersma``."""
    if palette.shape[0] > F32_TWIN_MAX_PAL:
        return ed_riemersma(work, palette)
    work, pal = _contiguous(work, palette)
    h, w, _ = work.shape
    path = _curve(h, w)
    get_lib().ed_riemersma_f32(work, h, w, pal, pal.shape[0], path, path.shape[0])
    return work

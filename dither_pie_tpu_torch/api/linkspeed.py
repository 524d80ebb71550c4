"""Device-to-host link probe: pick the cheaper output transfer shape. The
port of ``dither_pie_tpu/api/linkspeed.py``.

A dithered batch can leave the device as RGB (3 bytes a pixel) or as
palette indices (1 byte a pixel, less when bit-packed, 2 above 256
colours) plus one exact palette gather on the host. The index stream saves
2 bytes a pixel of link time and pays the gather, so it wins where

    2 bytes / link bandwidth  >  the host gather's time per pixel.

Both sides are measured, once per process: ``d2h_bandwidth_mb_s`` times the
copy the facade makes (``api/transfer.py``: into a pinned block of the
caching host allocator) and ``host_gather_ns_per_px`` the kind of gather it
makes (``pal_u8[idx]``).
The JAX package compares the bandwidth with a constant, 1000 MB/s, that
stands for a gather of 2 ns a pixel; this host's gather is measured instead,
so the break-even follows the host (``break_even_mb_s``).
``DITHER_PIE_TPU_INDEX_TRANSFER=1/0`` forces the choice without probing
(the knob for tests and benchmarks). Nothing here catches an error: on a
CUDA device a failing copy raises.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from dither_pie_tpu_torch.api import transfer
from dither_pie_tpu_torch.api.runtime import DeviceLike, resolve_device

_PROBE_BYTES = 16 * 1024 * 1024
_GATHER_PIXELS = 1080 * 1920  # one full-HD frame of indices
_SAVED_BYTES_PER_PX = 2.0  # RGB's three bytes less the uint8 stream's one
_cache: Dict[torch.device, float] = {}
_gather_cache: List[float] = []
# The video pipeline's two workers may ask at once: one probe runs, the
# other waits for its verdict (two copies at once would time each other).
_probe_lock = threading.RLock()


def d2h_bandwidth_mb_s(device: DeviceLike) -> Optional[float]:
    """Measured device-to-host bandwidth of ``device`` in MB/s: the best of
    two 16 MB uint8 copies with distinct contents into a pinned block, as
    ``transfer.to_host`` copies (the block allocated before the clock
    starts), each timed after a ``torch.cuda.synchronize``. ``None`` for a
    CPU device (there is no link). Cached per device for the life of the
    process."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return None
    with _probe_lock:
        if dev not in _cache:
            best = float("inf")
            for i in range(2):
                x = (torch.arange(_PROBE_BYTES, dtype=torch.int32, device=dev)
                     * (i + 40503)).to(torch.uint8)
                buf = transfer.pinned_block(x)
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                transfer.copy_back(x, buf)
                best = min(best, time.perf_counter() - t0)
            _cache[dev] = _PROBE_BYTES / best / 1e6
        return _cache[dev]


def host_gather_ns_per_px() -> float:
    """Measured cost of the index stream's host side, in nanoseconds a
    pixel: the best of two ``pal_u8[idx]`` gathers (the facade's form) of
    one full-HD frame of scattered uint8 indices into a 32-colour palette.
    Cached for the life of the process."""
    with _probe_lock:
        if not _gather_cache:
            idx = (np.arange(_GATHER_PIXELS, dtype=np.uint32) * np.uint32(40503) >> 7).astype(
                np.uint8) & np.uint8(31)
            pal_u8 = np.arange(96, dtype=np.uint8).reshape(32, 3)
            best = float("inf")
            for _ in range(2):
                t0 = time.perf_counter()
                pal_u8[idx]
                best = min(best, time.perf_counter() - t0)
            _gather_cache.append(best / _GATHER_PIXELS * 1e9)
        return _gather_cache[0]


def break_even_mb_s() -> float:
    """The link bandwidth below which the index stream wins on this host:
    the bytes a pixel it saves over the gather's measured time a pixel."""
    return _SAVED_BYTES_PER_PX * 1e3 / host_gather_ns_per_px()


def index_transfer_wins(device: DeviceLike) -> bool:
    """True when the index stream beats RGB output on ``device``'s link:
    forced by ``DITHER_PIE_TPU_INDEX_TRANSFER=1/0``, else a measured
    bandwidth below ``break_even_mb_s()``. A CPU device has no link."""
    env = os.environ.get("DITHER_PIE_TPU_INDEX_TRANSFER")
    if env in ("0", "1"):
        return env == "1"
    bw = d2h_bandwidth_mb_s(device)
    return bw is not None and bw < break_even_mb_s()

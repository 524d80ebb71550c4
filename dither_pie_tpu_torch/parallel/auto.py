"""Automatic data parallelism for batch dithering over the local devices,
the port of ``dither_pie_tpu/parallel/auto.py``.

With more than one local device, the facade's batched strategy steps route
through a data-parallel mesh over every local device (``sharding.py``) by
default: frames shard over the 'data' axis, each device runs the kernels
on its own shard, and no collective runs in steady state.
``DITHER_PIE_TPU_AUTO_MESH=0`` opts out (one device); ``=1`` forces the
mesh path. The sharded path gives the single-device output bit for bit in
every mode (``tests/test_torch_parallel.py``, on a mesh of eight CPU
positions), which is what justifies the default.

Scope: the whole batched strategy surface. Every ED mode (fixed weights,
ostromoukhov, hybrid, perceptual, adaptive; aux streams shard with their
frames; palettes to PACKED_PALETTE_MAX colours), the ordered family,
wavelet and halftone. The functions return ``None`` where the JAX package's
do, and the caller runs the batch on its one device: the mesh is off, the
ordered batch does not divide evenly, the palette exceeds
PACKED_PALETTE_MAX, or a palette above 64 colours asks for a search other
than the exact one (the first-batch gate runs on one device). The JAX
package also bails where a shard would exceed the TPU kernel's VMEM
budget; the port's scan takes any batch, so nothing here does.

``local_devices`` is the one seam: the tests replace it with
``[cpu] * 8`` (the JAX tests force eight virtual CPU devices), and
``chip_smoke.py`` with ``[cuda:0, cuda:0]``.
"""

from __future__ import annotations

import functools
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from dither_pie_tpu_torch.api.runtime import DeviceLike
from dither_pie_tpu_torch.parallel import sharding as _sharding
from dither_pie_tpu_torch.parallel.mesh import make_mesh


def local_devices(device: DeviceLike) -> List[torch.device]:
    """The devices a mesh for ``device``'s work spans: every visible card
    for a CUDA device, the one CPU device for a CPU one."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def auto_mesh_enabled(device: DeviceLike = "cuda") -> bool:
    """Default on with more than one local device;
    DITHER_PIE_TPU_AUTO_MESH=0/1 forces it."""
    v = os.environ.get("DITHER_PIE_TPU_AUTO_MESH")
    if v is not None:
        return v == "1"
    return len(local_devices(device)) > 1


def _mesh_devices(device: DeviceLike) -> Optional[Tuple[torch.device, ...]]:
    """The local devices when the mesh is on and spans two or more."""
    if not auto_mesh_enabled(device):
        return None
    devs = tuple(local_devices(device))
    return devs if len(devs) >= 2 else None


def _pad(images: np.ndarray, bp: int) -> np.ndarray:
    """``images`` padded to ``bp`` frames with copies of its last one."""
    b = images.shape[0]
    if bp == b:
        return images
    return np.concatenate([images, np.repeat(images[-1:], bp - b, axis=0)], axis=0)


@functools.lru_cache(maxsize=32)
def _cached_ed_step(devs: Tuple[torch.device, ...], h: int, w: int, p: int,
                    batch_per_chip: int, variant: str, mode: str, lum_factor: float,
                    col_factor: float):
    mesh = make_mesh(shape=(len(devs),), axis_names=("data",), devices=devs)
    return _sharding.make_sharded_ed_step(mesh, h, w, p, batch_per_chip, variant=variant,
                                          mode=mode, lum_factor=lum_factor,
                                          col_factor=col_factor)


def _map_step(devs: Tuple[torch.device, ...], fn):
    """``run(frames, *replicated) -> host numpy``: ``fn(frames shard,
    *replicated)`` on every device's shard of the 'data' axis, the
    replicated inputs copied once to each device."""
    lanes = _sharding.Lanes(devs)

    def run(frames, *reps):
        n = len(devs)
        step = frames.shape[0] // n
        on = [_sharding.per_device(r, devs) for r in reps]

        def work(k, dev):
            x = torch.from_numpy(np.ascontiguousarray(frames[k * step:(k + 1) * step]))
            return fn(x.to(dev), *(r[dev] for r in on))

        return torch.cat([o.cpu() for o in lanes.map(work)]).numpy()

    return run


@functools.lru_cache(maxsize=8)
def _cached_ordered_step(devs: Tuple[torch.device, ...]):
    return _map_step(devs, _sharding.dispatch_ordered_batch)


def maybe_sharded_ordered(images, palette, screen,
                          device: DeviceLike = "cuda") -> Optional[np.ndarray]:
    """An ordered-dither batch through K4 on every local device's shard, as
    a host uint8 array, or None when the mesh is off or the batch does not
    divide evenly (one frame in is one frame out: no padding here)."""
    devs = _mesh_devices(device)
    if devs is None:
        return None
    images = _sharding.host_frames(images)
    if images.shape[0] % len(devs):
        return None
    return _cached_ordered_step(devs)(images, palette, screen)


def maybe_sharded_ed(images, palette: np.ndarray, variant: str = "floyd_steinberg",
                     mode: str = "fixed", aux: Optional[np.ndarray] = None,
                     lum_factor: float = 1.0, col_factor: float = 0.2,
                     dense_search: str = "exact",
                     device: DeviceLike = "cuda") -> Optional[np.ndarray]:
    """A (B, H, W, 3) batch through the data-parallel ED step, as a host
    uint8 array, or None when the mesh is off or does not apply (the
    caller runs the batch on one device). The batch is padded to a
    multiple of the mesh with its last frame, and the output cropped.
    ``aux``: adaptive's (B, H, W) gates, padded and sharded with the
    frames; ``dense_search``: the caller's palette search, of which the
    mesh serves only "exact" above 64 colours."""
    from dither_pie_tpu_torch.ops.wavefront import PACKED_PALETTE_MAX, SCORE_PALETTE_MIN

    devs = _mesh_devices(device)
    p = int(np.shape(palette)[0])
    if devs is None or p > PACKED_PALETTE_MAX:
        return None
    if p > SCORE_PALETTE_MIN and dense_search != "exact":
        return None
    images = _sharding.host_frames(images)
    b, h, w, _ = images.shape
    n = len(devs)
    bp = -(-b // n) * n
    images = _pad(images, bp)
    if aux is not None:
        aux = _pad(np.asarray(aux), bp)
    run = _cached_ed_step(devs, h, w, p, bp // n, variant, mode, float(lum_factor),
                          float(col_factor))
    out, _err = run(images, np.asarray(palette, np.float32), aux)
    return out.gather().numpy()[:b]


# ---------------------------------------------------------------------------
# Per-frame batched device maps (wavelet, halftone): frames shard over
# 'data', everything else is replicated; no collective at all.
# ---------------------------------------------------------------------------


def _local_map_fn(kind: str, key: tuple):
    if kind == "wavelet":
        from dither_pie_tpu_torch.api.ditherer import wavelet_batch

        wavelet, q_levels = key
        return functools.partial(wavelet_batch, wavelet=wavelet, q_levels=q_levels)
    if kind == "halftone":
        from dither_pie_tpu_torch.ops.halftone import halftone_dither_batch

        (n_cells,) = key
        return functools.partial(halftone_dither_batch, n_cells=n_cells)
    raise ValueError(f"unknown sharded map kind: {kind}")


@functools.lru_cache(maxsize=64)
def _cached_map_step(kind: str, key: tuple, devs: Tuple[torch.device, ...]):
    return _map_step(devs, _local_map_fn(kind, key))


def maybe_sharded_map(kind: str, key: tuple, images, *replicated,
                      device: DeviceLike = "cuda") -> Optional[np.ndarray]:
    """A per-frame batched device map ("wavelet" or "halftone") over every
    local device's shard, as a host array, or None when the mesh is off.
    ``key`` pins every static parameter of the map; the batch is padded to
    a multiple of the mesh with its last frame, and the output cropped."""
    devs = _mesh_devices(device)
    if devs is None:
        return None
    images = _sharding.host_frames(images)
    b = images.shape[0]
    bp = -(-b // len(devs)) * len(devs)
    out = _cached_map_step(kind, key, devs)(_pad(images, bp), *replicated)
    return out[:b]

"""Sharded dithering steps over a device mesh, the port of
``dither_pie_tpu/parallel/sharding.py``, in one process.

The JAX package maps a local step over the mesh with ``shard_map``; here
one controller does the same by hand: it splits the batch, enqueues every
shard's work on its device (on a CUDA stream of its own for each mesh
position, ``Lanes``), then joins the streams and reduces.

* **data** axis: the frame batch. Frames are independent, so no
  collective is needed in steady state.
* **space** axis: image rows, for the ordered step only (every output
  pixel is a local decision, so row shards need no halo). Error diffusion
  cannot split rows without changing its result; across devices it stays
  data-parallel, each shard scanning whole frames with K1 -> K2 -> K3.
* The collectives are the JAX package's: the ordered step's ``psum`` of
  the palette histogram and the ED step's ``pmean`` of the quantisation
  error. Each is a sum in device order onto the mesh's first device.

A shard that fails raises; nothing runs again on one device in its place.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from dither_pie_tpu_torch.core.colors import linear_to_srgb, srgb_to_linear
from dither_pie_tpu_torch.ops.ordered import dispatch_ordered_batch
from dither_pie_tpu_torch.ops.ordered_fused import INDEX_PALETTE_MAX
from dither_pie_tpu_torch.ops.wavefront import perceptual_sensitivity, wavefront_device_fn
from dither_pie_tpu_torch.parallel.mesh import (
    Mesh,
    NamedSharding,
    Sharded,
    device_put,
    frames_sharding,
    make_mesh,
    mean_in_order,
    shard_slices,
    sum_in_order,
)

class Lanes:
    """One CUDA stream for each of ``devices`` (a device may repeat), and
    none for a CPU device, whose work runs in order on the host.

    ``map(work)`` runs ``work(k, device)`` for every position on its own
    stream, each stream first waiting for the caller's current stream, so
    that every shard is enqueued before any result is read; then the
    caller's streams wait for every lane, and the tensors that came back
    are marked as used there."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = [torch.device(d) for d in devices]
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                        for d in self.devices]

    def map(self, work: Callable[[int, torch.device], object]) -> List[object]:
        results = []
        for k, (dev, stream) in enumerate(zip(self.devices, self.streams)):
            if stream is None:
                results.append(work(k, dev))
                continue
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                results.append(work(k, dev))
        for res, dev, stream in zip(results, self.devices, self.streams):
            if stream is None:
                continue
            current = torch.cuda.current_stream(dev)
            current.wait_stream(stream)
            for t in _tensors(res):
                if t.device.type == "cuda":
                    t.record_stream(current)
        return results


def _tensors(res) -> List[torch.Tensor]:
    if isinstance(res, torch.Tensor):
        return [res]
    if isinstance(res, (tuple, list)):
        return [t for r in res for t in _tensors(r)]
    return []


def per_device(x, devices: Sequence[torch.device],
               dtype: Optional[torch.dtype] = None) -> Dict[torch.device, torch.Tensor]:
    """A replicated input: one copy of ``x`` (host array or tensor) on
    each distinct device, made on the caller's stream."""
    t = torch.as_tensor(np.ascontiguousarray(x) if isinstance(x, np.ndarray) else x)
    if dtype is not None:
        t = t.to(dtype)
    return {dev: t.to(dev) for dev in dict.fromkeys(devices)}


def host_frames(images) -> np.ndarray:
    """A frame batch as the port's ops take it: uint8 stays uint8,
    anything else becomes float32."""
    arr = np.asarray(images)
    return arr if arr.dtype == np.uint8 else arr.astype(np.float32)


def _piece(frames, sl, dev) -> torch.Tensor:
    """One shard of a host batch (numpy) or of a tensor, on ``dev``."""
    if isinstance(frames, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(frames[sl])).to(dev)
    return frames[sl].contiguous().to(dev)


def shard_frames(mesh: Mesh, frames_u8) -> Sharded:
    """A host frame batch (B, H, W, 3) placed on the mesh: B over 'data',
    H over 'space'."""
    return device_put(frames_u8, frames_sharding(mesh))


def palette_u8(palette: torch.Tensor) -> torch.Tensor:
    """The palette as K4 writes its colours: float32 -> int32 -> uint8."""
    return palette.to(torch.int32).to(torch.uint8)


def palette_index(colours: torch.Tensor, palette: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 colours of ``palette`` -> (...) int64 indices of the
    first palette row whose truncated colour each one is. K4 breaks ties
    towards the lowest index, so for a palette without repeated colours
    this is the row it picked."""
    weights = torch.tensor([1 << 16, 1 << 8, 1], dtype=torch.int64, device=palette.device)
    pal_keys = (palette_u8(palette).to(torch.int64) * weights).sum(-1)
    sorted_keys, order = torch.sort(pal_keys, stable=True)
    keys = (colours.to(torch.int64) * weights).sum(-1)
    return order[torch.searchsorted(sorted_keys, keys)]


def gamma_palette_u8(palette: torch.Tensor) -> torch.Tensor:
    """The gamma path's output colour of each palette row: the 8-bit linear
    entry back through the inverse curve, clipped and truncated to uint8,
    as the JAX step maps each output pixel."""
    c255 = torch.tensor(255.0, dtype=torch.float32, device=palette.device)
    srgb = linear_to_srgb((palette / c255).clamp(0.0, 1.0))
    return (srgb * c255).clamp(0.0, 255.0).to(torch.uint8)


def ordered_local(frames_u8: torch.Tensor, palette: torch.Tensor, screen: torch.Tensor,
                  use_gamma: bool):
    """One shard: (b, h, w, 3) uint8 frames -> (b, h, w, 3) uint8 and the
    shard's (P,) int64 palette-usage counts, through K4. With
    ``use_gamma`` the frames are first mapped to 8-bit linear (rounded) and
    the output colours back through the inverse curve."""
    x = frames_u8
    if use_gamma:
        c255 = torch.tensor(255.0, dtype=torch.float32, device=x.device)
        lin = srgb_to_linear(x.to(torch.float32) / c255)
        x = torch.round((lin * c255).clamp(0.0, 255.0))  # the 8-bit linear quirk
    p = palette.shape[0]
    if p <= INDEX_PALETTE_MAX:  # K4's uint8 index output
        idx = dispatch_ordered_batch(x, palette, screen, return_indices=True).to(torch.int64)
        colours = None
    else:
        colours = dispatch_ordered_batch(x, palette, screen)
        idx = palette_index(colours, palette)
    hist = torch.bincount(idx.flatten(), minlength=p)
    if use_gamma:
        out = gamma_palette_u8(palette)[idx]
    elif colours is None:
        out = palette_u8(palette)[idx]
    else:
        out = colours
    return out, hist


def make_sharded_ordered_step(mesh: Mesh, use_gamma: bool = False):
    """``step(frames, palette, screen) -> (out, hist)``: the multi-device
    ordered dither.

    frames (B, H, W, 3) uint8 (a host array, a tensor or ``shard_frames``'
    result): B over 'data', H over 'space'; screen (H, W) float32: H over
    'space'; palette (P, 3) float32: replicated. Returns the output as a
    ``Sharded`` of the frames' layout (``.gather()`` brings it to the host)
    and the global (P,) palette histogram on the mesh's first device."""
    sharding = frames_sharding(mesh)
    screen_sharding = NamedSharding(mesh, ("space", None))
    devices = list(mesh.devices.flat)
    lanes = Lanes(devices)

    def step(frames, palette, screen):
        if isinstance(frames, Sharded):
            shape, get = frames.shape, (lambda k, dev: frames.shards[k])
        else:
            frames = frames if isinstance(frames, torch.Tensor) else np.asarray(frames)
            shape = tuple(frames.shape)
            slices = shard_slices(sharding, shape)
            get = lambda k, dev: _piece(frames, slices[k], dev)  # noqa: E731
        screen = torch.as_tensor(screen, dtype=torch.float32)
        rows = shard_slices(screen_sharding, tuple(screen.shape))
        pals = per_device(palette, devices, torch.float32)

        def work(k, dev):
            return ordered_local(get(k, dev), pals[dev], screen[rows[k]].contiguous().to(dev),
                                 use_gamma)

        results = lanes.map(work)
        hist = sum_in_order([h for _, h in results], devices[0])
        return Sharded([o for o, _ in results], sharding, shape), hist

    return step


def make_sharded_ed_step(mesh: Mesh, h: int, w: int, p: int, batch_per_chip: int,
                         variant: str = "floyd_steinberg", mode: str = "fixed",
                         lum_factor: float = 1.0, col_factor: float = 0.2):
    """Data-parallel error diffusion over the mesh's 'data' axis.

    ``run(frames, palette, aux=None) -> (out, err)``: frames (n_data *
    batch_per_chip, H, W, 3) uint8 or float32 split over 'data' (a mesh
    with other axes runs each shard once, on the first device of its row);
    each shard runs ``ops.wavefront.wavefront_device_fn`` (K1 -> K2 -> K3)
    on its own frames. ``out`` is a ``Sharded`` over the data devices,
    ``err`` the mean of the shards' mean absolute quantisation errors on
    the first device. Every mode: fixed weights, ostromoukhov, hybrid,
    perceptual and adaptive. ``aux``: adaptive's (B, H, W) gates, which
    shard with their frames; perceptual's sensitivity map is built on each
    shard's device from that shard's frames unless given."""
    devices = mesh.axis_devices("data")
    data_mesh = make_mesh((len(devices),), ("data",), devices)
    sharding = NamedSharding(data_mesh, ("data", None, None, None))
    aux_sharding = NamedSharding(data_mesh, ("data", None, None))
    fn = wavefront_device_fn(mode, variant, h, w, p, batch_per_chip,
                             lum_factor=lum_factor, col_factor=col_factor)
    lanes = Lanes(devices)

    def run(frames, palette, aux=None):
        if mode == "adaptive" and aux is None:
            raise ValueError("mode 'adaptive' needs its (B, H, W) gates as aux")
        frames = host_frames(frames) if not isinstance(frames, torch.Tensor) else frames
        shape = tuple(frames.shape)
        slices = shard_slices(sharding, shape)
        aux_slices = None if aux is None else shard_slices(aux_sharding, tuple(aux.shape))
        pals = per_device(palette, devices, torch.float32)

        def work(k, dev):
            x = _piece(frames, slices[k], dev)
            a = None
            if aux_slices is not None:
                a = _piece(aux, aux_slices[k], dev).to(torch.float32)
            elif mode == "perceptual":
                a = perceptual_sensitivity(x)
            out = fn(x, pals[dev], a)
            err = (out.to(torch.float32) - x.to(torch.float32)).abs().mean()
            return out, err

        results = lanes.map(work)
        err = mean_in_order([e for _, e in results], devices[0])
        return Sharded([o for o, _ in results], sharding, shape), err

    return run

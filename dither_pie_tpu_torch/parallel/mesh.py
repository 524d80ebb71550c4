"""Device meshes of one process, the port of ``dither_pie_tpu/parallel/mesh.py``.

Frames are embarrassingly parallel, so the primary axis is ``data`` (the
frame batch); ordered modes also shard rows over ``space`` (no halo: every
pixel's decision is local). A ``Mesh`` is a numpy array of ``torch.device``
with a name for each axis. A device may appear more than once: PyTorch has
one CPU device, so the tests build their eight-device mesh as ``[cpu] * 8``,
and one card can stand for two as ``[cuda:0, cuda:0]``; every position
still runs its own shard.

``NamedSharding`` says how a tensor lies on a mesh: its ``spec`` names, for
each tensor dimension, the mesh axis that splits it, or None. Mesh axes the
spec does not name replicate the tensor. ``device_put`` splits a tensor
that way and ``Sharded.gather`` puts the pieces back together on the host.
``sum_in_order`` and ``mean_in_order`` are the one-process collectives: a
sum in device order onto one device.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Spec = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: an object array of ``torch.device`` whose shape is the
    mesh's; ``axis_names``: one name for each of its axes."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as the JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` at index 0 of every other axis: where
        a computation split over ``axis`` alone runs, once a shard."""
        index = tuple(slice(None) if name == axis else 0 for name in self.axis_names)
        return list(self.devices[index])


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current device>``, so that equal devices compare
    equal; any other device as it is."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data", "space"),
              devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """A mesh over ``devices`` (default: every visible card, else the CPU).

    Default shape: all devices on the first axis (``data``), the others 1.
    Pass an explicit shape like (4, 2) to split between frame-parallel and
    row-parallel axes; its product must be the number of devices."""
    if devices is None:
        from dither_pie_tpu_torch.parallel.auto import local_devices

        devices = local_devices(torch.device("cuda" if torch.cuda.is_available() else "cpu"))
    devs = [_indexed(torch.device(d)) for d in devices]
    n = len(devs)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not match {n} devices")
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} has {len(shape)} axes, names {tuple(axis_names)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), tuple(axis_names))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A tensor's layout on ``mesh``: ``spec[d]`` is the mesh axis that
    splits tensor dimension d, or None; dimensions past the spec and mesh
    axes it does not name are whole."""

    mesh: Mesh
    spec: Spec


def frames_sharding(mesh: Mesh) -> NamedSharding:
    """(B, H, W, 3) frames: B over 'data', H over 'space'."""
    return NamedSharding(mesh, ("data", "space", None, None))


def replicated(mesh: Mesh) -> NamedSharding:
    """A whole copy on every device."""
    return NamedSharding(mesh, ())


def _positions(mesh: Mesh):
    """Every mesh index, in the row-major order of ``mesh.devices.flat``."""
    return itertools.product(*(range(n) for n in mesh.devices.shape))


def shard_slices(sharding: NamedSharding, shape: Sequence[int]) -> List[Tuple[slice, ...]]:
    """The piece of a tensor of ``shape`` that each mesh position holds,
    in ``mesh.devices.flat`` order; raises where an axis does not divide
    its dimension evenly."""
    mesh, spec = sharding.mesh, sharding.spec
    sizes = mesh.shape
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        if axis not in sizes:
            raise ValueError(f"spec {spec} names {axis!r}, not an axis of {mesh.axis_names}")
        if shape[dim] % sizes[axis]:
            raise ValueError(f"dimension {dim} of {tuple(shape)} does not divide over the "
                             f"{sizes[axis]} devices of mesh axis {axis!r}")
    out = []
    for pos in _positions(mesh):
        where = dict(zip(mesh.axis_names, pos))
        sl = []
        for dim, axis in enumerate(spec):
            if axis is None:
                sl.append(slice(None))
            else:
                step = shape[dim] // sizes[axis]
                sl.append(slice(where[axis] * step, (where[axis] + 1) * step))
        out.append(tuple(sl))
    return out


@dataclasses.dataclass
class Sharded:
    """A tensor laid out on a mesh: ``shards[k]`` lies on
    ``sharding.mesh.devices.flat[k]`` and holds that position's piece of
    the ``shape`` tensor."""

    shards: List[torch.Tensor]
    sharding: NamedSharding
    shape: Tuple[int, ...]

    def gather(self) -> torch.Tensor:
        """The whole tensor on the host, from one copy of each piece."""
        out = None
        for sl, shard in zip(shard_slices(self.sharding, self.shape), self.shards):
            piece = shard.cpu()
            if out is None:
                out = torch.empty(self.shape, dtype=piece.dtype)
            out[sl] = piece
        return out


def sum_in_order(values: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The sum of ``values`` in their order, on ``device``: the one-process
    form of a psum onto the mesh's first device."""
    acc = values[0].to(device).clone()
    for v in values[1:]:
        acc += v.to(device)
    return acc


def mean_in_order(values: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """``sum_in_order`` divided by the count (a tensor divisor: PyTorch's
    CUDA division by a Python scalar multiplies by its reciprocal)."""
    acc = sum_in_order(values, device)
    return acc / torch.tensor(float(len(values)), dtype=acc.dtype, device=device)


def device_put(x, sharding: NamedSharding) -> Sharded:
    """A host array or tensor placed on ``sharding``'s mesh: each position
    gets its piece, copied to its device."""
    t = torch.as_tensor(np.ascontiguousarray(x) if isinstance(x, np.ndarray) else x)
    slices = shard_slices(sharding, t.shape)
    shards = [t[sl].contiguous().to(dev)
              for sl, dev in zip(slices, sharding.mesh.devices.flat)]
    return Sharded(shards, sharding, tuple(t.shape))


def axis_pieces(x, mesh: Mesh, axis: str = "data") -> List[torch.Tensor]:
    """``x`` split along its first dimension over ``axis``: one piece on
    each of ``mesh.axis_devices(axis)``. ``x`` is a host array, a tensor,
    or a ``Sharded`` (whose pieces are used as they lie where it was placed
    over ``axis`` on this mesh)."""
    if isinstance(x, Sharded):
        if x.sharding.mesh is mesh and x.sharding.spec[:1] == (axis,):
            index = tuple(slice(None) if name == axis else 0 for name in mesh.axis_names)
            flat = np.arange(mesh.size).reshape(mesh.devices.shape)[index]
            return [x.shards[int(k)] for k in flat]
        x = x.gather()
    return device_put(x, NamedSharding(make_mesh((mesh.shape[axis],), (axis,),
                                                 mesh.axis_devices(axis)), (axis,))).shards

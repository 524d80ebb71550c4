"""The frames' copies between the host and the ditherer's device, in their
spans and counted.

Every dither path of the facade sends its frames with ``to_device`` and
takes its result back with ``to_host``: the spans ``transfer.h2d``,
``device.wait`` (CUDA only) and ``transfer.d2h``, and the counters
``transfer.h2d_bytes`` and ``transfer.d2h_bytes`` (``api/profiling.py``).
Palettes, maps, the link probe's copies, the k-means fit and the mesh's
shards move by their own copies and are not counted here.

Both copies of the video pipeline's batches run from and to page-locked
blocks of PyTorch's caching host allocator. ``pinned_array`` hands out
such a block as a numpy array, which the pipeline stacks its batch into;
``to_device`` sees that an array views such a block (``pinned_source``)
and sends it with a non-blocking copy on the current stream, from the
allocator's own tensor, so that the allocator records the copy's event and
recycles the block only once the copy has finished. Any other array (a
single image, a converted batch, the neural pixelizer's input) is sent
pageable, as before. The copy back from a CUDA tensor lands in a pinned
block (``pinned_block``, ``copy_back``), and that block is the array the
caller gets: no pageable copy and no second host copy. A block goes back
to the allocator's cache when the caller drops the last array that views
it, and a later request of the same size class reuses it, so a stream of
batches page-locks as many blocks as it holds at once, and no more. The
counters ``transfer.h2d_pinned_bytes`` and ``transfer.d2h_pinned_bytes``
(bytes sent from, or landed in, a pinned block) and
``transfer.pinned_blocks_new`` (blocks the cache had to page-lock anew)
show both. The link probe (``api/linkspeed.py``) times the copy back.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence, Union

import numpy as np
import torch

from dither_pie_tpu_torch.api.profiling import count, stage

# The two video workers may allocate at once; one allocation at a time keeps
# the change of the allocator's block count its own.
_alloc_lock = threading.Lock()


def pinned_source(frames: np.ndarray) -> Optional[torch.Tensor]:
    """``frames`` as a tensor over the page-locked block it views, or None.

    ``frames`` qualifies when it is C-contiguous and views (through any
    chain of numpy views) a pinned tensor's storage with the tensor's own
    dtype: an array of ``pinned_array``, or a slice or reshape of one. The
    tensor returned shares that storage, and so the allocator's block; a
    plain numpy array, or a view of a pageable tensor, gives None."""
    base = frames
    while isinstance(base, np.ndarray):
        base = base.base
    if (not isinstance(base, torch.Tensor) or not frames.flags.c_contiguous
            or not base.is_pinned() or base.numpy().dtype != frames.dtype):
        return None
    offset = (frames.ctypes.data - base.untyped_storage().data_ptr()) // frames.itemsize
    return base.as_strided((frames.size,), (1,), offset).view(frames.shape)


def to_device(frames: np.ndarray, device: Union[str, torch.device]) -> torch.Tensor:
    """The host array ``frames`` as a tensor on ``device`` (one copy).

    To a CUDA device, an array that views a pinned block (``pinned_source``)
    is sent with a non-blocking copy on the current stream, which the
    stream's later work is ordered after; the block's allocator holds the
    block until the copy has finished, whatever the caller drops meanwhile.
    Any other array is copied as ``torch.from_numpy(frames).to(device)``."""
    t = pinned_source(frames) if torch.device(device).type == "cuda" else None
    pinned = t is not None
    if not pinned:
        t = torch.from_numpy(frames)
    with stage("transfer.h2d"):
        out = t.to(device, non_blocking=pinned)
    count("transfer.h2d_bytes", t.nbytes)
    if pinned:
        count("transfer.h2d_pinned_bytes", t.nbytes)
    return out


def _pinned_empty(shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
    """An uninitialised page-locked host tensor from PyTorch's caching host
    allocator, which recycles a block once its last reference dies and
    every copy recorded on it has finished. Counts
    ``transfer.pinned_blocks_new``: the blocks the allocator page-locked
    anew for it (0 where its cache held one)."""
    torch.cuda.init()  # the allocator's stats read empty before it
    with _alloc_lock:
        before = torch.cuda.host_memory_stats().get("num_host_alloc", 0)
        buf = torch.empty(tuple(shape), dtype=dtype, pin_memory=True)
        new = torch.cuda.host_memory_stats()["num_host_alloc"] - before
    count("transfer.pinned_blocks_new", new)
    return buf


def pinned_block(t: torch.Tensor) -> torch.Tensor:
    """An uninitialised page-locked host tensor of ``t``'s shape and dtype
    (``_pinned_empty``)."""
    return _pinned_empty(t.shape, t.dtype)


def pinned_array(shape: Sequence[int], dtype) -> np.ndarray:
    """An uninitialised page-locked host array of ``shape`` and ``dtype``:
    a view of a pinned block (``_pinned_empty``), which ``to_device`` sends
    without a pageable copy. The block stays out of the allocator's reach
    while any array views it."""
    like = torch.from_numpy(np.empty(0, dtype))
    return _pinned_empty(shape, like.dtype).numpy()


def copy_back(t: torch.Tensor, buf: torch.Tensor) -> None:
    """Copy the CUDA tensor ``t`` into the pinned host tensor ``buf`` on the
    current stream and wait for the copy."""
    buf.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a host numpy array.

    A CPU tensor: ``t.cpu().numpy()``, a view of ``t``. A CUDA tensor: the
    current stream's work is waited for first (``device.wait``), then ``t``
    is copied into a pinned block (``transfer.d2h``), and the returned array
    is that block. It stays out of the allocator's reach until the caller
    drops every array that views it, and after that in the allocator's
    cache, page-locked, for a later copy of its size class (a block is
    rounded up to a power of two)."""
    if t.device.type != "cuda":
        with stage("transfer.d2h"):
            out = t.cpu().numpy()
        count("transfer.d2h_bytes", t.nbytes)
        return out
    buf = pinned_block(t)
    with stage("device.wait"):
        torch.cuda.current_stream(t.device).synchronize()
    with stage("transfer.d2h"):
        copy_back(t, buf)
        out = buf.numpy()
    count("transfer.d2h_bytes", t.nbytes)
    count("transfer.d2h_pinned_bytes", t.nbytes)
    return out

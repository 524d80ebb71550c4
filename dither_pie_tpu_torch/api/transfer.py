"""The frames' copies between the host and the ditherer's device, in their
spans and counted.

Every dither path of the facade sends its frames with ``to_device`` and
takes its result back with ``to_host``: the spans ``transfer.h2d``,
``device.wait`` (CUDA only) and ``transfer.d2h``, and the counters
``transfer.h2d_bytes`` and ``transfer.d2h_bytes`` (``api/profiling.py``).
Palettes, maps, the link probe's copies, the k-means fit and the mesh's
shards move by their own copies and are not counted here.

The send is pageable. The copy back from a CUDA tensor lands in a
page-locked block of PyTorch's caching host allocator (``pinned_block``,
``copy_back``), and that block is the array the caller gets: no pageable
copy and no second host copy. The block goes back to the allocator's cache
when the caller drops the last array that views it, and a later copy of
the same size class reuses it, so a stream of batches page-locks as many
blocks as it holds results at once, and no more. The counters
``transfer.d2h_pinned_bytes`` (bytes that landed in a pinned block) and
``transfer.pinned_blocks_new`` (blocks the cache had to page-lock anew)
show both. The link probe (``api/linkspeed.py``) times the same copy.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from dither_pie_tpu_torch.api.profiling import count, stage

# The two video workers may allocate at once; one allocation at a time keeps
# the change of the allocator's block count its own.
_alloc_lock = threading.Lock()


def to_device(frames: np.ndarray, device: torch.device) -> torch.Tensor:
    """The host array ``frames`` as a tensor on ``device`` (one copy)."""
    t = torch.from_numpy(frames)
    with stage("transfer.h2d"):
        out = t.to(device)
    count("transfer.h2d_bytes", t.nbytes)
    return out


def pinned_block(t: torch.Tensor) -> torch.Tensor:
    """An uninitialised page-locked host tensor of ``t``'s shape and dtype,
    from PyTorch's caching host allocator, which recycles a block once its
    last reference dies. Counts ``transfer.pinned_blocks_new``: the blocks
    the allocator page-locked anew for it (0 where its cache held one)."""
    with _alloc_lock:
        before = torch.cuda.host_memory_stats()["num_host_alloc"]
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        new = torch.cuda.host_memory_stats()["num_host_alloc"] - before
    count("transfer.pinned_blocks_new", new)
    return buf


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

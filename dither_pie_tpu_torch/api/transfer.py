"""The frames' copies between the host and the ditherer's device, in their
spans and counted.

Every dither path of the facade sends its frames with ``to_device`` and
takes its result back with ``to_host``: the spans ``transfer.h2d``,
``device.wait`` (CUDA only) and ``transfer.d2h``, and the counters
``transfer.h2d_bytes`` and ``transfer.d2h_bytes`` (``api/profiling.py``).
Palettes, maps, the link probe, the k-means fit and the mesh's shards move
by their own copies and are not counted here.
"""

from __future__ import annotations

import numpy as np
import torch

from dither_pie_tpu_torch.api.profiling import count, stage


def to_device(frames: np.ndarray, device: torch.device) -> torch.Tensor:
    """The host array ``frames`` as a tensor on ``device`` (one copy)."""
    t = torch.from_numpy(frames)
    with stage("transfer.h2d"):
        out = t.to(device)
    count("transfer.h2d_bytes", t.nbytes)
    return out


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a host numpy array. On a CUDA device the current stream's
    work is waited for first (``device.wait``), as the copy would wait for
    it, so ``transfer.d2h`` holds the copy alone."""
    if t.device.type == "cuda":
        with stage("device.wait"):
            torch.cuda.current_stream(t.device).synchronize()
    with stage("transfer.d2h"):
        out = t.cpu().numpy()
    count("transfer.d2h_bytes", t.nbytes)
    return out

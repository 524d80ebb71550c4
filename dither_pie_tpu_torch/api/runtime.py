"""Device policy: which ``torch.device`` a call runs on.

The device is always explicit. ``"cuda"`` runs the hand-written Hopper
kernels, ``"cpu"`` runs their plain PyTorch versions; which implementation
runs is a pure function of the tensor's device. Nothing probes, guesses or
downgrades: asking for CUDA on a machine without a GPU raises.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    """``device`` as a ``torch.device``; raises ``RuntimeError`` for a CUDA
    device this machine does not have, ``ValueError`` for any device type
    other than cuda and cpu."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain PyTorch versions")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(device)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")

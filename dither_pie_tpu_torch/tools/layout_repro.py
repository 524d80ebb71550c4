#!/usr/bin/env python3
"""Probe: what several large u8 NHWC batches cost once planarised, and the
card's copy rate through a hand-written identity kernel.

    python3 dither_pie_tpu_torch/tools/layout_repro.py [n_params] [batch] [--chain]

The JAX package's ``tools/xla_layout_repro.py`` watches for a compiler
fault: programs holding several ~600 MB (B, H, W, 3) uint8 parameters got
their NHWC -> planar copy assigned a channel-minor layout and padded 42x.
PyTorch assigns no layouts (a tensor's layout is its strides), so the
port's counterpart is the regression probe of the same shapes: it
planarises ``n_params`` (batch, 1080, 1920, 3) u8 batches with
``permute(3, 0, 1, 2).contiguous()``, feeds each (3, B*H, W) plane through
the identity kernel (``kernels/csrc/identity.cu``), and prints

* the temporary allocation, ``torch.cuda.max_memory_allocated`` less the
  arguments and the outputs, as a multiple of the arguments' bytes (a sane
  planar copy is one plane, 1/n_params of the arguments; 42x would be the
  fault), and the outputs' share;
* the identity kernel's GB/s on one plane (read + written bytes over its
  median time), beside ``Tensor.clone()``'s: the measured copy ceiling of
  this card.

``--chain`` is the harness that failed originally: the batches chained
through the ordered kernel K4 (``ordered_dither_fused``, a random 16-colour
palette, the Bayer 8x8 screen), each launch's palette carrying the running
sum of the output before it in ``pal[0, 0]`` so that no launch can be
dropped.

Defaults: 3 batches of 100 frames. The identity wrapper launches its kernel
for a CUDA tensor and runs ``Tensor.clone()`` for a CPU tensor. The
measurement needs a CUDA device.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

if __name__ == "__main__":  # run as a script: find the package beside it
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from dither_pie_tpu_torch.core.thresholds import bayer_matrix  # noqa: E402
from dither_pie_tpu_torch.kernels import build  # noqa: E402
from dither_pie_tpu_torch.ops.ordered import screen_for_matrix  # noqa: E402
from dither_pie_tpu_torch.ops.ordered_fused import ordered_dither_fused  # noqa: E402
from dither_pie_tpu_torch.tools.proto_mxu_search import _cuda_ms, card_line  # noqa: E402

FULL_H, FULL_W = 1080, 1920


def identity_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch identity copy."""
    return x.clone()


def identity_copy(x: torch.Tensor) -> torch.Tensor:
    """The identity kernel on a CUDA tensor, ``clone()`` on a CPU tensor:
    a new contiguous uint8 tensor with ``x``'s bytes."""
    if x.dtype != torch.uint8:
        raise TypeError(f"identity_copy takes uint8 tensors, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("identity_copy takes a contiguous tensor")
    if not build.on_cuda(x):
        return identity_plain(x)
    out = torch.empty_like(x)
    if x.numel():
        build.extension().identity_u8(x, out)
        build.LAUNCHES["identity"] += 1
    return out


def planarize(frames: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) u8 -> (3, B*H, W) planes: the transpose copy."""
    b, h, w, _ = frames.shape
    return frames.permute(3, 0, 1, 2).contiguous().view(3, b * h, w)


def _filled(n_params: int, batch: int, h: int, w: int, device) -> List[torch.Tensor]:
    """The arguments: batch i filled with the value i on the device (the
    values do not matter to a copy)."""
    return [torch.full((batch, h, w, 3), i, dtype=torch.uint8, device=device)
            for i in range(n_params)]


def _peak_over_args(device, base: int) -> int:
    """Bytes allocated at the peak beyond ``base`` (0 on the CPU, which
    keeps no such count)."""
    if device.type != "cuda":
        return 0
    return torch.cuda.max_memory_allocated(device) - base


def _mark(device) -> int:
    if device.type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    return torch.cuda.memory_allocated(device)


def harness(n_params: int, batch: int, device, h: int = FULL_H, w: int = FULL_W) -> Dict:
    """Planarise ``n_params`` batches and copy each plane through the
    identity. Returns the planes, the arguments' and outputs' bytes and the
    temporary bytes at the peak."""
    device = torch.device(device)
    frames = _filled(n_params, batch, h, w, device)
    arg_bytes = sum(f.numel() for f in frames)
    base = _mark(device)
    outs = [identity_copy(planarize(f)) for f in frames]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    out_bytes = sum(o.numel() for o in outs)
    temp_bytes = max(_peak_over_args(device, base) - out_bytes, 0)
    return {"outs": outs, "arg_bytes": arg_bytes, "out_bytes": out_bytes,
            "temp_bytes": temp_bytes}


def chain(n_params: int, batch: int, device, h: int = FULL_H, w: int = FULL_W) -> Dict:
    """``n_params`` distinct batches chained through K4: each launch's
    palette holds the running sum of the output before it. The temporary
    bytes at the peak are K4's uint8 output and whatever ``Tensor.sum()``
    allocates to add it up."""
    device = torch.device(device)
    pal = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (16, 3))
                           .astype(np.float32)).to(device)
    screen = screen_for_matrix(bayer_matrix("8x8"), h, w, device)
    frames = _filled(n_params, batch, h, w, device)
    arg_bytes = sum(f.numel() for f in frames)
    base = _mark(device)
    acc = torch.zeros((), dtype=torch.float32, device=device)
    for fr in frames:
        step_pal = pal.clone()
        step_pal[0, 0] = acc
        out = ordered_dither_fused(fr, step_pal, screen)
        acc = out.sum().to(torch.float32) * 1e-12
    value = float(acc)  # waits for the device
    return {"acc": value, "arg_bytes": arg_bytes,
            "temp_bytes": _peak_over_args(device, base)}


def copy_rate(batch: int, device, h: int = FULL_H, w: int = FULL_W) -> Dict[str, float]:
    """GB/s (read + written bytes) of the identity kernel and of
    ``clone()`` on one (3, batch*h, w) plane, medians of 7."""
    plane = planarize(_filled(1, batch, h, w, torch.device(device))[0])
    moved = 2 * plane.numel()
    ms = _cuda_ms(lambda: identity_copy(plane), 7)
    clone_ms = _cuda_ms(lambda: identity_plain(plane), 7)
    return {"ms": ms, "gb_s": moved / ms / 1e6, "clone_ms": clone_ms,
            "clone_gb_s": moved / clone_ms / 1e6, "bytes": plane.numel()}


def main() -> int:
    if not torch.cuda.is_available():
        print("layout_repro: no CUDA device", file=sys.stderr)
        return 2
    args = [a for a in sys.argv[1:] if not a.startswith("-")]
    n_params = int(args[0]) if args else 3
    batch = int(args[1]) if len(args) > 1 else 100
    device = torch.device("cuda")
    card = card_line()
    if "--chain" in sys.argv:
        r = chain(n_params, batch, device)
        print(f"chain: params={n_params} batch={batch} args={r['arg_bytes'] / 1e9:.2f} GB "
              f"[{card}]")
        print(f"temp allocation: {r['temp_bytes'] / 1e9:.2f} GB "
              f"({r['temp_bytes'] / max(r['arg_bytes'], 1):.1f}x of args)")
        print("executed ok:", r["acc"])
        return 0
    r = harness(n_params, batch, device)
    print(f"params={n_params} batch={batch} args={r['arg_bytes'] / 1e9:.2f} GB "
          f"[identity operands] [{card}]")
    print(f"temp allocation: {r['temp_bytes'] / 1e9:.2f} GB "
          f"({r['temp_bytes'] / max(r['arg_bytes'], 1):.1f}x of args); "
          f"output: {r['out_bytes'] / 1e9:.2f} GB "
          f"({r['out_bytes'] / max(r['arg_bytes'], 1):.1f}x)")
    print("executed ok,", len(r["outs"]), "planes of", tuple(r["outs"][0].shape))
    del r
    c = copy_rate(batch, device)
    print(f"identity: {c['ms']:.3f} ms for a plane of {c['bytes'] / 1e6:.1f} MB = "
          f"{c['gb_s']:.1f} GB/s read + written; clone(): {c['clone_ms']:.3f} ms = "
          f"{c['clone_gb_s']:.1f} GB/s [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Probe: what several large u8 NHWC batches cost once planarised, and the
card's copy rate through a hand-written identity kernel.

    python3 dither_pie_tpu_torch/tools/layout_repro.py [n_params] [batch] [--chain]
    python3 dither_pie_tpu_torch/tools/layout_repro.py [batch] --sweep

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

``--sweep`` times the identity kernel's stride form on one
(3, batch*1080, 1920) plane into one output at several grid sizes (blocks
an SM, and a block for every 256 words, the default), with ``clone()``
first and last, each the median of 5 runs of 20 launches in a row
(``time_ed_path.loop_ms``), every output held to the plane bitwise.

``--chain`` is the harness that failed originally: the batches chained
through the ordered kernel K4 (``ordered_dither_fused``, a random 16-colour
palette, the Bayer 8x8 screen), each launch's palette carrying the running
sum of the output before it in ``pal[0, 0]`` so that no launch can be
dropped.

Defaults: 3 batches of 100 frames. The identity wrapper launches its kernel
for a CUDA tensor and runs ``Tensor.clone()`` for a CPU tensor. The
measurement needs a CUDA device.

The kernel's launch is planned here (``identity_plan``): a head of up to 15
bytes that brings the output to a 16-byte boundary, a body of whole 16-byte
words, and a tail of up to 15 bytes. Where input and output agree mod 16
the body goes through the stride form, a grid-stride loop of 16-byte words
whose grid by default covers the body in one step; where they disagree,
through the shifted form, whose spans a persistent grid of a few blocks an
SM takes in turn (block b spans b, b + G, ...). The kernel refuses any
other plan.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

if __name__ == "__main__":  # run as a script: find the package beside it
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from dither_pie_tpu_torch.core.thresholds import bayer_matrix  # noqa: E402
from dither_pie_tpu_torch.kernels import build  # noqa: E402
from dither_pie_tpu_torch.ops.ordered import screen_for_matrix  # noqa: E402
from dither_pie_tpu_torch.ops.ordered_fused import ordered_dither_fused  # noqa: E402
from dither_pie_tpu_torch.tools.proto_mxu_search import _cuda_ms, card_line  # noqa: E402
from dither_pie_tpu_torch.tools.time_ed_path import loop_ms  # noqa: E402

FULL_H, FULL_W = 1080, 1920


# The body's forms, in the kernel's order: a grid-stride loop of 16-byte
# words where input and output agree mod 16, the shifted form where they
# disagree.
IDENTITY_FORMS = ("stride", "shifted")
# The grid of each form, in blocks an SM: the stride form's ALL_STEPS is a
# block for every 256 words of the body, each thread one word (on an H100
# as fast as clone(), and grids of 4 to 512 blocks an SM that loop were
# 1-6 % slower: ``--sweep``, PERF.md); the shifted form's persistent grid.
# Bytes of a shifted span, threads a block.
ALL_STEPS = 0
IDENTITY_BLOCKS_PER_SM = {"stride": ALL_STEPS, "shifted": 4}
IDENTITY_SPAN = 16384
IDENTITY_THREADS = 256
_MAX_GRID = (1 << 31) - 1


@dataclass(frozen=True)
class IdentityPlan:
    """One launch of the identity kernel: ``head`` bytes one by one until the
    output is 16-byte aligned, ``body`` bytes of whole 16-byte words, the
    rest one by one, on ``blocks`` blocks of ``threads``; the body's
    ``form``, and for the shifted form its spans of ``span`` bytes (the
    last may be shorter; 0 in the stride form and without a body), which
    the blocks take in turn (block b spans b, b + blocks, ...)."""

    form: str
    head: int
    body: int
    span: int
    blocks: int
    threads: int = IDENTITY_THREADS


def identity_form(in_mod16: int, out_mod16: int) -> str:
    """The body's form for an input and an output at these offsets mod 16."""
    return IDENTITY_FORMS[in_mod16 != out_mod16]


def identity_plan(n: int, in_mod16: int, out_mod16: int, blocks: int,
                  span: int = IDENTITY_SPAN) -> IdentityPlan:
    """The launch that copies ``n`` bytes from an input ``in_mod16`` bytes past
    a 16-byte boundary to an output ``out_mod16`` bytes past one, over at
    most ``blocks`` blocks: the stride form where the two agree mod 16, at
    most one block a 256 words of the body; the shifted form where they
    disagree, the body cut on 16-byte boundaries into spans of ``span``
    bytes, at most one block a span."""
    if n < 0 or blocks < 1 or not (0 <= in_mod16 < 16 and 0 <= out_mod16 < 16):
        raise ValueError(f"no identity plan for n={n} offsets {in_mod16}, {out_mod16} "
                         f"blocks={blocks}")
    if span % 16 or span < 16:
        raise ValueError(f"spans are whole 16-byte words, got {span}")
    form = identity_form(in_mod16, out_mod16)
    head = min(n, -out_mod16 % 16)
    body = (n - head) // 16 * 16
    if form == "stride" or not body:
        span = 0
    if not body:
        return IdentityPlan(form, head, body, span, 1)
    units = -(-body // 16 // IDENTITY_THREADS) if form == "stride" else -(-body // span)
    return IdentityPlan(form, head, body, span, min(blocks, units))


def identity_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch identity copy."""
    return x.clone()


def _launch(x: torch.Tensor, out: torch.Tensor, plan: IdentityPlan) -> None:
    build.extension().identity_u8(x, out, IDENTITY_FORMS.index(plan.form), plan.head,
                                  plan.body, plan.span, plan.blocks, plan.threads)
    build.count_launch("identity")


def _grid(x: torch.Tensor, blocks_per_sm: int) -> int:
    """At most ``blocks_per_sm`` blocks on each SM of ``x``'s card; as many
    as the plan can use for ALL_STEPS."""
    if blocks_per_sm == ALL_STEPS:
        return _MAX_GRID
    return blocks_per_sm * torch.cuda.get_device_properties(x.device).multi_processor_count


def identity_copy(x: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The identity kernel on a CUDA tensor, ``clone()`` on a CPU tensor:
    a new contiguous uint8 tensor with ``x``'s bytes (or ``out``, a
    contiguous uint8 tensor of ``x``'s shape at any address, filled)."""
    if x.dtype != torch.uint8:
        raise TypeError(f"identity_copy takes uint8 tensors, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("identity_copy takes a contiguous tensor")
    if not build.on_cuda(x):
        if out is None:
            return identity_plain(x)
        return out.copy_(x)
    if out is None:
        out = torch.empty_like(x)
    if x.numel():
        in16, out16 = x.data_ptr() % 16, out.data_ptr() % 16
        blocks = _grid(x, IDENTITY_BLOCKS_PER_SM[identity_form(in16, out16)])
        _launch(x, out, identity_plan(x.numel(), in16, out16, blocks))
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


# The stride form's grid sizes ``--sweep`` times, in blocks an SM.
SWEEP_BLOCKS_PER_SM = (4, 16, 64, 128, 256, 512, ALL_STEPS)


def sweep(batch: int, device, card: str) -> bool:
    """Print the time of the stride form at each grid size beside
    ``clone()``'s; False if an output differs from the plane."""
    gen = torch.Generator(device).manual_seed(0)
    plane = planarize(torch.randint(0, 256, (batch, FULL_H, FULL_W, 3), dtype=torch.uint8,
                                    device=device, generator=gen))
    out = torch.empty_like(plane)

    def stride(k):
        plan = identity_plan(plane.numel(), 0, 0, _grid(plane, k))
        what = "a block a step" if k == ALL_STEPS else f"{k} blocks an SM"
        return (f"stride, {what} ({plan.blocks} blocks)",
                lambda: (_launch(plane, out, plan), out)[1])

    cases = [("clone()", lambda: plane.clone())]
    cases += [stride(k) for k in SWEEP_BLOCKS_PER_SM]
    cases.append(cases[0])
    print(f"identity sweep: the stride form at {len(SWEEP_BLOCKS_PER_SM)} grid sizes between "
          f"two clone() [{card}]", flush=True)
    ok = True
    for label, fn in cases:
        ms = loop_ms(fn, 20)
        same = torch.equal(fn(), plane)
        ok &= same
        print(f"identity sweep, one {tuple(plane.shape)} u8 plane: {label}: {ms:.5f} ms = "
              f"{2 * plane.numel() / ms / 1e6:.1f} GB/s, == plane {same} [{card}]", flush=True)
    return ok


def main() -> int:
    if not torch.cuda.is_available():
        print("layout_repro: no CUDA device", file=sys.stderr)
        return 2
    args = [a for a in sys.argv[1:] if not a.startswith("-")]
    device = torch.device("cuda")
    card = card_line()
    if "--sweep" in sys.argv:
        return 0 if sweep(int(args[0]) if args else 100, device, card) else 1
    n_params = int(args[0]) if args else 3
    batch = int(args[1]) if len(args) > 1 else 100
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

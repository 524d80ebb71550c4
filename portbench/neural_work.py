"""The work of the neural pixelizer, and the readers of the neural stream.

The FLOP count of one frame's forward through C2PGen(3, 3, 64, n_down=2,
n_res=4, style=256, mlp=256) and AliasNet(3, 3, 64, 2, 3) at the net's
input size, from the layer list alone: a convolution of a k x k kernel
from Cin to Cout channels over an Hout x Wout output counts
2 * k * k * Cin * Cout * Hout * Wout (a multiply and an add a tap), the
same whatever implements it. Left out: the style code (computed once for
the style image, not a frame), biases, norms, activations, pads and
resizes (a few operations an element). AliasNet's final 7x7 conv counts
at the /4 samples only, the work the output needs: the pixelized frame
keeps one pixel of each 4 x 4 block.

The peak is NVIDIA's data sheet's, H100 SXM at its 700 W limit: bf16 on
the tensor cores, dense, the configuration's precision (float32 outside
them is ``roofline.PEAK_F32_FLOPS``, 67 TFLOP/s).

The span and rate readers of the traffic kind "neural_stream" live here,
since ``spans.py`` and ``readers.py`` know only their own kinds.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from portbench import stats
from portbench.readers import Context

KIND = "neural_stream"
PEAK_BF16_FLOPS = 989.4e12
# The dither's kernels K1, K2 and K3 (``kernels/csrc/skew.cu``,
# ``ed_scan.cu``, ``unskew_unpack.cu``), by the names the trace gives them;
# every other kernel of the neural stream's window is the forward's.
DITHER_KERNELS = ("skew_tile_kernel", "ed_scan_kernel", "unskew_tile_kernel")

Layer = Tuple[str, int, int, int, int, int]  # name, k, cin, cout, hout, wout


def net_input(h: int, w: int, max_size: int) -> Tuple[int, int]:
    """The net's input (height, width) for an (h, w) frame: the short side
    NEAREST-resized to 4 * max_size (the long side truncated), then each
    side rounded to a multiple of 4 (Python's round, halves to even)."""
    side = 4 * max_size
    if w < h:
        nw, nh = side, int(side / (w / h))
    else:
        nh, nw = side, int(side * (w / h))
    return int(round(nh / 4) * 4), int(round(nw / 4) * 4)


def _encoder(prefix: str, h: int, w: int, n_res: int) -> List[Layer]:
    """7x7 stem, two 4x4 stride-2 downs, n_res resblocks of two 3x3 convs."""
    out = [(f"{prefix}.stem", 7, 3, 64, h, w),
           (f"{prefix}.down1", 4, 64, 128, h // 2, w // 2),
           (f"{prefix}.down2", 4, 128, 256, h // 4, w // 4)]
    out += [(f"{prefix}.res{i // 2}.conv{i % 2}", 3, 256, 256, h // 4, w // 4)
            for i in range(2 * n_res)]
    return out


def _decoder_tail(prefix: str, h: int, w: int, last_stride: int) -> List[Layer]:
    """Two 2x upsamples each before a 5x5 conv, then the 7x7 conv to RGB
    at stride ``last_stride``."""
    return [(f"{prefix}.conv_1", 5, 256, 128, h // 2, w // 2),
            (f"{prefix}.conv_2", 5, 128, 64, h, w),
            (f"{prefix}.conv_3", 7, 64, 3, h // last_stride, w // last_stride)]


def layers(h: int, w: int) -> List[Layer]:
    """Every convolution one frame of (h, w) runs through: C2PGen's content
    encoder and decoder (8 modulated 3x3 convs), then AliasNet."""
    out = _encoder("c2pgen.enc", h, w, 4)
    out += [(f"c2pgen.dec.mod_conv{i}", 3, 256, 256, h // 4, w // 4) for i in range(8)]
    out += _decoder_tail("c2pgen.dec", h, w, 1)
    out += _encoder("alias.enc", h, w, 3)
    out += [(f"alias.dec.res{i // 2}.conv{i % 2}", 3, 256, 256, h // 4, w // 4)
            for i in range(6)]
    out += _decoder_tail("alias.dec", h, w, 4)
    return out


def conv_flops(k: int, cin: int, cout: int, hout: int, wout: int) -> int:
    return 2 * k * k * cin * cout * hout * wout


def frame_flops(h: int, w: int) -> int:
    """FLOPs of one frame's forward at the net's input size (h, w)."""
    return sum(conv_flops(*layer[1:]) for layer in layers(h, w))


def least_s(flops: float) -> float:
    """The least time the card could take for ``flops`` at the bf16 peak."""
    return flops / PEAK_BF16_FLOPS


def span_ms_per_batch(ctx: Context, name: str) -> Optional[float]:
    """The summed length of the program's ``name`` spans inside the traced
    window, each clipped to it, over the window's batches, in ms; None
    outside the kind, untraced, or where no such span reaches into the
    window (a program without it)."""
    if ctx.kind != KIND or ctx.trace is None or not ctx.counters.get("batches"):
        return None
    lo, hi = ctx.trace.window
    clipped = [min(e, hi) - max(s, lo) for s, e in ctx.trace.spans(name)]
    clipped = [d for d in clipped if d > 0]
    if not clipped:
        return None
    return sum(clipped) / ctx.counters["batches"] * 1e-6


def frames_per_s(ctx: Context) -> Optional[float]:
    """Frames emitted inside the window over its length."""
    if ctx.kind != KIND or not ctx.latencies or ctx.seconds <= 0:
        return None
    return stats.rate(len(ctx.latencies), ctx.seconds)


def mfu_pct(ctx: Context) -> Optional[float]:
    """The model FLOPs of the frames emitted inside the window over the
    window's seconds, as a share of the bf16 peak, in %."""
    fps = frames_per_s(ctx)
    if fps is None or not ctx.counters.get("frame_flops"):
        return None
    return fps * ctx.counters["frame_flops"] / PEAK_BF16_FLOPS * 100.0


def forward_device_s(ctx: Context) -> float:
    """Summed device time, clipped to the window, of the window's kernels
    that are not the dither's K1, K2 or K3, in seconds."""
    lo, hi = ctx.trace.window
    total = 0
    for op in ctx.trace.device:
        name, kind, s, e = op[:4]
        if kind == "kernel" and not any(k in name for k in DITHER_KERNELS):
            total += max(0, min(e, hi) - max(s, lo))
    return total * 1e-9


def roofline_pct(ctx: Context) -> Optional[float]:
    """The forwards' least time (the handed frames' FLOPs at the bf16 peak)
    over the device time of every kernel in the window but the dither's,
    in %."""
    if (ctx.kind != KIND or ctx.trace is None or not ctx.counters.get("frames")
            or not ctx.counters.get("frame_flops")):
        return None
    busy = forward_device_s(ctx)
    if busy <= 0:
        return None
    return least_s(ctx.counters["frames"] * ctx.counters["frame_flops"]) / busy * 100.0

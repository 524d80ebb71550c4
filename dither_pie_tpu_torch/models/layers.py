"""Building blocks of the neural pixelizer, NCHW, with the reference
checkpoints' state-dict keys and tensor layouts.

The modules (ConvBlock, ResBlock, ResBlocks, LinearBlock,
ModulationConvBlock) hold their weights under the reference's names
(``conv.weight``, ``norm.gamma``, ``fc.weight``, ...), so a reference
state dict loads with ``load_state_dict``. Their forwards are the JAX
package's functional layers, quirks included:

* the reference LayerNorm normalises each sample over ALL axes with the
  UNBIASED std and divides by (std + eps), then a per-channel affine;
* InstanceNorm has no affine, eps 1e-5 and the biased variance;
* ModulationConvBlock keeps its (O, I, k, k) weight and reads it through
  the reference's raw-buffer view as (k, k, I, O), modulates it by the
  style code over I, demodulates per (sample, O), convolves (one dense
  conv for a shared (1, I) code, a grouped conv for per-sample codes),
  adds the bias and applies LeakyReLU(0.2) * sqrt(2).

Precision. ``precision_scope`` sets cuDNN's TF32 switch (and the float32
matmul precision) for the calls inside it and restores them after:
"float32" (the parity contract) turns TF32 off, "tensorfloat32" on;
"bfloat16" additionally runs inside ``bf16_activations(True)``, where
convolution and linear operands and activations are bfloat16 and every
norm takes its statistics in float32. cuDNN's autotuner stays off.
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

PRECISIONS = ("float32", "tensorfloat32", "bfloat16")

# Thread-local: the video pipeline runs the pixelizer on its main thread
# while its workers dither.
_tls = threading.local()


@contextlib.contextmanager
def bf16_activations(on: bool):
    prev = getattr(_tls, "bf16_act", False)
    _tls.bf16_act = bool(on)
    try:
        yield
    finally:
        _tls.bf16_act = prev


def _act_fast() -> bool:
    return getattr(_tls, "bf16_act", False)


@contextlib.contextmanager
def precision_scope(precision: str):
    """cuDNN's TF32 switch and torch's float32 matmul precision as
    ``precision`` asks, for the calls inside; both are restored after.
    PyTorch's default ``cudnn.allow_tf32`` is True, so a float32 conv
    outside this scope runs TF32 on the card."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}: use one of {PRECISIONS}")
    tf32 = precision == "tensorfloat32"
    prev_mm = torch.get_float32_matmul_precision()
    want_mm = "high" if tf32 else "highest"
    prev_scope = getattr(_tls, "precision", None)
    if prev_mm != want_mm:
        torch.set_float32_matmul_precision(want_mm)
    _tls.precision = precision
    try:
        with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                        benchmark=False,
                                        deterministic=torch.backends.cudnn.deterministic,
                                        allow_tf32=tf32):
            yield
    finally:
        _tls.precision = prev_scope
        if prev_mm != want_mm:
            torch.set_float32_matmul_precision(prev_mm)


def parity_precision(fn):
    """Run ``fn`` in ``precision_scope("float32")`` unless a scope is
    already open: a building block called on its own keeps the parity
    contract instead of the card's TF32 default."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if getattr(_tls, "precision", None) is not None:
            return fn(*args, **kwargs)
        with precision_scope("float32"):
            return fn(*args, **kwargs)

    return wrapped


def _fold_reflect(g: torch.Tensor, p: int, dim: int) -> torch.Tensor:
    """The gradient of a reflect pad of ``p`` along ``dim``: padded index
    i < p mirrors input index p - i, padded index p + n + k input index
    n - 2 - k; their gradients are added to those entries in a fixed
    order."""
    n = g.shape[dim] - 2 * p
    core = g.narrow(dim, p, n).clone()
    core.narrow(dim, 1, p).add_(g.narrow(dim, 0, p).flip(dim))
    core.narrow(dim, n - 1 - p, p).add_(g.narrow(dim, p + n, p).flip(dim))
    return core


class _ReflectPad2d(torch.autograd.Function):
    """``F.pad(x, (p, p, p, p), mode="reflect")`` with a deterministic
    backward: CUDA's reflect-pad backward adds the up to four gradients of
    a border entry with atomics in any order, so two runs of a train step
    differ in the last bits."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, p: int) -> torch.Tensor:
        ctx.p = p
        return F.pad(x, (p, p, p, p), mode="reflect")

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _fold_reflect(_fold_reflect(g, ctx.p, 3), ctx.p, 2), None


def pad2d(x: torch.Tensor, pad: int, pad_type: str) -> torch.Tensor:
    if pad == 0:
        return x
    if pad_type == "reflect":
        return _ReflectPad2d.apply(x, pad)
    mode = "replicate" if pad_type == "replicate" else "constant"
    return F.pad(x, (pad, pad, pad, pad), mode=mode)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           stride: int = 1) -> torch.Tensor:
    """VALID convolution of NCHW ``x`` by OIHW ``w``, then the bias."""
    if _act_fast():
        x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    out = F.conv2d(x, w, None, stride)
    if b is not None:
        out = out + b.to(out.dtype)[:, None, None]
    return out


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-(sample, channel) normalisation over H, W; no affine. Statistics
    always in float32."""
    xf = x.float()
    mean = xf.mean((2, 3), keepdim=True)
    var = ((xf - mean) ** 2).mean((2, 3), keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def custom_layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """The reference LayerNorm: per sample over all axes, UNBIASED std,
    divide by (std + eps), per-channel affine. Statistics in float32."""
    b = x.shape[0]
    xf = x.float()
    flat = xf.reshape(b, -1)
    mean = flat.mean(1)
    std = torch.sqrt(((flat - mean[:, None]) ** 2).sum(1) / (flat.shape[1] - 1))
    xn = (xf - mean[:, None, None, None]) / (std + eps)[:, None, None, None]
    return (xn * gamma[None, :, None, None] + beta[None, :, None, None]).to(x.dtype)


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "relu":
        return F.relu
    if name == "lrelu":
        return lambda x: F.leaky_relu(x, 0.2)
    if name == "tanh":
        return torch.tanh
    if name == "selu":
        return F.selu
    if name == "none":
        return lambda x: x
    raise ValueError(f"unsupported activation {name}")


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class LayerNorm(nn.Module):
    """Holds the reference LayerNorm's affine (``gamma``, ``beta``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))


class ConvBlock(nn.Module):
    """The reference ConvBlock / AliasConvBlock: pad -> conv -> norm ->
    activation. ``norm``: "in", "ln" or "none"."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, pad: int,
                 norm: str = "none", act: str = "relu", pad_type: str = "zero"):
        super().__init__()
        if norm not in ("in", "ln", "none"):
            raise ValueError(f"unsupported norm {norm}")
        self.stride, self.pad, self.pad_type = stride, pad, pad_type
        self.norm_type, self.act = norm, act
        self.conv = nn.Conv2d(cin, cout, k)
        if norm == "ln":
            self.norm = LayerNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = pad2d(x, self.pad, self.pad_type)
        x = conv2d(x, self.conv.weight, self.conv.bias, self.stride)
        if self.norm_type == "in":
            x = instance_norm(x)
        elif self.norm_type == "ln":
            x = custom_layer_norm(x, self.norm.gamma, self.norm.beta)
        return activation(self.act)(x)


class ResBlock(nn.Module):
    def __init__(self, dim: int, norm: str, act: str, pad_type: str):
        super().__init__()
        self.model = nn.Sequential(ConvBlock(dim, dim, 3, 1, 1, norm, act, pad_type),
                                   ConvBlock(dim, dim, 3, 1, 1, norm, "none", pad_type))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x) + x


class ResBlocks(nn.Module):
    def __init__(self, n: int, dim: int, norm: str, act: str, pad_type: str):
        super().__init__()
        self.model = nn.Sequential(*[ResBlock(dim, norm, act, pad_type) for _ in range(n)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class LinearBlock(nn.Module):
    def __init__(self, cin: int, cout: int, act: str):
        super().__init__()
        self.act = act
        self.fc = nn.Linear(cin, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.fc.weight, self.fc.bias
        if _act_fast():
            x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
        return activation(self.act)(F.linear(x, w) + b.to(x.dtype))


class ModulationConvBlock(nn.Module):
    """StyleGAN2-style modulated conv (the reference ModulationConvBlock).

    ``weight`` is the reference's (O, I, k, k) buffer, read through its raw
    view as (k, k, I, O). ``code``: (B, I), or (1, I) with B > 1 (one style
    for the whole batch: the modulated weight is the same for every sample
    and one dense conv replaces B grouped ones)."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
        o, i, k, _ = self.weight.shape
        w = self.weight.reshape(k, k, i, o)  # the raw view
        wscale = 1.0 / math.sqrt(k * k * i)
        # Modulation and demodulation always in float32 (tiny tensors).
        wm = (w * wscale)[None].float() * code[:, None, None, :, None].float()  # (B,k,k,i,o)
        norm = torch.sqrt((wm * wm).sum((1, 2, 3)) + 1e-8)  # (B, o)
        wm = (wm / norm[:, None, None, None, :]).permute(0, 4, 3, 1, 2)  # (B, o, i, k, k)
        if _act_fast():
            x, wm = x.to(torch.bfloat16), wm.to(torch.bfloat16)
        pad = k // 2
        xp = F.pad(x, (pad, pad, pad, pad))
        bsz = x.shape[0]
        if wm.shape[0] == 1:
            out = F.conv2d(xp, wm[0])
        else:
            out = F.conv2d(xp.reshape(1, bsz * i, *xp.shape[2:]),
                           wm.reshape(bsz * o, i, k, k), groups=bsz)
            out = out.reshape(bsz, o, *out.shape[2:])
        out = out + self.bias.to(out.dtype)[:, None, None]
        return F.leaky_relu(out, 0.2) * math.sqrt(2.0)

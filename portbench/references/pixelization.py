"""The plain reference of the neural pixelization configuration.

Plain PyTorch in float32, one frame at a time, nothing of the program
imported: the pixelization GAN of Wu et al., "Make Your Own Sprites:
Aliasing-Aware and Cell-Controllable Pixelization" (ACM TOG 41(6), 2022;
github.com/WuZongWei6/Pixelization), as upstream's dither_pie runs it,
then the configuration's error diffusion of the pixelized frames
(``dither``; the palette is ``error_diffusion.py``'s k-means).

The nets, NCHW, every conv block reflect-padded, biased, then normed and
activated:

* C2PGen's content encoder: a 7x7 stem to 64, two 4x4 stride-2 downs to
  128 and 256, instance norm (no affine, biased variance, eps 1e-5) and
  ReLU, then 4 resblocks of two 3x3 convs (the second without ReLU);
* its style path: the greyscale style image through VGG19's convs up to
  conv4_1 (zero padding, max pools) and a pyramid of 7x7 and 4x4 stride-2
  convs that takes the taps conv1_1, conv2_1, conv3_1 and conv4_1 in by
  concatenation, a global mean, a 1x1 conv to 256, then an MLP (three ReLU
  linears and a linear to 2048);
* its decoder: 8 modulated 3x3 convs in 4 residual pairs (StyleGAN2's
  modulation by a 256-wide slice of the code and demodulation, in the
  released per-sample form: the weight scaled by 1/sqrt(fan-in), viewed
  as (k, k, I, O), times the code over I, over sqrt(sum + 1e-8) over
  (k, k, I), a grouped conv with zero padding, the bias, LeakyReLU(0.2)
  times sqrt(2)); then twice a 2x nearest upsample and a 5x5 conv with
  the custom LayerNorm (per sample over every axis, unbiased std, divided
  by std + eps, a per-channel affine) and ReLU; then a 7x7 conv and tanh;
* AliasNet: the same content encoder with 3 resblocks, 3 more resblocks,
  the same upsampling tail.

Departures from the paper's description that the released code makes, and
that the output depends on, kept: the decoder applies ``mod_conv_1`` once
and ``mod_conv_2`` for the other seven modulated convs (``mod_conv_3`` to
``_8`` are drawn and never used); the VGG taps are read after the ReLU,
since the released ReLUs run in place on the tensors it captured; the MLP
has four linears.

The weights: N(0, 0.02) drawn by ``np.random.RandomState(weights_seed)``
in float32, tensor after tensor in the sorted order of their keys, C2PGen
first, each in the layout it is drawn in (HWIO convs, (I, O) linears,
(k, k, I, O) modulated weights), then carried to the released checkpoints'
torch layout: OIHW convs, (O, I) linears, and the modulated weights'
(O, I, k, k) buffer holding the drawn array's bytes as they lie.

The host steps, upstream's: the frame NEAREST-resized so its short side is
4 * max_size, centre-cropped to multiples of 4, scaled to [-1, 1]; the
output times 255 from [0, 1], truncated to uint8; NEAREST to /4 and back
to x4; NEAREST to the even size at max_size. The style image is read from
its file, ``dither_pie_tpu_torch/assets/reference.png`` (upstream's image).

TF32 is off (``torch.backends.cuda.matmul.allow_tf32``,
``torch.backends.cudnn.allow_tf32``) while the nets run, and restored
after. ``dtype`` other than float32 rounds every conv's and linear's
operands through it and accumulates in float32: the control of the check.

A configuration names this module in its ``reference`` key; the harness
calls ``palette``, ``palette_checks``, ``outputs`` and ``scan_work``;
``kinds/neural_stream.py`` calls ``pixelize`` and ``dither``.
"""

from __future__ import annotations

import contextlib
import math
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from portbench import neural_work
from portbench.references import error_diffusion

STYLE_IMAGE = Path(__file__).resolve().parents[2] / "dither_pie_tpu_torch" / "assets" / \
    "reference.png"
# torchvision vgg19.features up to conv4_1: conv indices and widths, and
# where a 2x2 max pool follows the ReLU.
VGG_CONVS = {0: (3, 64), 2: (64, 64), 5: (64, 128), 7: (128, 128), 10: (128, 256),
             12: (256, 256), 14: (256, 256), 16: (256, 256), 19: (256, 512)}
VGG_POOL_AFTER = (2, 7, 16)
VGG_TAPS = (0, 5, 10, 19)

Params = Dict[str, torch.Tensor]


def _conv_shapes(prefix: str, k: int, cin: int, cout: int) -> dict:
    return {f"{prefix}.bias": (cout,), f"{prefix}.weight": (k, k, cin, cout)}


def _encoder_shapes(prefix: str, n_res: int) -> dict:
    out = {}
    for i, (k, cin, cout) in enumerate([(7, 3, 64), (4, 64, 128), (4, 128, 256)]):
        out.update(_conv_shapes(f"{prefix}.model.{i}.conv", k, cin, cout))
    out.update(_res_shapes(f"{prefix}.model.3.model", n_res))
    return out


def _res_shapes(prefix: str, n_res: int) -> dict:
    out = {}
    for r in range(n_res):
        for j in range(2):
            out.update(_conv_shapes(f"{prefix}.{r}.model.{j}.conv", 3, 256, 256))
    return out


def _tail_shapes(prefix: str) -> dict:
    out = {}
    for name, k, cin, cout, norm in [("conv_1", 5, 256, 128, True), ("conv_2", 5, 128, 64, True),
                                     ("conv_3", 7, 64, 3, False)]:
        out.update(_conv_shapes(f"{prefix}.{name}.conv", k, cin, cout))
        if norm:
            out.update({f"{prefix}.{name}.norm.beta": (cout,),
                        f"{prefix}.{name}.norm.gamma": (cout,)})
    return out


def weight_shapes() -> Tuple[dict, dict]:
    """(C2PGen's, AliasNet's) key -> the shape each tensor is drawn in."""
    gen = _encoder_shapes("RGBEnc", 4)
    for i, (cin, cout) in enumerate([(256, 256), (256, 256), (256, 256), (256, 2048)]):
        gen.update({f"MLP.model.{i}.fc.bias": (cout,), f"MLP.model.{i}.fc.weight": (cin, cout)})
    for name, k, cin, cout in [("conv1", 7, 3, 64), ("conv2", 4, 128, 128),
                               ("conv3", 4, 256, 256), ("conv4", 4, 512, 512)]:
        gen.update(_conv_shapes(f"PBEnc.{name}.conv", k, cin, cout))
    gen.update({"PBEnc.model.1.bias": (256,), "PBEnc.model.1.weight": (1, 1, 1024, 256)})
    for i in range(1, 9):
        gen.update({f"RGBDec.mod_conv_{i}.bias": (256,),
                    f"RGBDec.mod_conv_{i}.weight": (3, 3, 256, 256)})
    gen.update(_tail_shapes("RGBDec"))
    for idx, (cin, cout) in VGG_CONVS.items():
        gen.update({f"vgg.{idx}.bias": (cout,), f"vgg.{idx}.weight": (3, 3, cin, cout)})
    alias = _encoder_shapes("RGBEnc", 3)
    alias.update(_res_shapes("RGBDec.Res_Blocks.model", 3))
    alias.update(_tail_shapes("RGBDec"))
    return gen, alias


def _to_torch_layout(key: str, a: np.ndarray) -> np.ndarray:
    if a.ndim == 4:
        if ".mod_conv_" in key:
            kh, kw, i, o = a.shape
            return a.reshape(o, i, kh, kw)  # the released buffer: the bytes as they lie
        return a.transpose(3, 2, 0, 1)
    return a.T if a.ndim == 2 else a


def draw_weights(seed: int) -> Tuple[Params, Params]:
    """(C2PGen, AliasNet) weights for ``seed`` under the released
    checkpoints' keys and layouts (the VGG taps as ``PBEnc.vgg.<idx>``), on
    the host, float32."""
    rng = np.random.RandomState(seed)
    nets = []
    for shapes in weight_shapes():
        net = {}
        for key in sorted(shapes):
            a = rng.normal(0.0, 0.02, shapes[key]).astype(np.float32)
            name = f"PBEnc.{key}" if key.startswith("vgg.") else key
            net[name] = torch.from_numpy(np.ascontiguousarray(_to_torch_layout(key, a)))
        nets.append(net)
    return nets[0], nets[1]


@contextlib.contextmanager
def no_tf32():
    """float32 matmuls and convolutions in float32, restored after."""
    mm, cd = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


class Nets:
    """The two nets' forwards over C2PGen's weights ``gen`` and AliasNet's
    ``alias``; conv and linear operands rounded through ``dtype``."""

    def __init__(self, gen: Params, alias: Params, dtype: torch.dtype = torch.float32):
        self.gen, self.alias, self.dtype = gen, alias, dtype

    def _round(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.dtype == torch.float32 else t.to(self.dtype).float()

    def conv(self, x, w, b, stride=1, padding=0, groups=1):
        return F.conv2d(self._round(x), self._round(w), b, stride, padding, 1, groups)

    def linear(self, x, w, b):
        return F.linear(self._round(x), self._round(w), b)

    def block(self, p: Params, key: str, x, stride, pad, norm, act):
        """Reflect pad, conv, norm ("in", "ln", "none"), activation."""
        if pad:
            x = F.pad(x, (pad, pad, pad, pad), mode="reflect")
        x = self.conv(x, p[f"{key}.conv.weight"], p[f"{key}.conv.bias"], stride)
        if norm == "in":
            mean = x.mean((2, 3), keepdim=True)
            var = ((x - mean) ** 2).mean((2, 3), keepdim=True)
            x = (x - mean) / torch.sqrt(var + 1e-5)
        elif norm == "ln":
            flat = x.reshape(x.shape[0], -1)
            mean = flat.mean(1).view(-1, 1, 1, 1)
            std = flat.std(1).view(-1, 1, 1, 1)  # unbiased, as the released LayerNorm
            x = (x - mean) / (std + 1e-5)
            x = x * p[f"{key}.norm.gamma"].view(1, -1, 1, 1) + \
                p[f"{key}.norm.beta"].view(1, -1, 1, 1)
        if act == "relu":
            return F.relu(x)
        return torch.tanh(x) if act == "tanh" else x

    def resblocks(self, p: Params, key: str, x, n: int):
        for r in range(n):
            y = self.block(p, f"{key}.{r}.model.0", x, 1, 1, "in", "relu")
            x = x + self.block(p, f"{key}.{r}.model.1", y, 1, 1, "in", "none")
        return x

    def encoder(self, p: Params, x, n_res: int):
        x = self.block(p, "RGBEnc.model.0", x, 1, 3, "in", "relu")
        x = self.block(p, "RGBEnc.model.1", x, 2, 1, "in", "relu")
        x = self.block(p, "RGBEnc.model.2", x, 2, 1, "in", "relu")
        return self.resblocks(p, "RGBEnc.model.3.model", x, n_res)

    def tail(self, p: Params, x):
        x = self.block(p, "RGBDec.conv_1", F.interpolate(x, scale_factor=2, mode="nearest"),
                       1, 2, "ln", "relu")
        x = self.block(p, "RGBDec.conv_2", F.interpolate(x, scale_factor=2, mode="nearest"),
                       1, 2, "ln", "relu")
        return self.block(p, "RGBDec.conv_3", x, 1, 3, "none", "tanh")

    def vgg_taps(self, x):
        p, taps = self.gen, {}
        for idx in VGG_CONVS:
            x = F.relu(self.conv(x, p[f"PBEnc.vgg.{idx}.weight"], p[f"PBEnc.vgg.{idx}.bias"],
                                 padding=1))
            if idx in VGG_TAPS:
                taps[idx] = x
            if idx in VGG_POOL_AFTER:
                x = F.max_pool2d(x, 2, 2)
        return taps

    def style_code(self, style: torch.Tensor) -> torch.Tensor:
        """(1, 3, H, W) style image -> (1, 2048) code."""
        p = self.gen
        taps = self.vgg_taps(style)
        x = torch.cat([self.block(p, "PBEnc.conv1", style, 1, 3, "none", "relu"), taps[0]], 1)
        for name, tap in (("conv2", 5), ("conv3", 10), ("conv4", 19)):
            x = torch.cat([self.block(p, f"PBEnc.{name}", x, 2, 1, "none", "relu"), taps[tap]], 1)
        x = self.conv(x.mean((2, 3), keepdim=True), p["PBEnc.model.1.weight"],
                      p["PBEnc.model.1.bias"])
        code = x.flatten(1)
        for i in range(4):
            code = self.linear(code, p[f"MLP.model.{i}.fc.weight"], p[f"MLP.model.{i}.fc.bias"])
            code = F.relu(code) if i < 3 else code
        return code

    def mod_conv(self, x, i: int, code):
        """The released per-sample modulated conv ``mod_conv_<i>``."""
        w, b = self.gen[f"RGBDec.mod_conv_{i}.weight"], self.gen[f"RGBDec.mod_conv_{i}.bias"]
        o, c, k, _ = w.shape
        n, _, h, wd = x.shape
        wm = (w * (1.0 / math.sqrt(k * k * c))).view(1, k, k, c, o).repeat(n, 1, 1, 1, 1)
        wm = wm * code.view(n, 1, 1, c, 1)
        wm = wm / torch.sqrt((wm ** 2).sum(dim=[1, 2, 3]) + 1e-8).view(n, 1, 1, 1, o)
        wm = wm.permute(1, 2, 3, 0, 4).reshape(k, k, c, n * o).permute(3, 2, 0, 1)
        y = self.conv(x.reshape(1, n * c, h, wd), wm, None, padding=k // 2, groups=n)
        y = y.view(n, o, h, wd) + b.view(1, -1, 1, 1)
        return F.leaky_relu(y, 0.2) * math.sqrt(2.0)

    def c2pgen(self, x, code):
        """(N, 3, H, W) in [-1, 1] and the (N, 2048) code -> C2PGen's output."""
        x = self.encoder(self.gen, x, 4)
        for pair in range(4):
            residual = x
            first = 1 if pair == 0 else 2  # the released decoder's reuse of mod_conv_2
            x = self.mod_conv(x, first, code[:, 512 * pair:512 * pair + 256])
            x = self.mod_conv(x, 2, code[:, 512 * pair + 256:512 * (pair + 1)]) + residual
        return self.tail(self.gen, x)

    def aliasnet(self, x):
        x = self.encoder(self.alias, x, 3)
        return self.tail(self.alias, self.resblocks(self.alias, "RGBDec.Res_Blocks.model", x, 3))


def _resized(width: int, height: int, max_size: int) -> Tuple[int, int]:
    """Upstream's (width, height) with the short side at 4 * max_size, the
    long side truncated."""
    side = 4 * max_size
    if width < height:
        return side, int(side / (width / height))
    return int(side * (width / height)), side


def _crop4(image: Image.Image) -> Image.Image:
    """Upstream's centre crop to multiples of 4 (Python's round: a side
    may come out a column wider, which the crop fills with zeros)."""
    w, h = image.size
    cw, ch = int(round(w / 4) * 4), int(round(h / 4) * 4)
    left, top = (w - cw) // 2, (h - ch) // 2
    return image.crop((left, top, left + cw, top + ch))


def _normalized(image: Image.Image) -> np.ndarray:
    """(1, 3, H, W) float32 in [-1, 1]."""
    arr = np.asarray(image, dtype=np.float32) / 255.0
    return ((arr - 0.5) / 0.5).transpose(2, 0, 1)[None]


def even_size(w: int, h: int, max_size: int) -> Tuple[int, int]:
    """Upstream's (width, height) at max_size, both even."""
    if w >= h:
        th = max_size if max_size % 2 == 0 else max_size - 1
        tw = int(round((w / h) * th))
        tw += tw % 2
    else:
        tw = max_size if max_size % 2 == 0 else max_size - 1
        th = int(round((h / w) * tw))
        th += th % 2
    return tw, th


def output_size(h: int, w: int, max_size: int) -> Tuple[int, int]:
    """(height, width) of the pixelized frame of an (h, w) frame."""
    nh, nw = neural_work.net_input(h, w, max_size)
    tw, th = even_size(nw, nh, max_size)
    return th, tw


def _finish(out: np.ndarray, max_size: int) -> np.ndarray:
    """(H, W, 3) float32 in [-1, 1] -> the pixelized (h, w, 3) uint8 frame."""
    img = Image.fromarray(((out + 1) / 2.0 * 255.0).astype(np.uint8))
    w, h = img.size
    img = img.resize((w // 4, h // 4), Image.NEAREST)
    img = img.resize((img.size[0] * 4, img.size[1] * 4), Image.NEAREST)
    tw, th = even_size(img.size[0], img.size[1], max_size)
    return np.asarray(img.resize((tw, th), Image.NEAREST))


def pixelize(frames: np.ndarray, config: Dict[str, Any], device: torch.device,
             dtype: torch.dtype = torch.float32, alias: bool = True) -> np.ndarray:
    """The configuration's neural pixelization of (N, H, W, 3) uint8 frames,
    one at a time: (N, h, w, 3) uint8. ``alias`` False leaves AliasNet out
    (a control)."""
    neural = config["neural"]
    max_size = int(config["pixelization"]["max_size"])
    gen, ali = draw_weights(int(neural["weights_seed"]))
    nets = Nets({k: v.to(device) for k, v in gen.items()},
                {k: v.to(device) for k, v in ali.items()}, dtype)
    grey = np.asarray(Image.open(STYLE_IMAGE).convert("L"))
    style = Image.fromarray(np.stack([grey] * 3, axis=-1))
    out = []
    with torch.inference_mode(), no_tf32():
        code = nets.style_code(torch.from_numpy(_normalized(_crop4(style))).to(device))
        for frame in frames:
            image = Image.fromarray(frame)
            image = _crop4(image.resize(_resized(*image.size, max_size), Image.NEAREST))
            x = torch.from_numpy(_normalized(image))
            y = nets.c2pgen(x.to(device), code)
            if alias:
                y = nets.aliasnet(y)
            out.append(_finish(y[0].permute(1, 2, 0).cpu().numpy(), max_size))
    return np.stack(out)


def dither(frames: np.ndarray, palette: np.ndarray, config: Dict[str, Any],
           device: torch.device) -> np.ndarray:
    """The configuration's error diffusion of (N, H, W, 3) uint8 frames to
    the (P, 3) integer palette, in float32: (N, H, W, 3) uint8.

    The sequential row-major scan, computed one anti-diagonal d = x + s*y
    at a time (``error_diffusion.skew_of``: every source of a pixel lies on
    an earlier diagonal). A pixel's value is its image value with the
    weighted errors of its sources added one at a time in the order the
    row-major scan sends them: earlier source rows first, then sources
    further left. The value is clamped to 0..255, the nearest colour is the
    first minimum of (dr*dr + dg*dg) + db*db, and the error (value - colour)
    is kept for the pixels it reaches. Sources outside the frame send
    nothing (their errors are 0, and adding 0 changes no float). Pulling
    the errors in that order, and not pushing them diagonal by diagonal as
    ``error_diffusion.error_diffusion`` does, keeps the row-major order
    where two sources of a pixel on different rows share a diagonal out of
    row order: Atkinson's (2, 0) and (-1, 1) at s = 2."""
    entries = error_diffusion.entries_of(config)
    s = error_diffusion.skew_of(entries)
    order = sorted(entries, key=lambda e: (-e[1], -e[0]))
    n, h, w, _ = frames.shape
    left = max([0] + [dx for dx, _, _ in entries])  # sources up to max dx to the left
    right = max([0] + [-dx for dx, _, _ in entries])
    above = max([0] + [dy for _, dy, _ in entries])
    wp = left + w + right
    errs = torch.zeros((n, (above + h) * wp, 3), dtype=torch.float32, device=device)
    img = torch.from_numpy(frames).to(device).float().reshape(n, h * w, 3)
    pal = torch.from_numpy(palette.astype(np.float32)).to(device)
    iota = torch.arange(pal.shape[0], device=device)
    weights = [torch.tensor(wt, dtype=torch.float32, device=device) for _, _, wt in order]
    idx_out = torch.zeros((n, h * w), dtype=torch.int64, device=device)
    for d in range(w + s * (h - 1)):
        ys = torch.arange(max(0, -((w - 1 - d) // s)), min(h - 1, d // s) + 1, device=device)
        xs = d - s * ys
        at = (ys + above) * wp + xs + left
        cur = img[:, ys * w + xs]
        for (dx, dy, _), wt in zip(order, weights):
            cur = cur + errs[:, at - (dy * wp + dx)] * wt
        cur = cur.clamp(0.0, 255.0)
        diff = cur[:, :, None, :] - pal
        sq = diff * diff
        dist = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
        best = torch.where(dist == dist.amin(-1, keepdim=True), iota, pal.shape[0]).amin(-1)
        errs[:, at] = cur - pal[best]
        idx_out[:, ys * w + xs] = best
    pal_u8 = torch.from_numpy(palette.astype(np.uint8)).to(device)
    return pal_u8[idx_out].view(n, h, w, 3).cpu().numpy()


def palette(frame0: np.ndarray, config: Dict[str, Any], device: torch.device) -> np.ndarray:
    """The k-means palette of the raw frame 0 (``error_diffusion``'s)."""
    return error_diffusion.palette(frame0, config, device)


def palette_checks(frame0: np.ndarray, port_palette: np.ndarray, ref_palette: np.ndarray,
                   config: Dict[str, Any]) -> Dict[str, float]:
    return error_diffusion.palette_checks(frame0, port_palette, ref_palette, config)


def outputs(frames: np.ndarray, palette: np.ndarray, config: Dict[str, Any],
            device: torch.device, dtype: torch.dtype = torch.float32) -> np.ndarray:
    """The whole configuration on (N, H, W, 3) uint8 frames: pixelized
    (the nets' operands rounded through ``dtype``), then ``dither``."""
    return dither(pixelize(frames, config, device, dtype), palette, config, device)


def scan_work(config: Dict[str, Any], frames: int, h: int, w: int,
              input_bytes: int) -> Optional[Dict[str, float]]:
    """The error-diffusion scan's work at the pixelized frames' size."""
    ph, pw = output_size(h, w, int(config["pixelization"]["max_size"]))
    return error_diffusion.scan_work(config, frames, ph, pw, input_bytes)

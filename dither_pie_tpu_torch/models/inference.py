"""Neural pixelization inference: the reference Model surface on torch.

Flow:
  greyscale reference.png -> process() [centre crop to %4, [-1, 1]] ->
  the adain style code (computed once and cached);
  input -> process() -> AliasNet(C2PGen(input, style)) -> denormalise to
  uint8 -> /4 then x4 NEAREST (crisp 4x4 blocks).

The host side (``greyscale``, ``process``, ``deprocess``, ...) is numpy and
PIL; the nets run on ``PixelizationModel``'s device ("cuda" unless the
caller asks for the CPU). The switches, read only here:

* ``DITHER_PIE_TPU_NEURAL_PRECISION``: "float32" (default, the parity
  contract), "tensorfloat32" or "bfloat16". Unset, the batched video path
  picks bfloat16 or float32 by its first-batch gate.
* ``DITHER_PIE_TPU_NEURAL_U8_IN=0``: the batch path ships float32 frames
  normalised on the host instead of uint8 normalised on the device.
* ``DITHER_PIE_TPU_NEURAL_DS4=0``: the batch path returns full uint8
  frames instead of the /4 block samples.
* ``DITHER_PIE_TPU_NEURAL_DS4_STRIDE=0/1``: forbid or force the stride-4
  final conv (unset: the first-batch gate decides).
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from PIL import Image

from dither_pie_tpu_torch.api.runtime import DeviceLike, resolve_device
from dither_pie_tpu_torch.core.fidelity import block_mean_error
from dither_pie_tpu_torch.models.c2pgen import (
    AliasNet,
    C2PGen,
    aliasnet_forward,
    aliasnet_forward_ds4,
    c2pgen_forward,
    style_adain,
)
from dither_pie_tpu_torch.models.convert import (
    convert_checkpoints,
    find_checkpoint_dir,
    state_from_jax,
)
from dither_pie_tpu_torch.models.layers import PRECISIONS
from dither_pie_tpu_torch.utils import compute_even_dimensions

logger = logging.getLogger("dither_pie_tpu_torch")

_REFERENCE_PNG = Path(__file__).resolve().parents[1] / "assets" / "reference.png"


def greyscale(img: Image.Image) -> Image.Image:
    gray = np.array(img.convert("L"))
    return Image.fromarray(np.stack([gray, gray, gray], axis=-1))


def _crop4(img: Image.Image) -> Image.Image:
    """Centre crop to a multiple of 4. Python's round takes halves to even,
    so a side can come out wider than the image (910 -> 912 at 1080p and
    max_size 128); PIL fills the columns outside it with zeros."""
    ow, oh = img.size
    nw = int(round(ow / 4) * 4)
    nh = int(round(oh / 4) * 4)
    left = (ow - nw) // 2
    top = (oh - nh) // 2
    return img.crop((left, top, left + nw, top + nh))


def process(img: Image.Image) -> np.ndarray:
    """Centre crop to a multiple of 4, scale to [-1, 1]: (1, H, W, 3)
    float32."""
    arr = np.asarray(_crop4(img), dtype=np.float32) / 255.0
    return ((arr - 0.5) / 0.5)[None]


def process_u8(img: Image.Image) -> np.ndarray:
    """Centre crop to a multiple of 4, kept uint8: (1, H, W, 3). The scaling
    to [-1, 1] happens on the device (``_maybe_normalize``), so the host
    ships one byte a channel instead of four."""
    return np.asarray(_crop4(img), dtype=np.uint8)[None]


def _maybe_normalize(in_t: torch.Tensor) -> torch.Tensor:
    """uint8 operands are scaled as ``process`` scales (x / 255, then
    (v - 0.5) / 0.5) on their device; float32 operands pass through. The
    divisors are 0-dim tensors on the operand's device: a Python scalar
    divisor would multiply by its reciprocal on CUDA."""
    if in_t.dtype != torch.uint8:
        return in_t

    def c(v):
        return torch.tensor(v, dtype=torch.float32, device=in_t.device)

    x = in_t.to(torch.float32) / c(255.0)
    return (x - c(0.5)) / c(0.5)


def deprocess(out: np.ndarray) -> Image.Image:
    """[-1, 1] -> uint8 image, then /4 and x4 NEAREST for crisp 4x4 blocks."""
    img = ((out[0] + 1) / 2.0 * 255.0).astype(np.uint8)
    return deprocess_u8(img)


def deprocess_u8(img: np.ndarray) -> Image.Image:
    """(H, W, 3) uint8 -> /4 and x4 NEAREST for crisp 4x4 blocks."""
    pil = Image.fromarray(img)
    pil = pil.resize((pil.size[0] // 4, pil.size[1] // 4), Image.Resampling.NEAREST)
    return pil.resize((pil.size[0] * 4, pil.size[1] * 4), Image.Resampling.NEAREST)


def downsample4_indices(n: int) -> slice:
    """PIL NEAREST ``resize(w // 4)`` samples source pixel floor((i + 0.5)
    * 4) = 4i + 2, i.e. ``arr[2::4]`` along each axis."""
    return slice(2, n, 4)


def upsample4_u8(ds: np.ndarray) -> np.ndarray:
    """(h, w, 3) uint8 -> (4h, 4w, 3): PIL NEAREST x4 maps destination pixel
    i to source i // 4, which is ``np.repeat`` x4 on both axes."""
    return np.repeat(np.repeat(ds, 4, axis=0), 4, axis=1)


def resize_image_nearest(img: Image.Image, target_size: int) -> Image.Image:
    """Smallest side -> target_size, NEAREST."""
    width, height = img.size
    ar = width / height
    if width < height:
        nw, nh = target_size, int(target_size / ar)
    else:
        nh, nw = target_size, int(target_size * ar)
    return img.resize((nw, nh), Image.NEAREST)


def _to_u8(out: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> uint8, truncated: the reference's save() arithmetic."""
    return ((out + 1.0) * 0.5 * 255.0).to(torch.uint8)


def _env_precision() -> str:
    p = os.environ.get("DITHER_PIE_TPU_NEURAL_PRECISION", "float32")
    if p not in PRECISIONS:
        raise ValueError(f"bad DITHER_PIE_TPU_NEURAL_PRECISION: {p!r}")
    return p


class PixelizationModel:
    """load() + pixelize() surface of the reference Model class, on
    ``device`` (resolved by ``api.runtime.resolve_device``: CUDA without a
    card raises)."""

    # Gate of the bfloat16 video path: bounds far below a visible difference,
    # so a precision-sensitive checkpoint stays on float32.
    BF16_GATE_MEAN_U8_DELTA = 1.0
    BF16_GATE_BLOCK_MEAN = 2.0

    def __init__(self, checkpoint_dir: Optional[str] = None, device: DeviceLike = "cuda"):
        self.checkpoint_dir = checkpoint_dir
        self.device = resolve_device(device)
        self.gen: Optional[C2PGen] = None
        self.alias: Optional[AliasNet] = None
        self.ref_t: Optional[torch.Tensor] = None

    def load(self):
        gen, alias = convert_checkpoints(self.checkpoint_dir or find_checkpoint_dir())
        self._set_params(gen, alias)

    def load_random(self, seed: int = 0):
        """The JAX package's random weights for ``seed`` (architecture
        tests and benchmarks while the released checkpoints are absent)."""
        from dither_pie_tpu_torch.models.param_shapes import random_params

        self._set_params(*state_from_jax(*random_params(seed)))

    def _set_params(self, gen_state, alias_state):
        self.gen, self.alias = C2PGen(), AliasNet()
        for net, state in ((self.gen, gen_state), (self.alias, alias_state)):
            net.load_state_dict(state, strict=True)
            net.requires_grad_(False).eval().to(self.device)
        ref_img = greyscale(Image.open(_REFERENCE_PNG).convert("L"))
        self.ref_t = self._tensor(process(ref_img))
        self._adain = None  # the style code, computed at first use
        self._video_prec = None  # the batched video path's precision (gated)
        self._ds4_stride = None  # the stride-4 final conv (gated)

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        """(B, H, W, 3) host array -> (B, 3, H, W) on the device, uint8
        scaled to [-1, 1] there."""
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
        return _maybe_normalize(t).permute(0, 3, 1, 2).contiguous()

    @staticmethod
    def _host(t: torch.Tensor) -> np.ndarray:
        return t.permute(0, 2, 3, 1).contiguous().cpu().numpy()

    def _style(self) -> torch.Tensor:
        """The (1, 2048) adain code of reference.png, in float32, computed
        once per loaded weights."""
        if self._adain is None:
            with torch.inference_mode():
                self._adain = style_adain(self.gen, self.ref_t, precision="float32")
        return self._adain

    @torch.inference_mode()
    def forward_tensor(self, x: torch.Tensor, precision: str) -> torch.Tensor:
        """(B, 3, H, W) in [-1, 1] on the device -> the same, float32."""
        mid = c2pgen_forward(self.gen, x, adain=self._style(), precision=precision)
        return aliasnet_forward(self.alias, mid, precision=precision)

    def forward_array(self, in_t: np.ndarray) -> np.ndarray:
        """(1, H, W, 3) in [-1, 1] -> the same, through C2PGen and AliasNet."""
        return self._host(self.forward_tensor(self._tensor(in_t), _env_precision()))

    @torch.inference_mode()
    def forward_u8(self, in_t: np.ndarray, precision: Optional[str] = None,
                   ds4: bool = False, stride: bool = False) -> np.ndarray:
        """(B, H, W, 3) in [-1, 1] (float32) or uint8 -> (B, H, W, 3) uint8,
        denormalised on the device. ``precision`` None: the
        DITHER_PIE_TPU_NEURAL_PRECISION setting. ``ds4``: only the (B, H/4,
        W/4, 3) block samples leave the device (``upsample4_u8`` rebuilds
        the frame). ``stride`` (with ds4): the final conv computes only the
        samples (``aliasnet_forward_ds4``)."""
        precision = precision or _env_precision()
        x = self._tensor(in_t)
        if ds4 and stride:
            mid = c2pgen_forward(self.gen, x, adain=self._style(), precision=precision)
            u8 = _to_u8(aliasnet_forward_ds4(self.alias, mid, precision=precision))
        else:
            u8 = _to_u8(self.forward_tensor(x, precision))
            if ds4:
                u8 = u8[:, :, 2::4, 2::4]
        return self._host(u8)

    def _gate(self, ref: np.ndarray, cand: np.ndarray, block: int):
        """(passes, mean |u8 delta|, worst frame's block mean error)."""
        mean_delta = float(np.abs(ref.astype(np.int16) - cand.astype(np.int16)).mean())
        block_mean = max(block_mean_error(torch.from_numpy(ref[i]),
                                          torch.from_numpy(cand[i]), block=block)[0]
                         for i in range(ref.shape[0]))
        ok = (mean_delta <= self.BF16_GATE_MEAN_U8_DELTA
              and block_mean <= self.BF16_GATE_BLOCK_MEAN)
        return ok, mean_delta, block_mean

    def _gated_batch_forward(self, stacked: np.ndarray, ds4: bool = False) -> np.ndarray:
        """The batched video forward, bfloat16 behind a first-batch gate.

        On the first batch (unless DITHER_PIE_TPU_NEURAL_PRECISION is set,
        which always wins) both float32 and bfloat16 run; bfloat16 is locked
        in for the video only if its mean |u8 delta| and block-mean error
        against float32 stay inside the bounds, else float32. With ``ds4``
        the gate compares the /4 samples, the only pixels of the
        4x4-block-constant output (block=1 on them is block=4 on the frame).

        With ``ds4``, the stride-4 final conv is gated on the first batch
        too (DITHER_PIE_TPU_NEURAL_DS4_STRIDE=0/1 forces it): in float32 it
        must equal the dense slice bitwise, in bfloat16 it must pass the
        bfloat16 bounds against it. The verdicts are ``_video_prec`` and
        ``_ds4_stride``."""
        dense = None  # this batch's dense output at the locked precision
        if self._video_prec is None:
            if "DITHER_PIE_TPU_NEURAL_PRECISION" in os.environ:
                self._video_prec = _env_precision()
            else:
                f32 = self.forward_u8(stacked, precision="float32", ds4=ds4)
                bf16 = self.forward_u8(stacked, precision="bfloat16", ds4=ds4)
                ok, mean_delta, block_mean = self._gate(f32, bf16, 1 if ds4 else 4)
                self._video_prec = "bfloat16" if ok else "float32"
                dense = bf16 if ok else f32
                msg = (f"mean |u8 delta| {mean_delta:.3f}, block mean {block_mean:.3f}")
                if ok:
                    logger.info(f"Neural video: bf16 fast path enabled (parity gate "
                                f"passed: {msg})")
                else:
                    logger.warning(f"Neural video: bf16 parity gate FAILED ({msg}); "
                                   f"staying on float32")
        if not ds4:
            if dense is None:
                dense = self.forward_u8(stacked, precision=self._video_prec)
            return dense

        if self._ds4_stride is None:
            env = os.environ.get("DITHER_PIE_TPU_NEURAL_DS4_STRIDE")
            if env in ("0", "1"):
                self._ds4_stride = env == "1"
            else:
                if dense is None:
                    dense = self.forward_u8(stacked, precision=self._video_prec, ds4=True)
                cand = self.forward_u8(stacked, precision=self._video_prec, ds4=True,
                                       stride=True)
                if self._video_prec == "float32":
                    ok = bool(np.array_equal(cand, dense))
                    note = "bitwise" if ok else "not bitwise"
                else:
                    ok, mean_delta, block_mean = self._gate(dense, cand, 1)
                    note = f"mean |u8 delta| {mean_delta:.3f}, block mean {block_mean:.3f}"
                self._ds4_stride = ok
                logger.info(f"Neural video: strided ds4 conv "
                            f"{'enabled' if ok else 'DISABLED'} ({note})")
                return cand if ok else dense
        if self._ds4_stride:
            return self.forward_u8(stacked, precision=self._video_prec, ds4=True, stride=True)
        if dense is None:
            dense = self.forward_u8(stacked, precision=self._video_prec, ds4=True)
        return dense

    def pixelize(self, in_path: str, out_path: str):
        img = Image.open(in_path).convert("RGB")
        deprocess(self.forward_array(process(img))).save(out_path)

    def pixelize_image(self, image: Image.Image, max_size: int) -> Image.Image:
        """Upscale to max_size * 4, run the nets, then NEAREST-resize to
        even dimensions at max_size."""
        img = resize_image_nearest(image.convert("RGB"), max_size * 4)
        result = deprocess_u8(self.forward_u8(process(img))[0])
        tw, th = compute_even_dimensions(result.size[0], result.size[1], max_size)
        return result.resize((tw, th), Image.Resampling.NEAREST)

    def pixelize_images_batch(self, images, max_size: int):
        """``pixelize_image`` for same-size frames (the video path): one
        forward over the stacked batch, through the gates of
        ``_gated_batch_forward``; the PIL resizes stay per frame. Frames
        whose prepared shapes differ go one at a time."""
        u8_in = os.environ.get("DITHER_PIE_TPU_NEURAL_U8_IN", "1") != "0"
        prep = process_u8 if u8_in else process
        pre = [prep(resize_image_nearest(im.convert("RGB"), max_size * 4)) for im in images]
        if len({p.shape for p in pre}) != 1:
            return [self.pixelize_image(im, max_size) for im in images]
        ds4 = os.environ.get("DITHER_PIE_TPU_NEURAL_DS4", "1") != "0"
        out = self._gated_batch_forward(np.concatenate(pre, axis=0), ds4=ds4)
        results = []
        for i in range(len(images)):
            r = Image.fromarray(upsample4_u8(out[i])) if ds4 else deprocess_u8(out[i])
            tw, th = compute_even_dimensions(r.size[0], r.size[1], max_size)
            results.append(r.resize((tw, th), Image.Resampling.NEAREST))
        return results

"""C2PGen (clipart -> pixel-art generator), AliasNet and the VGG19 feature
taps, as torch modules with the reference checkpoints' keys.

C2PGen(3, 3, 64, n_down=2, n_res=4, style=256, mlp=256) and
AliasNet(3, 3, 64, 2, 3), as the JAX package's ``models/c2pgen.py`` runs
them. Quirks of the reference that the output depends on, kept:

* RGBDecoder applies mod_conv_1 once and then mod_conv_2 for the other
  SEVEN modulated convs: the weights of mod_conv_3..8 are loaded and never
  used;
* the VGG taps (conv1_1, conv2_1, conv3_1, conv4_1) are taken after the
  ReLU: the reference's ReLUs are in place and overwrite the tensors it
  captured;
* the MLP is 3 ReLU blocks and a final affine to 2048, sliced 256 wide per
  modulated conv.

``c2pgen_forward``, ``aliasnet_forward`` and ``aliasnet_forward_ds4`` take
a ``precision``: "float32" (the default and the parity contract),
"tensorfloat32" or "bfloat16" (``layers.precision_scope``); their output
is float32. The building blocks called on their own run in float32.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from dither_pie_tpu_torch.models.layers import (
    ConvBlock,
    LinearBlock,
    ModulationConvBlock,
    ResBlocks,
    bf16_activations,
    conv2d,
    max_pool_2x2,
    pad2d,
    parity_precision,
    precision_scope,
    upsample_nearest_2x,
)

# torchvision vgg19.features up to conv4_1: (kind, index).
_VGG_LAYOUT = [
    ("conv", 0), ("relu", None), ("conv", 2), ("relu", None), ("pool", None),
    ("conv", 5), ("relu", None), ("conv", 7), ("relu", None), ("pool", None),
    ("conv", 10), ("relu", None), ("conv", 12), ("relu", None),
    ("conv", 14), ("relu", None), ("conv", 16), ("relu", None), ("pool", None),
    ("conv", 19), ("relu", None),
]
_VGG_CONVS = {0: (3, 64), 2: (64, 64), 5: (64, 128), 7: (128, 128), 10: (128, 256),
              12: (256, 256), 14: (256, 256), 16: (256, 256), 19: (256, 512)}
_VGG_TAPS = {0: "conv1_1", 5: "conv2_1", 10: "conv3_1", 19: "conv4_1"}


class VGGFeatures(nn.Module):
    """The convs of vgg19.features up to index 19, keyed by their index."""

    def __init__(self):
        super().__init__()
        for idx, (cin, cout) in _VGG_CONVS.items():
            self.add_module(str(idx), nn.Conv2d(cin, cout, 3))

    @parity_precision
    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Taps at conv1_1 / conv2_1 / conv3_1 / conv4_1, after the ReLU."""
        taps, pending = {}, None
        for kind, idx in _VGG_LAYOUT:
            if kind == "conv":
                conv = getattr(self, str(idx))
                x = conv2d(pad2d(x, 1, "zero"), conv.weight, conv.bias)
                pending = _VGG_TAPS.get(idx)
            elif kind == "relu":
                x = torch.relu(x)
                if pending:
                    taps[pending] = x
                    pending = None
            else:
                x = max_pool_2x2(x)
        return taps


class RGBEncoder(nn.Module):
    """7x7 conv, two stride-2 downs, ``n_res`` resblocks; instance norm,
    reflect padding."""

    def __init__(self, n_res: int):
        super().__init__()
        self.model = nn.Sequential(
            ConvBlock(3, 64, 7, 1, 3, "in", "relu", "reflect"),
            ConvBlock(64, 128, 4, 2, 1, "in", "relu", "reflect"),
            ConvBlock(128, 256, 4, 2, 1, "in", "relu", "reflect"),
            ResBlocks(n_res, 256, "in", "relu", "reflect"))

    @parity_precision
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class PixelBlockEncoder(nn.Module):
    """The VGG pyramid style encoder -> (B, 256) style code."""

    def __init__(self):
        super().__init__()
        self.vgg = VGGFeatures()
        self.conv1 = ConvBlock(3, 64, 7, 1, 3, "none", "relu", "reflect")
        self.conv2 = ConvBlock(128, 128, 4, 2, 1, "none", "relu", "reflect")
        self.conv3 = ConvBlock(256, 256, 4, 2, 1, "none", "relu", "reflect")
        self.conv4 = ConvBlock(512, 512, 4, 2, 1, "none", "relu", "reflect")
        # AdaptiveAvgPool2d(1), then a 1x1 conv to the style width.
        self.model = nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Conv2d(1024, 256, 1))

    @parity_precision
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        taps = self.vgg(x)
        x = torch.cat([self.conv1(x), taps["conv1_1"]], 1)
        x = torch.cat([self.conv2(x), taps["conv2_1"]], 1)
        x = torch.cat([self.conv3(x), taps["conv3_1"]], 1)
        x = torch.cat([self.conv4(x), taps["conv4_1"]], 1)
        x = x.mean((2, 3), keepdim=True)
        x = conv2d(x, self.model[1].weight, self.model[1].bias)
        return x.reshape(x.shape[0], -1)


class StyleMLP(nn.Module):
    """3 ReLU linear blocks and a final affine -> (B, 2048) adain code."""

    def __init__(self):
        super().__init__()
        self.model = nn.Sequential(LinearBlock(256, 256, "relu"), LinearBlock(256, 256, "relu"),
                                   LinearBlock(256, 256, "relu"), LinearBlock(256, 2048, "none"))

    @parity_precision
    def forward(self, code: torch.Tensor) -> torch.Tensor:
        return self.model(code)


class RGBDecoder(nn.Module):
    """8 modulated convs in 4 residual pairs (mod_conv_2 reused), two
    upsample + LayerNorm conv stages, a 7x7 tanh conv."""

    def __init__(self):
        super().__init__()
        for i in range(1, 9):
            self.add_module(f"mod_conv_{i}", ModulationConvBlock(256, 256, 3))
        self.conv_1 = ConvBlock(256, 128, 5, 1, 2, "ln", "relu", "reflect")
        self.conv_2 = ConvBlock(128, 64, 5, 1, 2, "ln", "relu", "reflect")
        self.conv_3 = ConvBlock(64, 3, 7, 1, 3, "none", "tanh", "reflect")

    @parity_precision
    def forward(self, x: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
        def c(i):
            return code[:, 256 * i: 256 * (i + 1)]

        residual = x
        x = self.mod_conv_1(x, c(0))
        x = self.mod_conv_2(x, c(1)) + residual
        for pair in range(1, 4):
            residual = x
            x = self.mod_conv_2(x, c(2 * pair))
            x = self.mod_conv_2(x, c(2 * pair + 1)) + residual
        x = self.conv_1(upsample_nearest_2x(x))
        x = self.conv_2(upsample_nearest_2x(x))
        return self.conv_3(x)


class C2PGen(nn.Module):
    def __init__(self):
        super().__init__()
        self.RGBEnc = RGBEncoder(4)
        self.PBEnc = PixelBlockEncoder()
        self.MLP = StyleMLP()
        self.RGBDec = RGBDecoder()


class AliasRGBEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.model = RGBEncoder(3).model


class AliasRGBDecoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.Res_Blocks = ResBlocks(3, 256, "in", "relu", "reflect")
        self.conv_1 = ConvBlock(256, 128, 5, 1, 2, "ln", "relu", "reflect")
        self.conv_2 = ConvBlock(128, 64, 5, 1, 2, "ln", "relu", "reflect")
        self.conv_3 = ConvBlock(64, 3, 7, 1, 3, "none", "tanh", "reflect")


class AliasNet(nn.Module):
    """The anti-aliasing net: encoder (instance norm) and decoder, reflect
    padding."""

    def __init__(self):
        super().__init__()
        self.RGBEnc = AliasRGBEncoder()
        self.RGBDec = AliasRGBDecoder()


def style_adain(gen: C2PGen, reference: torch.Tensor, s: float = 1.0,
                precision: str = "float32") -> torch.Tensor:
    """(1, 3, H, W) reference image -> (1, 2048) adain code; constant for a
    fixed reference, so the inference path computes it once."""
    with precision_scope(precision):
        return gen.MLP(gen.PBEnc(reference)) * s


def c2pgen_forward(gen: C2PGen, clipart: torch.Tensor, reference: torch.Tensor = None,
                   s: float = 1.0, adain: torch.Tensor = None,
                   precision: str = "float32") -> torch.Tensor:
    """(B, 3, H, W) in [-1, 1] -> (B, 3, H, W) in [-1, 1], float32. Pass
    ``reference`` (the style image) or a precomputed ``adain`` code. A
    (1, 2048) code serves the whole batch (the modulated convs' dense
    path)."""
    with precision_scope(precision), bf16_activations(precision == "bfloat16"):
        feature = gen.RGBEnc(clipart)
        if adain is None:
            adain = style_adain(gen, reference, s, precision=precision)
        return gen.RGBDec(feature, adain).float()


def _aliasnet_trunk(alias: AliasNet, x: torch.Tensor) -> torch.Tensor:
    """Everything up to (not including) the final 7x7 tanh conv."""
    x = alias.RGBEnc.model(x)
    x = alias.RGBDec.Res_Blocks(x)
    x = alias.RGBDec.conv_1(upsample_nearest_2x(x))
    return alias.RGBDec.conv_2(upsample_nearest_2x(x))


@parity_precision
def _aliasnet_body(alias: AliasNet, x: torch.Tensor) -> torch.Tensor:
    return alias.RGBDec.conv_3(_aliasnet_trunk(alias, x))


@parity_precision
def _aliasnet_body_ds4(alias: AliasNet, x: torch.Tensor) -> torch.Tensor:
    """AliasNet at the /4 sample grid only: the same trunk, then the final
    7x7 conv at stride 4 on the reflect-padded input cropped by (2, 2).
    Output row m is the window at padded row 2 + 4m, so this is
    ``dense[:, :, 2::4, 2::4]`` with 16x fewer windows. Whether it is
    bitwise the dense slice depends on the convolution algorithm chosen;
    the inference path admits it behind its first-batch gate."""
    x = pad2d(_aliasnet_trunk(alias, x), 3, "reflect")[:, :, 2:, 2:]
    conv = alias.RGBDec.conv_3.conv
    return torch.tanh(conv2d(x, conv.weight, conv.bias, stride=4))


def aliasnet_forward(alias: AliasNet, x: torch.Tensor,
                     precision: str = "float32") -> torch.Tensor:
    with precision_scope(precision), bf16_activations(precision == "bfloat16"):
        return _aliasnet_body(alias, x).float()


def aliasnet_forward_ds4(alias: AliasNet, x: torch.Tensor,
                         precision: str = "float32") -> torch.Tensor:
    """(B, 3, H, W) -> (B, 3, H/4, W/4): AliasNet at the /4 samples only
    (``_aliasnet_body_ds4``)."""
    with precision_scope(precision), bf16_activations(precision == "bfloat16"):
        return _aliasnet_body_ds4(alias, x).float()

"""P2CGen, the pixel-art -> clipart generator the GAN trainer trains, as a
torch module with the JAX package's state keys.

P2CGen(dim=64, n_res=3), as ``dither_pie_tpu/models/p2cgen.py`` runs it:

  RGBEnc:  ConvBlock 7x7 s1 'in' -> 2x ConvBlock 4x4 s2 'in'
           -> ResBlocks(n_res, 'in')          keys RGBEnc.model.{0,1,2,3}
  RGBDec:  ResBlocks(n_res, 'in') -> [2x nearest up -> ConvBlock 5x5 'ln']
           x2 -> ConvBlock 7x7 'none' tanh    keys RGBDec.Res_Blocks,
                                              RGBDec.conv_{1,2,3}

all with reflect padding and ReLU. It is AliasNet's layer stack at width
``dim`` (``c2pgen.RGBEncoder``, ``c2pgen.AliasRGBDecoder``), so its
forward is AliasNet's body.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from dither_pie_tpu_torch.models.c2pgen import AliasRGBDecoder, RGBEncoder, _aliasnet_body


class P2CGen(nn.Module):
    def __init__(self, dim: int = 64, n_res: int = 3):
        super().__init__()
        self.RGBEnc = RGBEncoder(n_res, dim)
        self.RGBDec = AliasRGBDecoder(n_res, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _aliasnet_body(self, x)


def p2cgen_forward(gen: P2CGen, x: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) in [-1, 1] -> (B, 3, H, W) in [-1, 1], in float32 with
    TF32 off unless a ``precision_scope`` is open. H and W must be
    multiples of 4 (two stride-2 downs, two 2x ups)."""
    if x.shape[-2] % 4 or x.shape[-1] % 4:
        raise ValueError(f"P2CGen needs H and W that are multiples of 4, got "
                         f"{tuple(x.shape[-2:])}")
    return gen(x)

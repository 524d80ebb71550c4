"""CPDis / CPDis_cls, the PatchGAN discriminators of the GAN trainer, and
the margin-product heads, as torch modules and plain functions with the
JAX package's state keys (``dither_pie_tpu/models/discriminator.py``).

* The spectral norm is the reference's hand-rolled one, not
  ``torch.nn.utils.spectral_norm``: ONE power iteration per forward (in
  eval too), u and v detached, and the weight divided by
  sigma = u . (W v), where ``_l2n`` divides by (||v|| + eps).
  ``spectral_norm_weight`` is a plain function of (weight_bar, u, v); the
  forwards take the u/v state explicitly and return the walked state
  without writing it, so a caller decides which walk is stored
  (``SNConv2d.store_uv``), as the JAX trainer merges its updates dicts.
* ``weight_bar`` stays in the torch (O, I, 4, 4) layout: the power
  iteration runs on its (O, I*4*4) flattening.
* The trunk: 4x4 convs, zero pad 1, strides 2/2/2/1, LeakyReLU(0.01),
  widths conv_dim x (1, 2, 4, 8), then a bias-free 4x4 conv to one patch
  logit. CPDis_cls adds a global average pool, a 1x1 ``classifier_conv``
  and the CosFace head on 7 classes.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dither_pie_tpu_torch.models.layers import conv2d, parity_precision

#: (key, in_ch, out_ch, stride) of the trunk at conv_dim 64
TRUNK = (
    ("main.0", 3, 64, 2),
    ("main.2", 64, 128, 2),
    ("main.4", 128, 256, 2),
    ("main.6", 256, 512, 1),
)
SN_KEYS = tuple(key for key, _, _, _ in TRUNK) + ("conv1",)
N_CLASSES = 7  # MarginCosineProduct(512, 7)
LRELU_SLOPE = 0.01

#: u/v state of the spectral-norm convs: {conv key: (u, v)}
UV = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def _l2n(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """v / (||v|| + eps); not ``F.normalize``, which divides by
    max(||v||, eps)."""
    return v / (torch.linalg.vector_norm(v) + eps)


def spectral_norm_weight(w_bar: torch.Tensor, u: torch.Tensor, v: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One power iteration -> (w_bar / sigma, u', v').

    w_bar: (O, ...) torch-layout weight; u: (O,); v: (prod(rest),), unused
    by the walk (v' comes from u). u' and v' are computed from the
    detached weight and carry no gradient; sigma keeps the w_bar
    dependency only."""
    w2d = w_bar.reshape(w_bar.shape[0], -1)
    w2d_ng = w2d.detach()
    v = _l2n(w2d_ng.t() @ u.detach())
    u = _l2n(w2d_ng @ v)
    sigma = u @ (w2d @ v)
    return w_bar / sigma, u, v


class SNConv2d(nn.Module):
    """A spectral-normalised 4x4 conv, zero pad 1: ``weight_bar``
    (O, I, 4, 4), the buffers ``weight_u`` (O,) and ``weight_v`` (I*16,),
    and ``bias`` where the JAX one has it."""

    def __init__(self, cin: int, cout: int, stride: int, bias: bool = True):
        super().__init__()
        self.stride = stride
        self.weight_bar = nn.Parameter(torch.zeros(cout, cin, 4, 4))
        self.register_buffer("weight_u", torch.zeros(cout))
        self.register_buffer("weight_v", torch.zeros(cin * 16))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor, uv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """(conv output, walked (u, v)); the walk starts from ``uv``, or
        from the stored buffers when it is None."""
        u, v = uv if uv is not None else (self.weight_u, self.weight_v)
        w_hat, u, v = spectral_norm_weight(self.weight_bar, u, v)
        return conv2d(F.pad(x, (1, 1, 1, 1)), w_hat, self.bias, self.stride), (u, v)

    @torch.no_grad()
    def store_uv(self, uv: Tuple[torch.Tensor, torch.Tensor]) -> None:
        self.weight_u.copy_(uv[0])
        self.weight_v.copy_(uv[1])


class MarginCosineProduct(nn.Module):
    """Holds the CosFace head's (out_features, in_features) ``weight``."""

    def __init__(self, cin: int, n_classes: int = N_CLASSES):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(n_classes, cin))


class CPDis(nn.Module):
    """The PatchGAN discriminator: ``main.{0,2,4,6}`` and ``conv1``."""

    def __init__(self, conv_dim: int = 64):
        super().__init__()
        layers, cin = [], 3
        for i, (_, _, _, stride) in enumerate(TRUNK):
            cout = conv_dim * (1 << i)
            layers += [SNConv2d(cin, cout, stride), nn.LeakyReLU(LRELU_SLOPE)]
            cin = cout
        self.main = nn.Sequential(*layers)
        self.conv1 = SNConv2d(cin, 1, 1, bias=False)

    def sn_conv(self, key: str) -> SNConv2d:
        """The spectral-norm conv of ``key`` in ``SN_KEYS``."""
        return self.conv1 if key == "conv1" else self.main[int(key.split(".")[1])]

    def store_uv(self, uv: UV) -> None:
        """Write a walked u/v state into the buffers."""
        for key in SN_KEYS:
            self.sn_conv(key).store_uv(uv[key])

    def trunk(self, x: torch.Tensor, uv: Optional[UV], walked: UV) -> torch.Tensor:
        for key, _, _, _ in TRUNK:
            x, walked[key] = self.sn_conv(key)(x, None if uv is None else uv[key])
            x = F.leaky_relu(x, LRELU_SLOPE)
        return x

    def forward(self, x: torch.Tensor, uv: Optional[UV] = None) -> Tuple[torch.Tensor, UV]:
        return cpdis_forward(self, x, uv)


class CPDis_cls(CPDis):  # noqa: N801 (the reference's class name)
    """CPDis with the class head: ``classifier_conv`` (1x1) and
    ``classifier`` (the CosFace weight)."""

    def __init__(self, conv_dim: int = 64):
        super().__init__(conv_dim)
        cin = conv_dim * 8
        self.classifier_conv = nn.Conv2d(cin, cin, 1)
        self.classifier = MarginCosineProduct(cin)

    def forward(self, x: torch.Tensor, label: torch.Tensor, uv: Optional[UV] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, UV]:
        return cpdis_cls_forward(self, x, label, uv)


@parity_precision
def cpdis_forward(dis: CPDis, x: torch.Tensor, uv: Optional[UV] = None
                  ) -> Tuple[torch.Tensor, UV]:
    """(B, 3, H, W) -> ((B, 1, H', W') patch logits, the walked u/v state).
    The walk starts from ``uv``, or from the buffers when it is None; the
    buffers are not written. H and W must be at least 32."""
    walked: UV = {}
    h = dis.trunk(x, uv, walked)
    out, walked["conv1"] = dis.conv1(h, None if uv is None else uv["conv1"])
    return out, walked


@parity_precision
def cpdis_cls_forward(dis: CPDis_cls, x: torch.Tensor, label: torch.Tensor,
                      uv: Optional[UV] = None) -> Tuple[torch.Tensor, torch.Tensor, UV]:
    """(B, 3, H, W), (B,) int labels -> (patch logits, (B, 7) margin
    logits, the walked u/v state)."""
    walked: UV = {}
    h = dis.trunk(x, uv, walked)
    pooled = h.mean((2, 3), keepdim=True)
    cc = dis.classifier_conv
    feat = conv2d(pooled, cc.weight, cc.bias).reshape(x.shape[0], -1)
    out_cls = margin_cosine_product(feat, dis.classifier.weight, label)
    out, walked["conv1"] = dis.conv1(h, None if uv is None else uv["conv1"])
    return out, out_cls, walked


# ---------------------------------------------------------------------------
# Margin-product heads. ``weight`` is (out_features, in_features).
# ---------------------------------------------------------------------------

def cosine_sim(x1: torch.Tensor, x2: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(B, D), (K, D) -> (B, K) cosines, the norms' product clamped at eps."""
    ip = x1 @ x2.t()
    w1 = torch.linalg.vector_norm(x1, dim=1)
    w2 = torch.linalg.vector_norm(x2, dim=1)
    return ip / torch.clamp_min(torch.outer(w1, w2), eps)


def _one_hot(label: torch.Tensor, k: int) -> torch.Tensor:
    return F.one_hot(label.reshape(-1).long(), k).float()


def margin_cosine_product(x: torch.Tensor, weight: torch.Tensor, label: torch.Tensor,
                          s: float = 30.0, m: float = 0.40) -> torch.Tensor:
    """CosFace: s * (cos - one_hot * m)."""
    return s * (cosine_sim(x, weight) - _one_hot(label, weight.shape[0]) * m)


def _f_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Rows over max(||x||, eps), as ``F.normalize(dim=1)``."""
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=1, keepdim=True), eps)


def _angular_phi(cosine: torch.Tensor, m: float, easy_margin: bool) -> torch.Tensor:
    sine = torch.sqrt(1.0 - cosine ** 2)
    phi = cosine * math.cos(m) - sine * math.sin(m)
    if easy_margin:
        return torch.where(cosine > 0, phi, cosine)
    th = math.cos(math.pi - m)
    mm = math.sin(math.pi - m) * m
    return torch.where(cosine - th > 0, phi, cosine - mm)


def arc_margin_product(x: torch.Tensor, weight: torch.Tensor, label: torch.Tensor,
                       s: float = 32.0, m: float = 0.50,
                       easy_margin: bool = False) -> torch.Tensor:
    """ArcFace: the additive angular margin m on the label's class."""
    cosine = _f_normalize(x) @ _f_normalize(weight).t()
    phi = _angular_phi(cosine, m, easy_margin)
    one_hot = _one_hot(label, weight.shape[0])
    return (one_hot * phi + (1.0 - one_hot) * cosine) * s


def multi_margin_product(x: torch.Tensor, weight: torch.Tensor, label: torch.Tensor,
                         s: float = 32.0, m1: float = 0.20, m2: float = 0.35,
                         easy_margin: bool = False) -> torch.Tensor:
    """An angular margin m1 and a cosine margin m2 on the label's class."""
    cosine = _f_normalize(x) @ _f_normalize(weight).t()
    phi = _angular_phi(cosine, m1, easy_margin)
    one_hot = _one_hot(label, weight.shape[0])
    out = one_hot * phi + (1.0 - one_hot) * cosine
    return (out - one_hot * m2) * s

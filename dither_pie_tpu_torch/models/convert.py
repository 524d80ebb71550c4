"""Weights of the neural pixelizer: the reference checkpoints, the JAX
package's layout, and the port's state dicts.

The port's modules keep the reference checkpoints' keys and layouts
(OIHW convs, (O, I) linears, (O, I, k, k) modulated-conv buffers), so a
reference state dict needs only its keys sorted out:

* the VGG19 taps live under ``PBEnc.vgg.<idx>`` and only indices <= 19
  (conv4_1, the deepest tap) are kept; the standalone
  ``pixelart_vgg19.pth`` (``features.<idx>``) is authoritative for them, as
  the reference loads it inside PixelBlockEncoder;
* ``running_*`` and ``num_batches_tracked`` entries are dropped.

``state_from_jax`` carries the JAX package's params (its
``random_params``, or its ``dither_pie_tpu_params.npz`` cache) into that
layout: HWIO -> OIHW, (I, O) -> (O, I), the modulated convs' (k, k, I, O)
back through the raw reshape to (O, I, k, k), ``vgg.<idx>`` ->
``PBEnc.vgg.<idx>``.

The GAN trainer's nets: ``p2cgen_state_from_jax`` transposes P2CGen's
HWIO convs to OIHW; ``cpdis_state_from_jax`` passes every tensor through
untransposed, since the JAX package keeps the discriminator in torch
layout (its power iteration is defined on the (O, I*kh*kw) flattening).
``train_state_from_jax`` builds a port ``GANTrainState`` from a JAX one.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from dither_pie_tpu_torch.api.runtime import resolve_device
from dither_pie_tpu_torch.models.discriminator import CPDis
from dither_pie_tpu_torch.models.p2cgen import P2CGen
from dither_pie_tpu_torch.models.training import BETAS, set_adam_state, train_state, uninitialised

VGG_MAX_INDEX = 19  # conv4_1, the deepest tap used at inference
CACHE_NAME = "dither_pie_tpu_params.npz"  # the JAX package's converted cache

State = Dict[str, torch.Tensor]


def _keep(key: str) -> bool:
    return "running_" not in key and "num_batches_tracked" not in key


def _f32(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.float32))


def _from_jax_tensor(key: str, w: np.ndarray) -> torch.Tensor:
    w = np.asarray(w, dtype=np.float32)
    if w.ndim == 4:
        kh, kw, i, o = w.shape
        if ".mod_conv_" in key:
            return _f32(w.reshape(o, i, kh, kw))  # the raw view, undone
        return _f32(w.transpose(3, 2, 0, 1))
    if w.ndim == 2:
        return _f32(w.T)
    return _f32(w)


def state_from_jax(gen_params: Dict[str, np.ndarray],
                   alias_params: Dict[str, np.ndarray]) -> Tuple[State, State]:
    """The JAX package's (gen_params, alias_params) as the port's
    (generator state dict, AliasNet state dict)."""
    gen = {}
    for k, v in gen_params.items():
        key = f"PBEnc.{k}" if k.startswith("vgg.") else k
        gen[key] = _from_jax_tensor(k, v)
    alias = {k: _from_jax_tensor(k, v) for k, v in alias_params.items()}
    return gen, alias


def generator_state(state: Dict[str, torch.Tensor]) -> State:
    """The reference C2PGen state dict ('160_net_G_A.pth') as the port's."""
    out = {}
    for k, v in state.items():
        if k.startswith("PBEnc.vgg.") and int(k.split(".")[2]) > VGG_MAX_INDEX:
            continue
        if _keep(k):
            out[k] = _f32(v)
    return out


def aliasnet_state(state: Dict[str, torch.Tensor]) -> State:
    """The reference AliasNet state dict ('alias_net.pth') as the port's."""
    return {k: _f32(v) for k, v in state.items() if _keep(k)}


def vgg19_state(state: Dict[str, torch.Tensor]) -> State:
    """The standalone torchvision vgg19 ('pixelart_vgg19.pth') as the
    generator's ``PBEnc.vgg`` entries."""
    out = {}
    for k, v in state.items():
        if not k.startswith("features."):
            continue
        idx = int(k.split(".")[1])
        if idx <= VGG_MAX_INDEX:
            out[f"PBEnc.vgg.{idx}.{k.split('.')[-1]}"] = _f32(v)
    return out


def load_torch_state(path: str) -> Dict[str, torch.Tensor]:
    return dict(torch.load(path, weights_only=True, map_location="cpu"))


def convert_checkpoints(ckpt_dir: str) -> Tuple[State, State]:
    """(generator state, AliasNet state) from ``ckpt_dir``: the JAX
    package's ``dither_pie_tpu_params.npz`` where the directory holds one,
    else the three reference checkpoints, the VGG taps from
    ``pixelart_vgg19.pth``."""
    d = Path(ckpt_dir)
    cache_path = d / CACHE_NAME
    if cache_path.exists():
        with np.load(cache_path) as data:
            gen = {k[4:]: data[k] for k in data.files if k.startswith("gen:")}
            alias = {k[6:]: data[k] for k in data.files if k.startswith("alias:")}
        return state_from_jax(gen, alias)
    gen = generator_state(load_torch_state(str(d / "160_net_G_A.pth")))
    gen.update(vgg19_state(load_torch_state(str(d / "pixelart_vgg19.pth"))))
    alias = aliasnet_state(load_torch_state(str(d / "alias_net.pth")))
    return gen, alias


def find_checkpoint_dir() -> str:
    """Search order: $DITHER_PIE_TPU_CKPT_DIR, cwd, the package parent."""
    candidates = []
    env = os.environ.get("DITHER_PIE_TPU_CKPT_DIR")
    if env:
        candidates.append(env)
    candidates += [".", str(Path(__file__).resolve().parents[2])]
    for c in candidates:
        if (Path(c) / "160_net_G_A.pth").exists() or (Path(c) / CACHE_NAME).exists():
            return c
    raise FileNotFoundError(
        "Neural pixelizer checkpoints not found. Place 160_net_G_A.pth, "
        "alias_net.pth and pixelart_vgg19.pth in the working directory or "
        "set DITHER_PIE_TPU_CKPT_DIR. (The reference distributes them "
        "out-of-band — see its README 'Download pretrained models'.)")


def p2cgen_state_from_jax(params: Dict[str, np.ndarray]) -> State:
    """The JAX package's P2CGen params (HWIO convs) as the port's state dict."""
    return {k: _from_jax_tensor(k, v) for k, v in params.items()}


def cpdis_state_from_jax(params: Dict[str, np.ndarray]) -> State:
    """The JAX package's CPDis / CPDis_cls params (torch layout already) as
    the port's state dict, every tensor untransposed."""
    return {k: _f32(v) for k, v in params.items()}


def train_state_from_jax(g_params: Dict[str, np.ndarray], d_params: Dict[str, np.ndarray],
                         g_adam: Sequence, d_adam: Sequence, lr: float = 2e-4,
                         betas=BETAS, device="cuda"):
    """A port ``GANTrainState`` from numpy copies of a JAX one: the nets'
    params, and each Adam state as (count, mu, nu), the fields of optax's
    ``ScaleByAdamState``. count becomes torch Adam's ``step`` and mu / nu
    its ``exp_avg`` / ``exp_avg_sq``, laid out as their weights; the
    moments of ``weight_u`` / ``weight_v`` (zeros: they take no gradient)
    are dropped, as these are buffers in the port. The state is built on
    ``device``, the card unless the caller asks for the CPU."""
    dev = resolve_device(device)
    dim = int(np.shape(g_params["RGBEnc.model.0.conv.weight"])[-1])
    conv_dim = int(np.shape(d_params["main.0.weight_bar"])[0])
    G = uninitialised(lambda: P2CGen(dim))
    G.load_state_dict(p2cgen_state_from_jax(g_params))
    D = uninitialised(lambda: CPDis(conv_dim))
    D.load_state_dict(cpdis_state_from_jax(d_params))
    state = train_state(G.to(dev), D.to(dev), lr, betas)
    for net, opt, adam, conv in ((state.G, state.g_opt, g_adam, p2cgen_state_from_jax),
                                 (state.D, state.d_opt, d_adam, cpdis_state_from_jax)):
        count, mu, nu = adam
        steps = {k: float(np.asarray(count)) for k, _ in net.named_parameters()}
        set_adam_state(opt, net, steps, conv(mu), conv(nu))
    return state

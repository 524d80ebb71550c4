"""The GAN training stack: initialisation, learning-rate schedules, the
train step and exact checkpoints, as the JAX package's
``models/training.py`` defines them, on torch modules and ``torch.optim``.

* ``init_p2cgen`` / ``init_cpdis`` draw every tensor from an explicit
  ``torch.Generator`` (on the CPU, so a seed gives the same nets on every
  device) with the JAX package's distributions: P2CGen's convs
  N(0, 0.02) and zero biases (``init_weights('normal', 0.02)``), its
  LayerNorm gamma U[0, 1) and beta 0; the discriminator keeps the
  reference's quirk that ``init_weights`` misses the spectral-norm convs,
  so ``weight_bar`` is torch's default U(+-1/sqrt(fan_in)), u and v are
  N(0, 1) and the biases zero; CPDis_cls' ``classifier_conv`` is
  N(0, 0.02) and its CosFace weight xavier-uniform.
* ``make_gan_train_step`` is one D update then one G update (pix2pix):
  D: 0.5 [gan(D(real), True) + gan(D(G(src)), False)],
  G: gan(D'(G(src)), True) + lambda_l1 L1(G(src), real), D' the updated D.
  The whole step (forwards, backwards and both Adam steps) runs in
  float32 with TF32 off. The spectral norm's cadence is the JAX step's:
  the real forward walks u/v once from the stored state, the fake forward
  walks again from there and normalises with that sigma, the twice-walked
  state is stored after D's Adam step, and G's D forward walks once more
  for its sigma and discards the walk.
* ``make_gan_train_step(mesh=)``: the same step data-parallel over the
  mesh's 'data' devices in one process (``shard_batch`` places a batch).
  The state stays on the first device; the others hold replicas of G and
  D, refreshed from it before each step and again after D's update (G's
  loss runs through the updated D). Each replica runs its shard, the
  gradients are summed onto the first device in device order and divided
  by the number of shards, and each Adam steps once there. The spectral
  norm's u/v come from the first device; the metrics are the mean over
  the shards. Equal shards make this the one-device step on the whole
  batch up to float32 rounding.
* ``save_train_state`` / ``load_train_state``: one ``.npz`` by name
  (parameters, buffers, Adam's step and moments, the step, scalar
  side-state), so a resumed run continues exactly.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from dither_pie_tpu_torch.api.runtime import resolve_device
from dither_pie_tpu_torch.models.discriminator import (
    N_CLASSES,
    SN_KEYS,
    CPDis,
    CPDis_cls,
    cpdis_forward,
)
from dither_pie_tpu_torch.models.layers import LayerNorm, precision_scope
from dither_pie_tpu_torch.models.losses import GAN_MODES, gan_loss
from dither_pie_tpu_torch.models.p2cgen import P2CGen, p2cgen_forward
from dither_pie_tpu_torch.parallel.mesh import (
    Mesh,
    NamedSharding,
    Sharded,
    axis_pieces,
    device_put,
    mean_in_order,
)

BETAS = (0.5, 0.999)
INIT_TYPES = ("normal", "xavier", "kaiming", "orthogonal")


# ---------------------------------------------------------------------------
# Initialisation
# ---------------------------------------------------------------------------

def uninitialised(ctor: Callable[[], nn.Module]) -> nn.Module:
    """The module ``ctor`` builds, on the CPU, without drawing from torch's
    global generator; every tensor must then be written."""
    with torch.device("meta"):
        module = ctor()
    return module.to_empty(device="cpu")


@torch.no_grad()
def init_weights(module: nn.Module, init_type: str = "normal", init_gain: float = 0.02,
                 generator: Optional[torch.Generator] = None) -> nn.Module:
    """The reference's ``init_weights`` over a module: every conv or linear
    ``*.weight`` (ndim 4 or 2) gets normal | xavier | kaiming | orthogonal
    and its bias goes to zero; ``classifier.*``, the norm affines and the
    spectral-norm ``weight_bar`` keep their own init. Fans are torch's:
    fan_in = I kh kw, fan_out = O kh kw. Orthogonal filters are
    orthonormal over the (O, I kh kw) flattening."""
    if init_type not in INIT_TYPES:
        raise NotImplementedError(f"initialization method {init_type} is not implemented")
    params = dict(module.named_parameters())
    for key, w in params.items():
        if not key.endswith(".weight") or w.ndim not in (2, 4) or key.startswith("classifier."):
            continue
        rf = w[0, 0].numel()
        fan_in, fan_out = w.shape[1] * rf, w.shape[0] * rf
        if init_type == "normal":
            w.normal_(0.0, init_gain, generator=generator)
        elif init_type == "xavier":
            w.normal_(0.0, init_gain * math.sqrt(2.0 / (fan_in + fan_out)), generator=generator)
        elif init_type == "kaiming":
            w.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
        else:
            nn.init.orthogonal_(w, init_gain, generator=generator)
        bias = params.get(key[: -len("weight")] + "bias")
        if bias is not None:
            bias.zero_()
    return module


@torch.no_grad()
def init_p2cgen(dim: int = 64, generator: Optional[torch.Generator] = None,
                n_res: int = 3) -> P2CGen:
    """A fresh P2CGen on the CPU: LayerNorm gamma U[0, 1), beta 0, then
    ``init_weights('normal', 0.02)``."""
    gen = uninitialised(lambda: P2CGen(dim, n_res))
    for m in gen.modules():
        if isinstance(m, LayerNorm):
            m.gamma.uniform_(0.0, 1.0, generator=generator)
            m.beta.zero_()
    return init_weights(gen, "normal", 0.02, generator)


@torch.no_grad()
def init_cpdis(conv_dim: int = 64, cls: bool = False,
               generator: Optional[torch.Generator] = None) -> CPDis:
    """A fresh CPDis (or CPDis_cls) on the CPU: ``weight_bar``
    U(+-1/sqrt(fan_in)), u and v N(0, 1), biases 0; with ``cls``,
    ``classifier_conv`` N(0, 0.02) with a zero bias and the CosFace weight
    xavier-uniform."""
    dis = uninitialised(lambda: (CPDis_cls if cls else CPDis)(conv_dim))
    for key in SN_KEYS:
        conv = dis.sn_conv(key)
        bound = 1.0 / math.sqrt(conv.weight_bar[0].numel())
        conv.weight_bar.uniform_(-bound, bound, generator=generator)
        conv.weight_u.normal_(generator=generator)
        conv.weight_v.normal_(generator=generator)
        if conv.bias is not None:
            conv.bias.zero_()
    if cls:
        cin = dis.classifier_conv.weight.shape[0]
        dis.classifier_conv.weight.normal_(0.0, 0.02, generator=generator)
        dis.classifier_conv.bias.zero_()
        limit = math.sqrt(6.0 / (cin + N_CLASSES))
        dis.classifier.weight.uniform_(-limit, limit, generator=generator)
    return dis


# ---------------------------------------------------------------------------
# Learning-rate schedules: linear, step and cosine are functions of the
# epoch; plateau is a small stateful class with torch's semantics.
# ---------------------------------------------------------------------------

def lr_schedule(policy: str, base_lr: float, *, epoch_count: int = 1,
                n_epochs: int = 100, n_epochs_decay: int = 100,
                lr_decay_iters: int = 50) -> Callable[[int], float]:
    if policy == "linear":
        def fn(epoch):
            return base_lr * (1.0 - max(0, epoch + epoch_count - n_epochs)
                              / float(n_epochs_decay + 1))
    elif policy == "step":
        def fn(epoch):
            return base_lr * 0.1 ** (epoch // lr_decay_iters)
    elif policy == "cosine":
        def fn(epoch):
            # closed form of torch CosineAnnealingLR(T_max, eta_min=0)
            return base_lr * (1 + math.cos(math.pi * epoch / n_epochs)) / 2
    else:
        raise NotImplementedError(f"learning rate policy [{policy}] is not implemented")
    return fn


class ReduceLROnPlateau:
    """torch ReduceLROnPlateau(mode='min', factor=0.2, threshold=0.01,
    patience=5): relative threshold, cooldown 0, min_lr 0, eps 1e-8."""

    def __init__(self, base_lr: float, factor: float = 0.2, threshold: float = 0.01,
                 patience: int = 5, eps: float = 1e-8):
        self.lr = float(base_lr)
        self.factor, self.threshold = factor, threshold
        self.patience, self.eps = patience, eps
        self.best = math.inf
        self.num_bad_epochs = 0

    def step(self, metric: float) -> float:
        # torch moves `best` only when the relative test passes: a slow
        # drift below the threshold keeps it pinned and patience counting.
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            new_lr = self.lr * self.factor
            if self.lr - new_lr > self.eps:
                self.lr = new_lr
            self.num_bad_epochs = 0
        return self.lr


# ---------------------------------------------------------------------------
# The GAN train step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GANTrainState:
    G: P2CGen
    D: CPDis  # its buffers hold the spectral norm's u/v state
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam

    def set_lr(self, lr: float) -> None:
        for opt in (self.g_opt, self.d_opt):
            for group in opt.param_groups:
                group["lr"] = lr


def train_state(G: P2CGen, D: CPDis, lr: float = 2e-4, betas=BETAS) -> GANTrainState:
    """G and D (on one device) with a fresh Adam(lr, betas) each."""
    return GANTrainState(G, D, torch.optim.Adam(G.parameters(), lr=lr, betas=betas),
                         torch.optim.Adam(D.parameters(), lr=lr, betas=betas))


def gan_init(lr: float = 2e-4, betas=BETAS, dim: int = 64, conv_dim: int = 64,
             seed: int = 0, device="cuda") -> GANTrainState:
    """A fresh P2CGen + CPDis from ``seed`` on ``device`` (the card unless
    the caller asks for the CPU), each with Adam(lr, betas)."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    G = init_p2cgen(dim, g)
    D = init_cpdis(conv_dim, generator=g)
    return train_state(G.to(dev), D.to(dev), lr, betas)


@contextlib.contextmanager
def step_scope(deterministic: bool):
    """float32 with TF32 off for everything inside (forwards, backwards,
    optimizer steps), cuDNN's deterministic algorithms as asked."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=False, deterministic=deterministic,
                     allow_tf32=False), precision_scope("float32"):
        yield


def _d_loss(G: P2CGen, D: CPDis, src: torch.Tensor, real: torch.Tensor, gan_mode: str):
    """G's fake and D's loss on one batch: (fake, d_loss, the walked u/v)."""
    fake = p2cgen_forward(G, src)
    pred_real, uv = cpdis_forward(D, real)
    pred_fake, uv = cpdis_forward(D, fake.detach(), uv)
    d_loss = 0.5 * (gan_loss(pred_real, True, gan_mode) + gan_loss(pred_fake, False, gan_mode))
    return fake, d_loss, uv


def _g_loss(D: CPDis, fake: torch.Tensor, real: torch.Tensor, gan_mode: str,
            lambda_l1: float):
    """G's loss through D (whose parameters take no gradient here):
    (g_loss, adv, l1)."""
    pred_fake, _ = cpdis_forward(D, fake)
    adv = gan_loss(pred_fake, True, gan_mode)
    l1 = (fake - real).abs().mean()
    return adv + lambda_l1 * l1, adv, l1


def make_gan_train_step(gan_mode: str = "lsgan", lambda_l1: float = 100.0,
                        mesh: Optional[Mesh] = None, deterministic: bool = True,
                        data_axis: str = "data"):
    """``step(state, src, real) -> metrics``: one D update then one G update
    in place, on (B, 3, H, W) batches in [-1, 1] on the state's device.
    The metrics are 0-dim tensors: d_loss, g_loss, g_adv, g_l1.

    G runs forward once: D's step sees the fake detached, G's loss the same
    fake through the updated D, whose parameters take no gradient there.
    ``deterministic`` pins cuDNN to its deterministic algorithms, so that
    a resumed run repeats an uninterrupted one bitwise on the card (the
    CPU is deterministic either way).

    ``mesh``: the batch splits over ``data_axis`` (the state on the mesh's
    first device; ``src`` and ``real`` host arrays, tensors or
    ``shard_batch``'s result; see the module docstring)."""
    if gan_mode not in GAN_MODES:
        raise NotImplementedError(f"gan mode {gan_mode} not implemented")
    if mesh is not None:
        return _mesh_train_step(gan_mode, lambda_l1, mesh, deterministic, data_axis)

    def step(state: GANTrainState, src: torch.Tensor, real: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
        G, D = state.G, state.D
        with step_scope(deterministic):
            fake, d_loss, uv = _d_loss(G, D, src, real, gan_mode)
            state.d_opt.zero_grad(set_to_none=True)
            d_loss.backward()
            state.d_opt.step()
            D.store_uv(uv)

            D.requires_grad_(False)
            try:
                g_loss, adv, l1 = _g_loss(D, fake, real, gan_mode, lambda_l1)
                state.g_opt.zero_grad(set_to_none=True)
                g_loss.backward()
            finally:
                D.requires_grad_(True)
            state.g_opt.step()
        return {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(),
                "g_adv": adv.detach(), "g_l1": l1.detach()}

    return step


@torch.no_grad()
def _refresh(src: nn.Module, dst: nn.Module) -> None:
    """``dst``'s parameters and buffers set to ``src``'s."""
    for a, b in zip(src.parameters(), dst.parameters()):
        b.copy_(a)
    for a, b in zip(src.buffers(), dst.buffers()):
        b.copy_(a)


def _reduce_grads(primary: nn.Module, replicas: List[nn.Module]) -> None:
    """Each of ``primary``'s gradients set to the mean of its own and the
    replicas' (summed in device order on the primary's device); the
    replicas' gradients are dropped."""
    for p, *qs in zip(primary.parameters(), *(r.parameters() for r in replicas)):
        p.grad = mean_in_order([p.grad] + [q.grad for q in qs], p.device)
    for r in replicas:
        r.zero_grad(set_to_none=True)


def _mesh_train_step(gan_mode: str, lambda_l1: float, mesh: Mesh, deterministic: bool,
                     data_axis: str):
    devices = mesh.axis_devices(data_axis)
    # The primary pair the replicas were copied from (held, so that a new
    # state is never taken for it), and [(G_k, D_k) for k >= 1].
    cache = {"primary": None, "replicas": []}

    def nets(state: GANTrainState):
        dev = next(state.G.parameters()).device
        if dev != devices[0]:
            raise ValueError(f"the train state is on {dev}, the mesh's first device is "
                             f"{devices[0]}")
        primary = cache["primary"]
        if primary is None or primary[0] is not state.G or primary[1] is not state.D:
            cache["primary"] = (state.G, state.D)
            cache["replicas"] = [(copy.deepcopy(state.G).to(d), copy.deepcopy(state.D).to(d))
                                 for d in devices[1:]]
        return [(state.G, state.D)] + cache["replicas"]

    def step(state: GANTrainState, src, real) -> Dict[str, torch.Tensor]:
        pairs = nets(state)
        Gs, Ds = [g for g, _ in pairs], [d for _, d in pairs]
        srcs = axis_pieces(src, mesh, data_axis)
        reals = axis_pieces(real, mesh, data_axis)
        with step_scope(deterministic):
            for G_k, D_k in pairs[1:]:
                _refresh(state.G, G_k)
                _refresh(state.D, D_k)
            fakes, d_losses, uvs = zip(*(_d_loss(G_k, D_k, s, r, gan_mode)
                                         for (G_k, D_k), s, r in zip(pairs, srcs, reals)))
            for D_k in Ds:
                D_k.zero_grad(set_to_none=True)
            torch.autograd.backward(list(d_losses))
            _reduce_grads(state.D, Ds[1:])
            state.d_opt.step()
            state.D.store_uv(uvs[0])
            for D_k in Ds[1:]:
                _refresh(state.D, D_k)  # G's loss runs through the updated D

            for D_k in Ds:
                D_k.requires_grad_(False)
            try:
                g_terms = [_g_loss(D_k, f, r, gan_mode, lambda_l1)
                           for D_k, f, r in zip(Ds, fakes, reals)]
                for G_k in Gs:
                    G_k.zero_grad(set_to_none=True)
                torch.autograd.backward([g for g, _, _ in g_terms])
            finally:
                for D_k in Ds:
                    D_k.requires_grad_(True)
            _reduce_grads(state.G, Gs[1:])
            state.g_opt.step()
        first = devices[0]
        mean = lambda vals: mean_in_order([v.detach() for v in vals], first)  # noqa: E731
        return {"d_loss": mean(d_losses), "g_loss": mean([g for g, _, _ in g_terms]),
                "g_adv": mean([a for _, a, _ in g_terms]),
                "g_l1": mean([l1 for _, _, l1 in g_terms])}

    return step


def shard_batch(mesh: Mesh, arr, data_axis: str = "data") -> Sharded:
    """A host batch placed on the mesh, split over its data axis (and
    replicated over any other)."""
    return device_put(arr, NamedSharding(mesh, (data_axis,)))


# ---------------------------------------------------------------------------
# Checkpoints: one .npz by name. Keys: G.<state key>, D.<state key> (the
# parameters and the u/v buffers), g_adam.<param>.{step,exp_avg,exp_avg_sq},
# d_adam.<param>.{...}, __step__, extra_<name>.
# ---------------------------------------------------------------------------

_ADAM_KEYS = ("step", "exp_avg", "exp_avg_sq")


def _nets(state: GANTrainState):
    return (("G", "g_adam", state.G, state.g_opt), ("D", "d_adam", state.D, state.d_opt))


def set_adam_state(opt: torch.optim.Adam, module: nn.Module, steps: Dict[str, float],
                   exp_avg: Dict[str, torch.Tensor], exp_avg_sq: Dict[str, torch.Tensor]
                   ) -> None:
    """Adam's state of each named parameter of ``module``: its step count
    and moments (copied to the parameter's device)."""
    for name, p in module.named_parameters():
        opt.state[p] = {"step": torch.tensor(float(steps[name]), dtype=torch.float32),
                        "exp_avg": exp_avg[name].to(p.device, torch.float32).clone(),
                        "exp_avg_sq": exp_avg_sq[name].to(p.device, torch.float32).clone()}


def checkpoint_path(path: str) -> str:
    """``path`` ending in ``.npz``: np.savez appends it silently, so save,
    load and the trainer's resume check all go through this."""
    return path if path.endswith(".npz") else path + ".npz"


def state_arrays(state: GANTrainState) -> Dict[str, np.ndarray]:
    """The train state as named numpy copies (the checkpoint's entries but
    ``__step__`` and ``extra_*``); Adam's state of a parameter not stepped
    yet is step 0 and zero moments."""
    arrs = {}
    for tag, adam, net, opt in _nets(state):
        for k, v in net.state_dict().items():
            arrs[f"{tag}.{k}"] = v.detach().cpu().numpy().copy()
        for k, p in net.named_parameters():
            st = opt.state.get(p) or {"step": 0.0, "exp_avg": torch.zeros_like(p),
                                      "exp_avg_sq": torch.zeros_like(p)}
            arrs[f"{adam}.{k}.step"] = np.asarray(float(st["step"]), np.float32)
            for m in _ADAM_KEYS[1:]:
                arrs[f"{adam}.{k}.{m}"] = st[m].detach().cpu().numpy().copy()
    return arrs


def save_train_state(path: str, state: GANTrainState, step: int = 0,
                     extra: Optional[Dict[str, float]] = None) -> None:
    """Write the whole train state to ``checkpoint_path(path)``. ``extra``:
    scalar side-state (the plateau scheduler's), returned by load."""
    arrs = state_arrays(state)
    arrs["__step__"] = np.asarray(step, np.int64)
    for k, v in (extra or {}).items():
        arrs[f"extra_{k}"] = np.asarray(float(v))
    np.savez(checkpoint_path(path), **arrs)


def load_train_state(path: str, like: GANTrainState
                     ) -> Tuple[GANTrainState, int, Dict[str, float]]:
    """Restore a checkpoint into ``like`` (a fresh state of the same dims),
    in place; returns (like, step, extra). A checkpoint whose names or
    shapes differ from ``like``'s raises ``ValueError`` before anything is
    written."""
    path = checkpoint_path(path)
    want = {k: v.shape for k, v in state_arrays(like).items()}
    with np.load(path) as z:
        step = int(z["__step__"])
        extra = {k[len("extra_"):]: float(z[k]) for k in z.files if k.startswith("extra_")}
        have = {k: z[k] for k in z.files if k != "__step__" and not k.startswith("extra_")}
    if set(have) != set(want):
        raise ValueError(f"checkpoint {path}: {len(set(have) - set(want))} entries the state "
                         f"lacks, {len(set(want) - set(have))} missing; dims mismatch")
    bad = [k for k in want if have[k].shape != want[k]]
    if bad:
        raise ValueError(f"checkpoint {path}: {bad[0]} has shape {have[bad[0]].shape}, the "
                         f"state {want[bad[0]]} ({len(bad)} entries differ)")
    for tag, adam, net, opt in _nets(like):
        net.load_state_dict({k: torch.from_numpy(have[f"{tag}.{k}"])
                             for k in net.state_dict()})
        names = [k for k, _ in net.named_parameters()]
        steps, *moments = [{k: torch.from_numpy(have[f"{adam}.{k}.{m}"]) for k in names}
                           for m in _ADAM_KEYS]
        set_adam_state(opt, net, steps, *moments)
    return like, step, extra

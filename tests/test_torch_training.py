"""The port's GAN training stack (dither_pie_tpu_torch.models.{p2cgen,
discriminator,losses,training} and the converters) against the JAX
package's, on the CPU.

JAX params come from the JAX package's own initialisers and reach the port
through ``convert.{p2cgen,cpdis}_state_from_jax`` / ``train_state_from_jax``;
inputs come from numpy seeds; sizes are dim 8 / conv-dim 8. Limits: the
forwards atol 1e-5; the spectral norm and the heads rtol 1e-5; the losses
rtol 1e-6; a full train step (lsgan, vanilla, wgangp; after 1 and 2 steps)
the metrics rtol 1e-4, u/v atol 1e-5, Adam's moments rtol 1e-4 / atol
1e-7 or 1e-5 (after step 2: 1e-4) of the tensor's largest moment,
whichever is more (G's moments reach 0.28 under lambda_l1 = 100, and the
two frameworks' float32 conv backwards differ there by up to 1.6e-6 of
that; a bias under instance norm, whose moments are rounding noise,
against its net's largest moment), every parameter within 2 lr steps + 1e-6 (Adam turns the rounding
noise of a zero gradient, such as a conv bias under instance norm, into a
full step of either sign) and every element whose gradient exceeds 1e-3
of its net's largest at each step within 1e-6; Adam alone 1e-6; the
schedules exactly; the port's own init by its distributions; checkpoints
and a resume bitwise.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dither_pie_tpu.models import discriminator as jd
from dither_pie_tpu.models import losses as jlosses
from dither_pie_tpu.models import training as jt
from dither_pie_tpu.models.p2cgen import p2cgen_forward as j_p2cgen_forward
from dither_pie_tpu_torch.models import convert as tconv
from dither_pie_tpu_torch.models import discriminator as td
from dither_pie_tpu_torch.models import losses as tlosses
from dither_pie_tpu_torch.models import training as tt
from dither_pie_tpu_torch.models.p2cgen import P2CGen, p2cgen_forward
import torch_workers  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
DIM = 8
LR = 2e-4
B1 = 0.5


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def images(seed, shape):
    return np.random.RandomState(seed).uniform(-1, 1, (*shape, 3)).astype(np.float32)


def port_p2cgen(g_params) -> P2CGen:
    gen = P2CGen(DIM)
    gen.load_state_dict(tconv.p2cgen_state_from_jax(np_tree(g_params)))
    return gen


def port_cpdis(d_params, cls=False) -> td.CPDis:
    dis = (td.CPDis_cls if cls else td.CPDis)(DIM)
    dis.load_state_dict(tconv.cpdis_state_from_jax(np_tree(d_params)))
    return dis


# ---------------------------------------------------------------------------
# 1-5: the forwards, the spectral norm, the heads, the losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 32, 32), (1, 40, 56)])
def test_p2cgen_forward(shape):
    g_params = jt.init_p2cgen_params(jax.random.PRNGKey(1), dim=DIM)
    x = images(11, shape)
    want = np.asarray(j_p2cgen_forward(g_params, jnp.asarray(x)))
    with torch.no_grad():
        got = nhwc(p2cgen_forward(port_p2cgen(g_params), nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_p2cgen_refuses_sizes_off_four():
    with pytest.raises(ValueError):
        p2cgen_forward(P2CGen(DIM), torch.zeros(1, 3, 32, 30))


def test_p2cgen_keys_are_the_jax_maps():
    g_params = jt.init_p2cgen_params(jax.random.PRNGKey(1), dim=DIM)
    assert set(P2CGen(DIM).state_dict()) == set(g_params)
    d_params = jt.init_cpdis_params(jax.random.PRNGKey(2), cls=True, conv_dim=DIM)
    assert set(td.CPDis_cls(DIM).state_dict()) == set(d_params)


def test_spectral_norm_weight():
    rng = np.random.RandomState(2)
    w = rng.uniform(-0.2, 0.2, (16, 8, 4, 4)).astype(np.float32)
    u = rng.normal(size=16).astype(np.float32)
    v = rng.normal(size=128).astype(np.float32)
    r = rng.normal(size=w.shape).astype(np.float32)
    jw, ju, jv = jd.spectral_norm_weight(jnp.asarray(w), jnp.asarray(u), jnp.asarray(v))
    wt = torch.from_numpy(w).requires_grad_(True)
    tw, tu, tv = td.spectral_norm_weight(wt, torch.from_numpy(u), torch.from_numpy(v))
    for got, want in ((tw, jw), (tu, ju), (tv, jv)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-7)
    assert not tu.requires_grad and not tv.requires_grad

    def obj(wb):
        return jnp.sum(jd.spectral_norm_weight(wb, jnp.asarray(u), jnp.asarray(v))[0]
                       * jnp.asarray(r))

    jgrad = np.asarray(jax.grad(obj)(jnp.asarray(w)))
    (tw * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(wt.grad.numpy(), jgrad, rtol=1e-5,
                               atol=1e-5 * np.abs(jgrad).max())


@pytest.mark.parametrize("shape,p", [((2, 3, 5, 7), 1), ((1, 2, 8, 8), 3), ((2, 4, 4, 9), 2)])
def test_reflect_pad_backward(shape, p):
    """``layers.pad2d``'s reflect pad: F.pad's forward bitwise, and its
    deterministic backward equal to F.pad's."""
    from dither_pie_tpu_torch.models.layers import pad2d

    rng = np.random.RandomState(12)
    x = torch.from_numpy(rng.normal(size=shape)).requires_grad_(True)
    g = torch.from_numpy(rng.normal(size=(*shape[:2], shape[2] + 2 * p, shape[3] + 2 * p)))
    want = torch.nn.functional.pad(x, (p,) * 4, mode="reflect")
    got = pad2d(x, p, "reflect")
    assert torch.equal(got, want)
    np.testing.assert_allclose(torch.autograd.grad(got, x, g)[0].numpy(),
                               torch.autograd.grad(want, x, g)[0].numpy(), rtol=0, atol=1e-12)


def test_l2n_is_not_f_normalize():
    tiny = torch.full((4,), 1e-14)
    assert torch.allclose(td._l2n(tiny), tiny / (tiny.norm() + 1e-12))
    assert not torch.allclose(td._l2n(tiny), torch.nn.functional.normalize(tiny, dim=0))


@pytest.mark.parametrize("hw", [(32, 32), (48, 40)])
def test_cpdis_forward(hw):
    d_params = jt.init_cpdis_params(jax.random.PRNGKey(3), conv_dim=DIM)
    x = images(4, (2, *hw))
    want, juv = jd.cpdis_forward(d_params, jnp.asarray(x))
    dis = port_cpdis(d_params)
    before = {k: v.clone() for k, v in dis.state_dict().items()}
    with torch.no_grad():
        got, tuv = td.cpdis_forward(dis, nchw(x))
        # A second forward from the walked state (the JAX caller merges it).
        got2, tuv2 = td.cpdis_forward(dis, nchw(x), tuv)
    want2, juv2 = jd.cpdis_forward({**d_params, **juv}, jnp.asarray(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(nhwc(got2), np.asarray(want2), rtol=0, atol=1e-5)
    for key in td.SN_KEYS:
        for i, name in enumerate(("weight_u", "weight_v")):
            np.testing.assert_allclose(tuv[key][i].numpy(), np.asarray(juv[f"{key}.{name}"]),
                                       rtol=0, atol=1e-5)
            np.testing.assert_allclose(tuv2[key][i].numpy(),
                                       np.asarray(juv2[f"{key}.{name}"]), rtol=0, atol=1e-5)
    # The forward does not write the buffers; store_uv does.
    assert all(torch.equal(v, before[k]) for k, v in dis.state_dict().items())
    dis.store_uv(tuv)
    assert torch.equal(dis.conv1.weight_u, tuv["conv1"][0])


def test_cpdis_patch_map_shape():
    dis = tt.init_cpdis(DIM, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out, _ = dis(torch.zeros(1, 3, 256, 256))
    assert out.shape == (1, 1, 30, 30)


@pytest.mark.parametrize("hw", [(32, 32), (48, 40)])
def test_cpdis_cls_forward(hw):
    d_params = jt.init_cpdis_params(jax.random.PRNGKey(5), cls=True, conv_dim=DIM)
    x = images(6, (3, *hw))
    label = np.array([0, 3, 6])
    want, want_cls, juv = jd.cpdis_cls_forward(d_params, jnp.asarray(x), jnp.asarray(label))
    with torch.no_grad():
        got, got_cls, tuv = td.cpdis_cls_forward(port_cpdis(d_params, cls=True), nchw(x),
                                                 torch.from_numpy(label))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_cls.numpy(), np.asarray(want_cls), rtol=0, atol=1e-5)
    for key in td.SN_KEYS:
        np.testing.assert_allclose(tuv[key][0].numpy(), np.asarray(juv[f"{key}.weight_u"]),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(tuv[key][1].numpy(), np.asarray(juv[f"{key}.weight_v"]),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("easy", [False, True])
def test_margin_heads(easy):
    rng = np.random.RandomState(7)
    x = rng.normal(size=(5, 16)).astype(np.float32)
    w = rng.normal(size=(7, 16)).astype(np.float32)
    label = np.array([0, 1, 6, 3, 3])
    jx, jw, jl = jnp.asarray(x), jnp.asarray(w), jnp.asarray(label)
    tx, tw, tl = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(label)
    pairs = [
        (td.cosine_sim(tx, tw), jd.cosine_sim(jx, jw)),
        (td.margin_cosine_product(tx, tw, tl), jd.margin_cosine_product(jx, jw, jl)),
        (td.arc_margin_product(tx, tw, tl, easy_margin=easy),
         jd.arc_margin_product(jx, jw, jl, easy_margin=easy)),
        (td.multi_margin_product(tx, tw, tl, easy_margin=easy),
         jd.multi_margin_product(jx, jw, jl, easy_margin=easy)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", tlosses.GAN_MODES)
@pytest.mark.parametrize("real", [True, False])
def test_gan_loss(mode, real):
    pred = np.random.RandomState(8).normal(size=(2, 1, 5, 5)).astype(np.float32)
    want = jlosses.gan_loss(jnp.asarray(pred), real, mode)
    want_grad = jax.grad(lambda p: jlosses.gan_loss(p, real, mode))(jnp.asarray(pred))
    t = torch.from_numpy(pred).requires_grad_(True)
    got = tlosses.gan_loss(t, real, mode)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_grad), rtol=1e-6, atol=1e-9)


def test_gan_loss_refuses_unknown_mode():
    with pytest.raises(NotImplementedError):
        tlosses.gan_loss(torch.zeros(1), True, "hinge")


# ---------------------------------------------------------------------------
# 6: the full train step against make_gan_train_step
# ---------------------------------------------------------------------------

STEP_SHAPE = (2, 32, 32)
N_STEPS = 2
# Adam's moments after step t, against the tensor's largest moment: after
# step 1 the two frameworks' float32 rounding; step 2's gradients also see
# the parameters that step 1 moved by +-lr on gradients of rounding size,
# whose sign the two frameworks need not share.
MOMENT_ATOL = {1: 1e-5, 2: 1e-4}


def _walk(w_bar, u):
    """One power iteration in float64 numpy: (u', v')."""
    w2d = w_bar.reshape(w_bar.shape[0], -1).astype(np.float64)
    v = w2d.T @ u
    v = v / (np.linalg.norm(v) + 1e-12)
    u = w2d @ v
    return u / (np.linalg.norm(u) + 1e-12), v


@pytest.fixture(scope="module")
def jax_runs():
    """Per mode: the JAX initial state and its states and metrics after
    each of N_STEPS steps, from gan_init(PRNGKey(0), dim=8, conv_dim=8)."""
    src, real = images(20, STEP_SHAPE), images(21, STEP_SHAPE)
    runs = {}
    for mode in tlosses.GAN_MODES:
        state, g_tx, d_tx = jt.gan_init(jax.random.PRNGKey(0), lr=LR, dim=DIM, conv_dim=DIM)
        step = jt.make_gan_train_step(g_tx, d_tx, gan_mode=mode, lambda_l1=100.0)
        seq = [(np_tree(state), None)]
        for _ in range(N_STEPS):
            state, metrics = step(state, jnp.asarray(src), jnp.asarray(real))
            seq.append((np_tree(state), {k: float(v) for k, v in metrics.items()}))
        runs[mode] = seq
    return src, real, runs


def zero_grad_bias(key: str) -> bool:
    """The bias of a P2CGen conv under instance norm: its true gradient is
    0, its computed one rounding noise."""
    return key.endswith(".conv.bias") and not key.startswith("RGBDec.conv_")


def _port_from_jax(jstate):
    return tconv.train_state_from_jax(jstate.g_params, jstate.d_params, jstate.g_opt[0],
                                      jstate.d_opt[0], lr=LR, device="cpu")


def _jax_grads(seq, t, opt_field, conv):
    """The gradient of step t (1-based), from Adam's first moments:
    g_t = (mu_t - b1 mu_{t-1}) / (1 - b1), in the port's layout."""
    mu = lambda s: getattr(s[0], opt_field)[0].mu  # noqa: E731
    return {k: (conv({k: v})[k].numpy() - B1 * conv({k: mu(seq[t - 1])[k]})[k].numpy())
            / (1 - B1) for k, v in mu(seq[t]).items()}


@pytest.fixture(scope="module")
def port_runs(jax_runs):
    src, real, runs = jax_runs
    out = {}
    for mode, seq in runs.items():
        state = _port_from_jax(seq[0][0])
        step = tt.make_gan_train_step(mode, 100.0)
        got = []
        for _ in range(N_STEPS):
            m = step(state, nchw(src), nchw(real))
            got.append(({k: v.item() for k, v in m.items()}, tt.state_arrays(state)))
        out[mode] = got
    return out


@pytest.mark.parametrize("mode", tlosses.GAN_MODES)
@pytest.mark.parametrize("t", range(1, N_STEPS + 1))
def test_train_step_matches_jax(jax_runs, port_runs, mode, t):
    _, _, runs = jax_runs
    assert_matches_jax(runs[mode], t, *port_runs[mode][t - 1])


def assert_matches_jax(seq, t, metrics, arrs):
    """The port's metrics and state arrays after step t against the JAX
    run ``seq`` ([(state, metrics)] from the initial state on), at the
    limits of the module docstring."""
    jstate, jmetrics = seq[t]
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k], v, rtol=1e-4, err_msg=k)

    for tag, adam, params, opt_field, conv in (
            ("G", "g_adam", jstate.g_params, "g_opt", tconv.p2cgen_state_from_jax),
            ("D", "d_adam", jstate.d_params, "d_opt", tconv.cpdis_state_from_jax)):
        want = conv(params)
        grads = [_jax_grads(seq, s, opt_field, conv) for s in range(1, t + 1)]
        gmax = [max(np.abs(g).max() for g in gs.values()) for gs in grads]
        adam_state = getattr(jstate, opt_field)[0]
        mus, nus = conv(adam_state.mu), conv(adam_state.nu)
        for k, w in want.items():
            got, w = arrs[f"{tag}.{k}"], w.numpy()
            if k.endswith((".weight_u", ".weight_v")):
                np.testing.assert_allclose(got, w, rtol=0, atol=1e-5, err_msg=k)
                continue
            np.testing.assert_allclose(got, w, rtol=0, atol=2 * LR * t + 1e-6, err_msg=k)
            big = np.all([np.abs(gs[k]) > 1e-3 * m for gs, m in zip(grads, gmax)], axis=0)
            np.testing.assert_allclose(got[big], w[big], rtol=0, atol=1e-6, err_msg=k)
            assert float(arrs[f"{adam}.{k}.step"]) == t == int(adam_state.count)
            for m, ref in (("exp_avg", mus), ("exp_avg_sq", nus)):
                scale = (max(np.abs(r.numpy()).max() for r in ref.values())
                         if zero_grad_bias(k) else np.abs(ref[k].numpy()).max())
                np.testing.assert_allclose(arrs[f"{adam}.{k}.{m}"], ref[k].numpy(), rtol=1e-4,
                                           atol=max(1e-7, MOMENT_ATOL[t] * scale),
                                           err_msg=f"{k} {m}")


def test_train_step_walks_uv_twice(jax_runs, port_runs):
    """u/v after one step are the initial state walked twice (the D step's
    real and fake forwards), not three times (G's forward discards its
    walk)."""
    _, _, runs = jax_runs
    d0 = runs["lsgan"][0][0].d_params
    arrs = port_runs["lsgan"][0][1]
    for key in td.SN_KEYS:
        w, u = d0[f"{key}.weight_bar"], d0[f"{key}.weight_u"]
        u1, _ = _walk(w, u)
        u2, v2 = _walk(w, u1)
        u3, _ = _walk(w, u2)
        np.testing.assert_allclose(arrs[f"D.{key}.weight_u"], u2, rtol=0, atol=1e-5)
        np.testing.assert_allclose(arrs[f"D.{key}.weight_v"], v2, rtol=0, atol=1e-5)
        if key != "conv1":  # one output channel: u is +-1 after any walk
            assert np.abs(u3 - u2).max() > 1e-3


def test_g_step_leaves_d_grads_alone():
    """D's .grad after a step is the D loss's alone: G's backward through
    the updated D adds nothing to it."""
    src, real = nchw(images(30, STEP_SHAPE)), nchw(images(31, STEP_SHAPE))
    state, ref = _fresh(5), _fresh(5)
    tt.make_gan_train_step()(state, src, real)
    assert all(p.requires_grad for p in state.D.parameters())
    with tt.step_scope(True):
        fake = p2cgen_forward(ref.G, src).detach()
        pred_real, uv = td.cpdis_forward(ref.D, real)
        pred_fake, _ = td.cpdis_forward(ref.D, fake, uv)
        (0.5 * (tlosses.gan_loss(pred_real, True) + tlosses.gan_loss(pred_fake, False))
         ).backward()
    for p, q in zip(state.D.parameters(), ref.D.parameters()):
        assert torch.equal(p.grad, q.grad)


def test_mesh_is_a11():
    """A data-parallel step (mesh=) is served: on two CPU positions it
    trains the state in place and returns finite metrics
    (tests/test_torch_mesh_train.py holds it to the one-device step and to
    JAX's mesh step)."""
    from dither_pie_tpu_torch.parallel.mesh import make_mesh

    state, before = _fresh(0), tt.state_arrays(_fresh(0))
    mesh = make_mesh(devices=[torch.device("cpu")] * 2)
    m = tt.make_gan_train_step(mesh=mesh)(state, nchw(images(60, (4, 32, 32))),
                                          nchw(images(61, (4, 32, 32))))
    assert all(np.isfinite(v.item()) for v in m.values())
    after = tt.state_arrays(state)
    assert not np.array_equal(before["G.RGBDec.conv_3.conv.weight"],
                              after["G.RGBDec.conv_3.conv.weight"])


def test_gan_init_needs_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the check is for machines without")
    with pytest.raises(RuntimeError):
        tt.gan_init(dim=DIM, conv_dim=DIM)


# ---------------------------------------------------------------------------
# 7: Adam alone
# ---------------------------------------------------------------------------

def test_adam_matches_optax():
    rng = np.random.RandomState(9)
    shapes = {"a": (4, 3, 5, 5), "b": (7,), "c": (16, 16)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(scale=10.0 ** -i, size=s).astype(np.float32)
              for k, s in shapes.items()} for i in range(3)]
    tx = optax.adam(LR, b1=0.5, b2=0.999)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    topt = torch.optim.Adam(tp.values(), lr=LR, betas=(0.5, 0.999))
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=0,
                                       atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# 8: schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy,kw", [
    ("linear", {"epoch_count": 1, "n_epochs": 100, "n_epochs_decay": 100}),
    ("step", {"lr_decay_iters": 50}),
    ("cosine", {"n_epochs": 200}),
])
def test_lr_schedule(policy, kw):
    got, want = tt.lr_schedule(policy, 2e-4, **kw), jt.lr_schedule(policy, 2e-4, **kw)
    assert [got(e) for e in range(201)] == [want(e) for e in range(201)]


def test_lr_schedule_refuses_unknown_policy():
    with pytest.raises(NotImplementedError):
        tt.lr_schedule("exp", 1.0)


def test_plateau():
    metrics = [1.0, 0.9, 0.895, 0.894, 0.893, 0.892, 0.891, 0.89, 0.5, 0.5, 0.5, 0.5, 0.5,
               0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.49, 0.2] + [0.2] * 30
    got, want = tt.ReduceLROnPlateau(2e-4), jt.ReduceLROnPlateau(2e-4)
    lrs = [(got.step(m), want.step(m)) for m in metrics]
    assert all(a == b for a, b in lrs)
    assert len({a for a, _ in lrs}) >= 3  # the sequence cuts the lr at least twice
    assert (got.best, got.num_bad_epochs) == (want.best, want.num_bad_epochs)


# ---------------------------------------------------------------------------
# 9: the port's own initialisation
# ---------------------------------------------------------------------------

def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_init_is_seeded():
    a, b, c = (tt.init_p2cgen(DIM, _gen(s)).state_dict() for s in (3, 3, 4))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    a, b = (tt.init_cpdis(DIM, True, _gen(5)).state_dict() for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_init_leaves_global_rng_alone():
    before = torch.random.get_rng_state()
    tt.init_p2cgen(DIM, _gen(0))
    tt.init_cpdis(DIM, True, _gen(0))
    assert torch.equal(torch.random.get_rng_state(), before)


def test_init_p2cgen_distributions():
    gen = tt.init_p2cgen(32, _gen(6))
    ws = torch.cat([p.flatten() for k, p in gen.named_parameters() if k.endswith(".weight")])
    assert abs(ws.std().item() - 0.02) < 0.0005 and abs(ws.mean().item()) < 0.0005
    for k, p in gen.named_parameters():
        if k.endswith(".bias") or k.endswith(".beta"):
            assert torch.all(p == 0), k
        if k.endswith(".gamma"):
            assert p.min() >= 0 and p.max() < 1 and abs(p.mean().item() - 0.5) < 0.1, k


def test_init_cpdis_distributions():
    dis = tt.init_cpdis(32, True, _gen(7))
    for key in td.SN_KEYS:
        conv = dis.sn_conv(key)
        bound = 1.0 / np.sqrt(conv.weight_bar[0].numel())
        w = conv.weight_bar
        assert w.abs().max() <= bound
        if w.numel() > 10000:
            assert abs(w.std().item() / (bound / np.sqrt(3)) - 1) < 0.03, key
        uv = torch.cat([conv.weight_u, conv.weight_v])
        if uv.numel() > 1000:
            assert abs(uv.std().item() - 1) < 0.06, key
        if conv.bias is not None:
            assert torch.all(conv.bias == 0)
    assert dis.conv1.bias is None
    cw = dis.classifier_conv.weight
    assert cw.shape == (256, 256, 1, 1) and abs(cw.std().item() - 0.02) < 0.001
    assert torch.all(dis.classifier_conv.bias == 0)
    limit = np.sqrt(6.0 / (256 + td.N_CLASSES))
    assert dis.classifier.weight.abs().max() <= limit
    assert dis.classifier.weight.abs().max() > 0.9 * limit


@pytest.mark.parametrize("policy", ["xavier", "kaiming"])
def test_init_weights_stds(policy):
    gen = tt.init_weights(P2CGen(32), policy, 0.02, _gen(8))
    for k, w in gen.named_parameters():
        if not k.endswith(".weight") or w.numel() < 20000:
            continue
        rf = w[0, 0].numel()
        fan_in, fan_out = w.shape[1] * rf, w.shape[0] * rf
        want = (0.02 * np.sqrt(2.0 / (fan_in + fan_out)) if policy == "xavier"
                else np.sqrt(2.0 / fan_in))
        assert abs(w.std().item() / want - 1) < 0.05, k


def test_init_weights_orthogonal():
    gen = tt.init_weights(P2CGen(DIM), "orthogonal", 0.5, _gen(9))
    for k, w in gen.named_parameters():
        if k.endswith(".bias"):
            assert torch.all(w == 0), k
        if not k.endswith(".weight"):
            continue
        flat = w.detach().reshape(w.shape[0], -1).double()
        gram = flat @ flat.T if flat.shape[0] <= flat.shape[1] else flat.T @ flat
        np.testing.assert_allclose(gram.numpy(), 0.25 * np.eye(len(gram)), atol=1e-5,
                                   err_msg=k)


def test_init_weights_skips_classifier_and_weight_bar():
    dis = tt.init_cpdis(DIM, True, _gen(10))
    before = {k: v.clone() for k, v in dis.state_dict().items()}
    tt.init_weights(dis, "normal", 0.02, _gen(11))
    after = dis.state_dict()
    changed = {k for k in before if not torch.equal(before[k], after[k])}
    assert changed == {"classifier_conv.weight"}
    with pytest.raises(NotImplementedError):
        tt.init_weights(dis, "uniform")


# ---------------------------------------------------------------------------
# 10: checkpoints
# ---------------------------------------------------------------------------

def _fresh(seed=0, dim=DIM):
    return tt.gan_init(lr=LR, dim=dim, conv_dim=DIM, seed=seed, device="cpu")


def _equal_states(a, b):
    x, y = tt.state_arrays(a), tt.state_arrays(b)
    return x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)


def test_checkpoint_round_trip(tmp_path):
    state = _fresh(0)
    tt.make_gan_train_step()(state, nchw(images(40, STEP_SHAPE)), nchw(images(41, STEP_SHAPE)))
    tt.save_train_state(str(tmp_path / "ck.npz"), state, step=7,
                        extra={"plateau_lr": 1e-4, "plateau_bad": 3})
    restored, step, extra = tt.load_train_state(str(tmp_path / "ck.npz"), _fresh(1))
    assert step == 7 and extra == {"plateau_lr": 1e-4, "plateau_bad": 3.0}
    assert _equal_states(restored, state)


def test_checkpoint_name_normalised(tmp_path):
    bare = str(tmp_path / "run1")
    tt.save_train_state(bare, _fresh(), step=2)
    assert Path(bare + ".npz").is_file() and not Path(bare).exists()
    assert tt.checkpoint_path(bare) == bare + ".npz"
    assert tt.load_train_state(bare, _fresh(1))[1] == 2


def test_checkpoint_mismatch_raises(tmp_path):
    path = str(tmp_path / "ck.npz")
    tt.save_train_state(path, _fresh(), step=1)
    like = _fresh(dim=4)
    before = tt.state_arrays(like)
    with pytest.raises(ValueError):
        tt.load_train_state(path, like)
    after = tt.state_arrays(like)
    assert all(np.array_equal(before[k], after[k]) for k in before)
    # Missing entries too.
    with np.load(path) as z:
        np.savez(path, **{k: z[k] for k in z.files if not k.startswith("d_adam.conv1")})
    with pytest.raises(ValueError):
        tt.load_train_state(path, _fresh())


def test_resume_is_bitwise(tmp_path):
    src, real = nchw(images(50, STEP_SHAPE)), nchw(images(51, STEP_SHAPE))
    step = tt.make_gan_train_step("vanilla", 100.0)
    straight = _fresh(3)
    step(straight, src, real)
    path = str(tmp_path / "ck")
    tt.save_train_state(path, straight, step=1)
    m_straight = step(straight, src, real)
    resumed, n, _ = tt.load_train_state(path, _fresh(4))
    assert n == 1
    m_resumed = step(resumed, src, real)
    assert all(torch.equal(m_straight[k], m_resumed[k]) for k in m_straight)
    assert _equal_states(resumed, straight)


def test_train_state_from_jax_drops_uv_moments():
    state, _, _ = jt.gan_init(jax.random.PRNGKey(0), lr=LR, dim=DIM, conv_dim=DIM)
    port = _port_from_jax(np_tree(state))
    arrs = tt.state_arrays(port)
    assert not any(k.startswith("d_adam.") and (".weight_u." in k or ".weight_v." in k)
                   for k in arrs)
    assert np.array_equal(arrs["D.main.0.weight_bar"], np.asarray(state.d_params[
        "main.0.weight_bar"]))
    np.testing.assert_array_equal(
        arrs["G.RGBDec.conv_3.conv.weight"],
        np.asarray(state.g_params["RGBDec.conv_3.conv.weight"]).transpose(3, 2, 0, 1))


# ---------------------------------------------------------------------------
# 12: the port's training modules import neither jax nor dither_pie_tpu
# ---------------------------------------------------------------------------

def test_training_imports_no_jax():
    code = ("import sys, dither_pie_tpu_torch.models.p2cgen, "
            "dither_pie_tpu_torch.models.discriminator, dither_pie_tpu_torch.models.losses, "
            "dither_pie_tpu_torch.models.training, dither_pie_tpu_torch.models.convert, "
            "dither_pie_tpu_torch.tools.train_gan; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m.startswith('dither_pie_tpu.') or m == 'dither_pie_tpu']; "
            "assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr

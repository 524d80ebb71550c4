"""The port's data-parallel GAN step (models/training.py, ``mesh=``) and
``shard_batch`` on the CPU, on meshes of repeated CPU positions
(``[cpu] * n``), against the port's one-device step and JAX's mesh step.

Limits:
* two positions, each shard the same batch: the mean of two equal
  gradients is that gradient, so two mesh steps equal two one-device steps
  on one shard bitwise; a replica that misses a refresh of G or D breaks
  this;
* eight positions against one device on the whole batch (dim 8, 8 x
  32x32): metrics rtol 2e-4 (the JAX package's own bound for its mesh
  step, tests/test_training.py), and the rule of chip_smoke.py phase 19
  (a) for the state: parameters within 2 lr t + 1e-6 and 1e-6 where the
  gradient exceeded 1e-3 of its net's largest at every step, u/v within
  1e-5, Adam's moments rtol 1e-4 plus max(1e-7, 1e-5 or 1e-4 after step 2
  of the tensor's largest moment);
* against JAX's ``make_gan_train_step(mesh=)`` on its eight-device mesh
  from the same weights (``models/convert.py``): tests/test_torch_training.py's
  train-parity limits, after each of two steps;
* a resume on the mesh: bitwise.
"""

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JMesh

from dither_pie_tpu.models import training as jt
from dither_pie_tpu_torch.models import training as tt
from dither_pie_tpu_torch.parallel.mesh import Sharded, make_mesh
from test_torch_training import (
    LR,
    MOMENT_ATOL,
    _port_from_jax,
    assert_matches_jax,
    images,
    nchw,
    np_tree,
    zero_grad_bias,
)
import torch_workers  # noqa: F401

CPU = torch.device("cpu")
DIM = 8
BATCH = (8, 32, 32)
N_STEPS = 2


def fresh(seed=0):
    return tt.gan_init(lr=LR, dim=DIM, conv_dim=DIM, seed=seed, device="cpu")


def cpu_mesh(n):
    return make_mesh((n,), ("data",), [CPU] * n)


def equal_states(a, b):
    x, y = tt.state_arrays(a), tt.state_arrays(b)
    return x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)


def test_two_equal_shards_are_one_device_bitwise():
    src, real = nchw(images(70, (2, 32, 32))), nchw(images(71, (2, 32, 32)))
    one, two = fresh(1), fresh(1)
    step_one = tt.make_gan_train_step("vanilla")
    step_two = tt.make_gan_train_step("vanilla", mesh=cpu_mesh(2))
    for _ in range(N_STEPS):
        m1 = step_one(one, src, real)
        m2 = step_two(two, torch.cat([src, src]), torch.cat([real, real]))
        assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert equal_states(one, two)
    assert all(p.requires_grad for p in two.D.parameters())


def state_errors(ref, got, grads, t):
    """{name: (max error, limit)} of ``got``'s state against ``ref``'s after
    step t; ``grads``: ``ref``'s gradients of steps 1..t by state key."""
    x, y = tt.state_arrays(ref), tt.state_arrays(got)
    errs = {"params": (0.0, 2 * LR * t + 1e-6), "params, large gradient": (0.0, 1e-6),
            "u/v": (0.0, 1e-5), "moments (excess over rtol 1e-4 + atol)": (0.0, 0.0)}

    def worst(name, err):
        errs[name] = (max(errs[name][0], float(err)), errs[name][1])

    net_max = {}
    for k, v in x.items():
        if k.endswith(("exp_avg", "exp_avg_sq")):
            net = (k.split(".", 1)[0], k.rsplit(".", 1)[1])
            net_max[net] = max(net_max.get(net, 0.0), float(np.abs(v).max()))
    gmax = [{n: max(float(np.abs(g).max()) for k, g in gs.items() if k[0] == n) for n in "GD"}
            for gs in grads]
    for k, v in x.items():
        d = np.abs(v - y[k])
        if k.endswith((".weight_u", ".weight_v")):
            worst("u/v", d.max())
        elif k[:2] in ("G.", "D."):
            worst("params", d.max())
            big = np.all([np.abs(gs[k]) > 1e-3 * m[k[0]] for gs, m in zip(grads, gmax)], axis=0)
            worst("params, large gradient", d[big].max() if big.any() else 0.0)
        elif k.endswith(("exp_avg", "exp_avg_sq")):
            name = k.split(".", 1)[1].rsplit(".", 1)[0]
            noise = k.startswith("g_adam.") and zero_grad_bias(name)
            scale = (net_max[(k.split(".", 1)[0], k.rsplit(".", 1)[1])] if noise
                     else np.abs(v).max())
            atol = max(1e-7, MOMENT_ATOL[t] * float(scale))
            worst("moments (excess over rtol 1e-4 + atol)", (d - 1e-4 * np.abs(v) - atol).max())
    return errs


def test_eight_shards_match_one_device():
    src, real = nchw(images(72, BATCH)), nchw(images(73, BATCH))
    one, mesh_state = fresh(2), fresh(2)
    step_one = tt.make_gan_train_step("lsgan")
    step_mesh = tt.make_gan_train_step("lsgan", mesh=cpu_mesh(8))
    grads = []
    for t in range(1, N_STEPS + 1):
        m1 = step_one(one, src, real)
        grads.append({f"{tag}.{k}": p.grad.numpy().copy()
                      for tag, net in (("G", one.G), ("D", one.D))
                      for k, p in net.named_parameters()})
        m8 = step_mesh(mesh_state, tt.shard_batch(cpu_mesh(8), src), real)
        for k in m1:
            np.testing.assert_allclose(m8[k].item(), m1[k].item(), rtol=2e-4, err_msg=k)
        for name, (err, limit) in state_errors(one, mesh_state, grads, t).items():
            assert err <= limit, (t, name, err, limit)


@pytest.fixture(scope="module")
def jax_mesh_run():
    """JAX's mesh step on its eight virtual devices: the initial state and
    the (state, metrics) after each of N_STEPS steps."""
    src, real = images(74, BATCH), images(75, BATCH)
    # gan_init's body with its two initialisers jitted (eagerly, their
    # first call compiles op by op for most of a minute).
    kg, kd = jax.random.split(jax.random.PRNGKey(0))
    g_params = jax.jit(lambda k: jt.init_p2cgen_params(k, dim=DIM))(kg)
    d_params = jax.jit(lambda k: jt.init_cpdis_params(k, conv_dim=DIM))(kd)
    g_tx, d_tx = (optax.adam(LR, b1=0.5, b2=0.999) for _ in range(2))
    state = jt.GANTrainState(g_params, d_params, g_tx.init(g_params), d_tx.init(d_params))
    mesh = JMesh(np.array(jax.devices()[:8]), ("data",))
    step = jt.make_gan_train_step(g_tx, d_tx, gan_mode="lsgan", lambda_l1=100.0, mesh=mesh)
    seq = [(np_tree(state), None)]
    for _ in range(N_STEPS):
        state, metrics = step(state, jt.shard_batch(mesh, src), jt.shard_batch(mesh, real))
        seq.append((np_tree(state), {k: float(v) for k, v in metrics.items()}))
    return src, real, seq


def test_mesh_step_matches_jax_mesh_step(jax_mesh_run):
    src, real, seq = jax_mesh_run
    state = _port_from_jax(seq[0][0])
    mesh = cpu_mesh(8)
    step = tt.make_gan_train_step("lsgan", 100.0, mesh=mesh)
    for t in range(1, N_STEPS + 1):
        m = step(state, tt.shard_batch(mesh, nchw(src)), tt.shard_batch(mesh, nchw(real)))
        assert_matches_jax(seq, t, {k: v.item() for k, v in m.items()}, tt.state_arrays(state))


def test_mesh_resume_is_bitwise(tmp_path):
    src, real = nchw(images(76, BATCH)), nchw(images(77, BATCH))
    mesh = cpu_mesh(4)
    step = tt.make_gan_train_step("lsgan", mesh=mesh)
    straight = fresh(5)
    step(straight, src, real)
    path = str(tmp_path / "ck")
    tt.save_train_state(path, straight, step=1)
    m_straight = step(straight, src, real)
    resumed, n, _ = tt.load_train_state(path, fresh(6))
    assert n == 1
    m_resumed = step(resumed, src, real)
    assert all(torch.equal(m_straight[k], m_resumed[k]) for k in m_straight)
    assert equal_states(resumed, straight)
    # The checkpoint format is the one-device step's: the state loads there.
    one = tt.load_train_state(path, fresh(7))[0]
    tt.make_gan_train_step("lsgan")(one, src, real)


def test_shard_batch_and_state_device():
    mesh = make_mesh((4, 2), devices=[CPU] * 8)
    batch = np.arange(8 * 3 * 2 * 2, dtype=np.float32).reshape(8, 3, 2, 2)
    placed = tt.shard_batch(mesh, batch)
    assert isinstance(placed, Sharded) and len(placed.shards) == 8
    np.testing.assert_array_equal(placed.shards[5].numpy(), batch[4:6])  # (2, 1)
    np.testing.assert_array_equal(placed.gather().numpy(), batch)
    with pytest.raises(ValueError, match="does not divide"):
        tt.shard_batch(mesh, batch[:6])
    step = tt.make_gan_train_step(mesh=make_mesh(devices=[torch.device("meta")] * 2))
    with pytest.raises(ValueError, match="first device"):
        step(fresh(), batch, batch)

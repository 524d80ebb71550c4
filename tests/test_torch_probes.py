"""The port's gather probe (T1) and layout probe (T3) against the JAX
package's tools, on the CPU.

On the CPU each wrapper runs its kernel's plain PyTorch version, so these
tests pin down the functions the CUDA kernels must compute; chip_smoke.py
holds the kernels to the same plain versions on the card, bitwise.

* T1: the three bodies of tools/gather_probe.py are closures of its
  ``main``; they are restated here word for word and run through
  ``pl.pallas_call(..., interpret=True)`` under ``jax.jit``. All arithmetic
  is int32, so every comparison is exact; the gather is also held to
  ``np.take_along_axis``, and the select sweep to the gather chain with the
  sweep's update on the same tile.
* T3: the plain identity against tools/xla_layout_repro.py's
  ``_pallas_identity`` (it interprets on the CPU), the planarising harness
  against the JAX tool's ``transpose(3, 0, 1, 2).reshape``, and the
  ``--chain`` harness against the same chain through the JAX package's
  interpreted ordered kernel (the running sum is a float32 of an exact
  integer sum: rtol 1e-6).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from dither_pie_tpu.core.thresholds import bayer_matrix
from dither_pie_tpu.ops.ordered import tile_screen_device
from dither_pie_tpu.ops.ordered_pallas import ordered_dither_fused as jfused
from dither_pie_tpu_torch.kernels import build
from dither_pie_tpu_torch.tools import gather_probe as gp
from dither_pie_tpu_torch.tools import layout_repro as lr
import torch_workers  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
LF = gp.LF


def _jax_tool(name):
    """A module of the repository's root tools/ directory, loaded by path."""
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _interpret(kernel, shape):
    return jax.jit(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(shape, jnp.int32), interpret=True))


# The bodies of tools/gather_probe.py (:38-39, :55-60, :96-106).


def _jax_gather(tbl, idx):
    def kernel(t, i, o):
        o[...] = jnp.take_along_axis(t[...], i[...], axis=0)

    return np.asarray(_interpret(kernel, idx.shape)(jnp.asarray(tbl), jnp.asarray(idx)))


def _jax_gather_chain(tbl, idx, k):
    rows = tbl.shape[0]

    def kernel(t, i, o):
        acc = i[...]
        for step in range(k):
            g = jnp.take_along_axis(t[...], acc, axis=0)
            acc = jnp.abs(g + step) % rows
        o[...] = acc

    return np.asarray(_interpret(kernel, idx.shape)(jnp.asarray(tbl), jnp.asarray(idx)))


def _jax_sweep_chain(tbl, idx, k):
    P, lf = tbl.shape
    rows = idx.shape[0]

    def kernel(t, i, o):
        acc = i[...]
        for step in range(k):
            best = jnp.zeros((rows, lf), jnp.int32)
            for p in range(P):
                best = jnp.where((acc & (P - 1)) == p,
                                 jnp.broadcast_to(t[p:p + 1], (rows, lf)), best)
            acc = jnp.abs(best + acc + step) % 255
        o[...] = acc

    return np.asarray(_interpret(kernel, idx.shape)(jnp.asarray(tbl), jnp.asarray(idx)))


# ---------------------------------------------------------------------------
# T1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", gp.CHECK_ROWS)
def test_gather_equals_jax_body_and_numpy(rows):
    tbl, idx = gp.gather_inputs(rows)
    ours = gp.gather_chain(*_t(tbl, idx)).numpy()
    assert ours.dtype == np.int32 and ours.shape == (rows, LF)
    np.testing.assert_array_equal(ours, np.take_along_axis(tbl, idx, axis=0))
    np.testing.assert_array_equal(ours, _jax_gather(tbl, idx))
    assert gp.check_gather(rows, "cpu")
    assert not build.LAUNCHES  # CPU tensors never launch a kernel


@pytest.mark.parametrize("rows,k", [(256, 4), (256, 9), (1024, 4), (4096, 3), (16384, 2)])
def test_gather_chain_equals_jax_body(rows, k):
    tbl, idx = gp.chain_inputs(rows)
    ours = gp.gather_chain(*_t(tbl, idx), k, "chain").numpy()
    assert ours.dtype == np.int32 and 0 <= ours.min() and ours.max() < rows
    np.testing.assert_array_equal(ours, _jax_gather_chain(tbl, idx, k))


@pytest.mark.parametrize("p,k", [(64, 2), (64, 5), (256, 2), (1024, 1)])
def test_sweep_chain_equals_jax_body_and_the_gather(p, k):
    tbl, idx = gp.sweep_inputs(p)
    assert idx.shape == (gp.SWEEP_TILE_ROWS, LF)
    ours = gp.sweep_chain(*_t(tbl, idx), k).numpy()
    np.testing.assert_array_equal(ours, _jax_sweep_chain(tbl, idx, k))
    # The sweep computes table[acc & (P-1), l] by P selects: the gather chain
    # with the sweep's update is the same function.
    np.testing.assert_array_equal(ours, gp.gather_chain(*_t(tbl, idx), k, "sweep").numpy())


@pytest.mark.parametrize("update", ["chain", "sweep"])
def test_chain_steps_compose(update):
    """k steps are k single steps with the step number carried: the
    kernels' loop, spelled out with numpy."""
    tbl, idx = gp.sweep_inputs(64) if update == "sweep" else gp.chain_inputs(64)
    acc = idx.copy()
    for step in range(6):
        if update == "chain":
            acc = np.abs(np.take_along_axis(tbl, acc, axis=0) + step) % 64
        else:
            acc = np.abs(np.take_along_axis(tbl, acc & 63, axis=0) + acc + step) % 255
    np.testing.assert_array_equal(gp.gather_chain(*_t(tbl, idx), 6, update).numpy(), acc)


def test_probe_tables_and_memory_rule():
    """The tool's inputs are the JAX tool's (same seeds), and the table
    lies in shared memory exactly where it fits 227 KB."""
    tbl, idx = gp.chain_inputs(256)
    np.testing.assert_array_equal(
        tbl, np.random.RandomState(1).randint(0, 256, (256, LF)).astype(np.int32))
    np.testing.assert_array_equal(
        idx, np.random.RandomState(2).randint(0, 256, (256, LF)).astype(np.int32))
    tbl, idx = gp.sweep_inputs(256)
    np.testing.assert_array_equal(
        tbl, np.random.RandomState(1).randint(0, 255, (256, LF)).astype(np.int32))
    np.testing.assert_array_equal(
        idx, np.random.RandomState(2).randint(0, 255, (8, LF)).astype(np.int32))
    smem = {rows: gp.table_in_smem(torch.empty((rows, LF), dtype=torch.int32))
            for rows in (64, 256, 454, 455, 512, 1024, 16384)}
    assert smem == {64: True, 256: True, 454: True, 455: False, 512: False,
                    1024: False, 16384: False}


def test_gather_probe_refuses_what_the_kernels_do_not_take():
    tbl, idx = _t(*gp.chain_inputs(64))
    with pytest.raises(ValueError, match="update"):
        gp.gather_chain(tbl, idx, 1, "other")
    with pytest.raises(ValueError, match="k must be 1"):
        gp.gather_chain(tbl, idx, 2, "none")
    with pytest.raises(ValueError, match="int32"):
        gp.gather_chain(tbl.long(), idx, 1)
    with pytest.raises(ValueError, match="lanes"):
        gp.gather_chain(tbl, idx[:, :64], 1)
    with pytest.raises(ValueError, match=">= 1"):
        gp.sweep_chain(tbl, idx, 0)
    with pytest.raises(ValueError, match="power of two"):
        gp.sweep_chain(tbl[:48], idx, 1)
    with pytest.raises(ValueError, match="power of two"):
        gp.gather_chain(tbl[:48], idx, 1, "sweep")
    with pytest.raises(ValueError, match="not supported"):
        gp.gather_chain(tbl.to("meta"), idx.to("meta"))


@pytest.mark.parametrize("tool", [gp, lr], ids=["gather_probe", "layout_repro"])
def test_probe_tools_refuse_to_time_without_a_gpu(tool, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the check is for machines without")
    assert tool.main() == 2
    assert "no CUDA device" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# T3
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 600, 40), (3, 512, 24), (3, 37, 53)])
def test_identity_equals_jax_pallas_identity(shape):
    x = np.random.RandomState(sum(shape)).randint(0, 256, shape).astype(np.uint8)
    ours = lr.identity_copy(torch.from_numpy(x))
    assert ours.dtype == torch.uint8 and ours.data_ptr() != torch.from_numpy(x).data_ptr()
    np.testing.assert_array_equal(ours.numpy(), x)
    np.testing.assert_array_equal(
        ours.numpy(), np.asarray(_jax_tool("xla_layout_repro")._pallas_identity(jnp.asarray(x))))
    assert not build.LAUNCHES


def test_identity_takes_any_size_and_refuses_other_types():
    for n in (0, 1, 15, 16, 17, 4099):
        x = torch.arange(n, dtype=torch.int64).to(torch.uint8)
        assert torch.equal(lr.identity_copy(x), x)
    sliced = torch.arange(100, dtype=torch.int64).to(torch.uint8)[1:]  # off the base
    assert torch.equal(lr.identity_copy(sliced), sliced)
    with pytest.raises(TypeError):
        lr.identity_copy(torch.zeros(4))
    with pytest.raises(ValueError, match="contiguous"):
        lr.identity_copy(torch.zeros((4, 4), dtype=torch.uint8).t())


@pytest.mark.parametrize("n_params,batch,h,w", [(3, 2, 12, 20), (1, 3, 7, 9)])
def test_harness_planes_equal_the_jax_tools(n_params, batch, h, w):
    r = lr.harness(n_params, batch, "cpu", h, w)
    assert r["arg_bytes"] == r["out_bytes"] == n_params * batch * h * w * 3
    assert r["temp_bytes"] == 0  # the CPU keeps no allocation count
    assert len(r["outs"]) == n_params
    for i, plane in enumerate(r["outs"]):
        frames = jnp.full((batch, h, w, 3), i, jnp.uint8)
        want = np.asarray(frames.transpose(3, 0, 1, 2).reshape(3, batch * h, w))
        np.testing.assert_array_equal(plane.numpy(), want)
    # planarize on real content, against the same transpose.
    x = np.random.RandomState(5).randint(0, 256, (batch, h, w, 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        lr.planarize(torch.from_numpy(x)).numpy(),
        x.transpose(3, 0, 1, 2).reshape(3, batch * h, w))


def test_chain_equals_the_jax_chain():
    """tools/xla_layout_repro.py::_chain_main's program at a small size:
    filled batches through the interpreted ordered kernel, the running sum
    in pal[0, 0]."""
    n_params, batch, h, w = 3, 2, 16, 24
    ours = lr.chain(n_params, batch, "cpu", h, w)
    pal = jnp.asarray(np.random.RandomState(0).randint(0, 256, (16, 3)).astype(np.float32))
    screen = tile_screen_device(jnp.asarray(bayer_matrix("8x8")), h, w)
    acc = jnp.float32(0)
    for i in range(n_params):
        out = jfused(jnp.full((batch, h, w, 3), i, jnp.uint8), pal.at[0, 0].set(acc), screen,
                     interpret=True, bucket=False)
        acc = jnp.sum(out.astype(jnp.int32)).astype(jnp.float32) * jnp.float32(1e-12)
    assert ours["arg_bytes"] == n_params * batch * h * w * 3
    assert ours["acc"] > 0
    np.testing.assert_allclose(ours["acc"], float(acc), rtol=1e-6)

"""The port's index-stream bit-packing (dither_pie_tpu_torch.ops.idxpack)
against the JAX package's (dither_pie_tpu.ops.idxpack), on the CPU.

Everything here is exact: the packed bytes equal the JAX package's bit for
bit, the host unpack restores the indices, and the transfer helper returns
the same indices with the pack on, off, or not applicable.
"""

import numpy as np
import pytest
import torch

from dither_pie_tpu.ops import idxpack as jpack
from dither_pie_tpu_torch.ops import idxpack as tpack
import torch_workers  # noqa: F401

BPP_P = [(1, 2), (2, 4), (4, 16)]
WIDTHS = [1, 7, 8, 13, 128]


@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 16, 17, 256, 1024])
def test_pack_bits_for_equals_jax(p):
    assert tpack.pack_bits_for(p) == jpack.pack_bits_for(p)


@pytest.mark.parametrize("bpp,p", BPP_P)
@pytest.mark.parametrize("w", WIDTHS)
def test_pack_equals_jax_and_round_trips(bpp, p, w):
    rng = np.random.RandomState(bpp * 100 + w)
    idx = rng.randint(0, p, (3, 5, w)).astype(np.uint8)
    packed = tpack.pack_indices_device(torch.from_numpy(idx), bpp)
    assert packed.dtype == torch.uint8 and packed.device.type == "cpu"
    per = 8 // bpp
    assert tuple(packed.shape) == (3, 5, -(-w // per))
    ref = np.asarray(jpack.pack_indices_device(idx, bpp))
    np.testing.assert_array_equal(packed.numpy(), ref)
    out = tpack.unpack_indices_host(packed.numpy(), bpp, w)
    assert out.dtype == np.uint8 and out.flags.c_contiguous
    np.testing.assert_array_equal(out, idx)
    np.testing.assert_array_equal(out, jpack.unpack_indices_host(ref, bpp, w))


def test_first_pixel_in_high_bits():
    idx = torch.tensor([[[1, 0, 1, 1, 0, 0, 1, 0]]], dtype=torch.uint8)
    packed = tpack.pack_indices_device(idx, 1)
    assert tuple(packed.shape) == (1, 1, 1) and int(packed[0, 0, 0]) == 0b10110010
    two = tpack.pack_indices_device(torch.tensor([[[3, 0, 1]]], dtype=torch.uint8), 2)
    assert two.tolist() == [[[0b11000100]]]  # the row padded with a zero
    four = tpack.pack_indices_device(torch.tensor([[[9, 4, 15]]], dtype=torch.uint8), 4)
    assert four.tolist() == [[[0x94, 0xF0]]]


@pytest.mark.parametrize("knob", [None, "1", "0"])
@pytest.mark.parametrize("p", [2, 4, 16, 17, 256])
def test_packed_transfer_returns_the_indices(p, knob, monkeypatch):
    """The pack on (the default), forced on, off (DITHER_PIE_TPU_INDEX_PACK=0)
    and not applicable (P > 16): the same host indices every time."""
    if knob is None:
        monkeypatch.delenv("DITHER_PIE_TPU_INDEX_PACK", raising=False)
    else:
        monkeypatch.setenv("DITHER_PIE_TPU_INDEX_PACK", knob)
    assert tpack.pack_enabled() == (knob != "0") == jpack.pack_enabled()
    idx = np.random.RandomState(p).randint(0, p, (2, 4, 9)).astype(np.uint8)
    out = tpack.packed_transfer(torch.from_numpy(idx), p, 9)
    assert isinstance(out, np.ndarray) and out.dtype == np.uint8
    np.testing.assert_array_equal(out, idx)
    np.testing.assert_array_equal(out, jpack.packed_transfer(idx, p, 9))


def test_packed_transfer_packs_only_when_enabled(monkeypatch):
    """The knob really switches the packed copy: count the pack calls."""
    calls = []
    real = tpack.pack_indices_device
    monkeypatch.setattr(tpack, "pack_indices_device",
                        lambda idx, bpp: calls.append(bpp) or real(idx, bpp))
    idx = torch.from_numpy(np.random.RandomState(1).randint(0, 16, (1, 3, 10)).astype(np.uint8))
    monkeypatch.setenv("DITHER_PIE_TPU_INDEX_PACK", "0")
    tpack.packed_transfer(idx, 16, 10)
    assert calls == []
    monkeypatch.setenv("DITHER_PIE_TPU_INDEX_PACK", "1")
    tpack.packed_transfer(idx, 16, 10)
    tpack.packed_transfer(idx % 4, 4, 10)
    tpack.packed_transfer(idx, 17, 10)
    assert calls == [4, 2]


def test_uint16_stream_is_copied_unpacked():
    idx = torch.from_numpy(np.arange(24, dtype=np.uint16).reshape(1, 3, 8) * 40)
    out = tpack.packed_transfer(idx, 1024, 8)
    assert out.dtype == np.uint16
    np.testing.assert_array_equal(out, idx.numpy())

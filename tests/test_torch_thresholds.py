"""The port's threshold screens and palette data
(dither_pie_tpu_torch.core.thresholds, core.builtin_palettes) against the
JAX package's, on the CPU.

Every comparison is bitwise: the screens are data or float32 arithmetic
done op for op as the JAX package does it, and the ordered contract is
bit-exact.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dither_pie_tpu.core import builtin_palettes as jbp
from dither_pie_tpu.core import thresholds as jthr
from dither_pie_tpu.ops import ordered as jord
from dither_pie_tpu_torch.core import builtin_palettes as tbp
from dither_pie_tpu_torch.core import thresholds as tthr
from dither_pie_tpu_torch.ops import ordered as tord
import torch_workers  # noqa: F401


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("name", ["BAYER2x2", "BAYER4x4", "BAYER8x8",
                                  "BAYER16x16", "PSX4x4"])
def test_matrices_equal_jax(name):
    ours, ref = getattr(tthr, name), getattr(jthr, name)
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(_bits(ours), _bits(ref))


@pytest.mark.parametrize("size", ["2x2", "4x4", "8x8", "16x16", "psx4x4",
                                  "psx", "unknown"])
def test_bayer_matrix_lookup_equals_jax(size):
    np.testing.assert_array_equal(_bits(tthr.bayer_matrix(size)),
                                  _bits(jthr.bayer_matrix(size)))


@pytest.mark.parametrize("tile,gamma", [(10, 2.0), (8, 1.5), (5, 0.5)])
def test_polka_dot_matrix_equals_jax(tile, gamma):
    ours = tthr.polka_dot_matrix(tile, gamma)
    assert ours.dtype == np.float32 and ours.shape == (tile, tile)
    np.testing.assert_array_equal(_bits(ours), _bits(jthr.polka_dot_matrix(tile, gamma)))


@pytest.mark.parametrize("size,seed", [(16, 3), (64, 42)])
def test_blue_noise_equals_jax(size, seed):
    ours = tthr.generate_blue_noise(size, seed)
    np.testing.assert_array_equal(_bits(ours), _bits(jthr.generate_blue_noise(size, seed)))
    assert tthr.blue_noise_cached(size, seed) is tthr.blue_noise_cached(size, seed)


@pytest.mark.parametrize("h,w,scale,seed", [(33, 47, 1.7, 5), (1080, 1920, 1.0, 42),
                                            (8, 9, 2.5, 7)])
def test_ign_torch_equals_numpy_and_jax(h, w, scale, seed):
    ours = tthr.ign_thresholds(h, w, scale, seed, device="cpu")
    assert ours.dtype == torch.float32 and tuple(ours.shape) == (h, w)
    ours = ours.numpy()
    np.testing.assert_array_equal(_bits(ours), _bits(tthr.ign_thresholds_np(h, w, scale, seed)))
    np.testing.assert_array_equal(_bits(ours), _bits(jthr.ign_thresholds_np(h, w, scale, seed)))
    np.testing.assert_array_equal(_bits(ours), _bits(jthr.ign_thresholds(h, w, scale, seed)))


def test_ign_defaults_to_the_card():
    """Like every entry point of the port, the IGN map lands on the card
    unless the caller asks for the CPU (the signature is read, not called:
    a CPU-only machine has no card)."""
    assert inspect.signature(tthr.ign_thresholds).parameters["device"].default == "cuda"


@pytest.mark.parametrize("h,w", [(17, 30), (8, 8), (3, 70)])
def test_tiled_screens_equal_jax(h, w):
    m = jthr.bayer_matrix("8x8")
    host = tthr.tile_threshold_map(m, h, w)
    np.testing.assert_array_equal(host, jthr.tile_threshold_map(m, h, w))
    dev = tord.screen_for_matrix(m, h, w, "cpu")
    assert dev.dtype == torch.float32
    np.testing.assert_array_equal(dev.numpy(), np.asarray(jord.screen_for_matrix(m, h, w)))
    np.testing.assert_array_equal(
        tord.tile_screen_device(torch.from_numpy(m), h, w).numpy(),
        np.asarray(jord.tile_screen_device(jnp.asarray(m), h, w)))
    np.testing.assert_array_equal(dev.numpy(), host)


def test_builtin_palettes_equal_jax():
    assert tbp.BUILTIN_PALETTES == jbp.BUILTIN_PALETTES
    assert len(tbp.BUILTIN_PALETTES) == 25
    assert tbp._RAW_QUIRKS == jbp._RAW_QUIRKS
    assert tbp.builtin_palette_list() == jbp.builtin_palette_list()

"""The port's palettes (dither_pie_tpu_torch.core.palette) against the JAX
package's, on the CPU.

* median-cut, uniform cube and as_palette_array: equal (host Python,
  carried over unchanged);
* k-means: the jax.random stream cannot be reproduced, so the centres
  differ. The port is held to determinism per seed, and on the benchmark's
  synthetic 1080p frame its final inertia (sum of squared distances of the
  seeded 10k-pixel subsample to the nearest palette colour) is within 5%
  of the JAX palette's, in both directions.
"""

import numpy as np
import pytest

import bench
from dither_pie_tpu.core import palette as jpal
from dither_pie_tpu_torch.core import palette as tpal

INERTIA_RATIO_MAX = 1.05


@pytest.mark.parametrize("num_colors", [1, 2, 5, 16, 32])
def test_median_cut_equals_jax(num_colors, rand_image, gradient_image):
    synth = bench.synth_image(45, 80, 3)
    for img in (rand_image, gradient_image, synth):
        assert (tpal.median_cut_palette(img, num_colors)
                == jpal.median_cut_palette(img, num_colors))


@pytest.mark.parametrize("num_colors", [1, 8, 27, 30, 64])
def test_uniform_and_as_palette_array_equal_jax(num_colors):
    pal = tpal.uniform_palette(num_colors)
    assert pal == jpal.uniform_palette(num_colors)
    a, b = tpal.as_palette_array(pal), jpal.as_palette_array(pal)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def test_as_palette_array_rejects_bad_shapes():
    with pytest.raises(ValueError):
        tpal.as_palette_array([(1, 2)])


def test_kmeans_deterministic_per_seed():
    img = bench.synth_image(60, 80, 1)
    a = tpal.kmeans_palette(img, 16, random_state=7, device="cpu")
    b = tpal.kmeans_palette(img, 16, random_state=7, device="cpu")
    c = tpal.kmeans_palette(img, 16, random_state=8, device="cpu")
    assert a == b
    assert a != c
    assert len(a) == 16 and all(0 <= v <= 255 for col in a for v in col)


def test_kmeans_pads_degenerate_inputs():
    img = np.zeros((2, 2, 3), np.uint8)
    img[0, 0] = (255, 0, 0)
    pal = tpal.kmeans_palette(img, 8, device="cpu")
    assert len(pal) == 8 and (255, 0, 0) in pal and (0, 0, 0) in pal


def _inertia(pts, pal):
    d = ((pts[:, None, :] - np.asarray(pal, np.float64)[None]) ** 2).sum(-1)
    return float(d.min(1).sum())


def test_kmeans_inertia_close_to_jax():
    img = bench.synth_image(1080, 1920, 2)  # the benchmark's palette frame
    port = tpal.kmeans_palette(img, 32, device="cpu")
    ref = jpal.kmeans_palette(img, 32)
    pix = img.reshape(-1, 3)
    sub = pix[np.random.RandomState(42).choice(len(pix), 10_000, replace=False)]
    pts = sub.astype(np.float64)
    i_port, i_ref = _inertia(pts, port), _inertia(pts, ref)
    assert i_port <= INERTIA_RATIO_MAX * i_ref, (i_port, i_ref)
    assert i_ref <= INERTIA_RATIO_MAX * i_port, (i_port, i_ref)

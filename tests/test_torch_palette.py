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

import sys

import numpy as np
import pytest

import bench
from dither_pie_tpu.core import palette as jpal
from dither_pie_tpu_torch.core import palette as tpal
import torch_workers  # noqa: F401

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


# ---------------------------------------------------------------------------
# DITHER_PIE_TPU_KMEANS=sklearn: the reference's exact fit, as the JAX
# package routes it. At <= sample_cap pixels no sampling happens, so the two
# packages' palettes are equal.
# ---------------------------------------------------------------------------

SKLEARN_SWITCHES = ["sklearn", "reference", "SKLEARN", "Reference"]


def _degenerate_image():
    img = np.zeros((3, 4, 3), np.uint8)
    img[0, 0] = (255, 0, 0)
    img[1, 2] = (0, 9, 200)
    return img


@pytest.mark.parametrize("switch", SKLEARN_SWITCHES)
@pytest.mark.parametrize("num_colors", [2, 16, 32])
def test_kmeans_sklearn_switch_equals_jax(monkeypatch, switch, num_colors):
    pytest.importorskip("sklearn")
    monkeypatch.setenv(tpal.KMEANS_ENV, switch)
    img = bench.synth_image(80, 125, 3)  # 10,000 pixels: no subsample
    port = tpal.kmeans_palette(img, num_colors, random_state=5, device="cpu")
    assert port == jpal.kmeans_palette(img, num_colors, random_state=5)
    assert len(port) == num_colors


@pytest.mark.parametrize("switch", SKLEARN_SWITCHES)
def test_kmeans_sklearn_switch_degenerate_equals_jax(monkeypatch, switch):
    pytest.importorskip("sklearn")
    monkeypatch.setenv(tpal.KMEANS_ENV, switch)
    img = _degenerate_image()
    port = tpal.kmeans_palette(img, 16, device="cpu")
    assert port == jpal.kmeans_palette(img, 16)
    assert len(port) == 16 and (255, 0, 0) in port


@pytest.mark.parametrize("value", [None, "", "torch", "exact"])
def test_kmeans_without_switch_takes_torch_fit(monkeypatch, value):
    def refuse(*a, **k):
        raise AssertionError("sklearn route taken without the switch")

    monkeypatch.setattr(tpal, "_kmeans_palette_sklearn", refuse)
    img = bench.synth_image(60, 80, 1)
    monkeypatch.delenv(tpal.KMEANS_ENV, raising=False)
    want = tpal.kmeans_palette(img, 16, random_state=7, device="cpu")
    if value is not None:
        monkeypatch.setenv(tpal.KMEANS_ENV, value)
    assert tpal.kmeans_palette(img, 16, random_state=7, device="cpu") == want


@pytest.mark.parametrize("switch", ["sklearn", "REFERENCE"])
def test_kmeans_sklearn_switch_without_sklearn_raises(monkeypatch, switch):
    monkeypatch.setenv(tpal.KMEANS_ENV, switch)
    # A None entry in sys.modules makes the import raise ImportError.
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.cluster", None)

    def refuse(*a, **k):
        raise AssertionError("fell back to the torch fit")

    monkeypatch.setattr(tpal, "_kmeans_fit", refuse)
    with pytest.raises(ImportError, match=tpal.KMEANS_ENV):
        tpal.kmeans_palette(bench.synth_image(20, 30, 1), 4, device="cpu")

"""The port's wavelet mode (dither_pie_tpu_torch.ops.wavelet and
WaveletDitherStrategy) against the JAX package's, on the CPU.

What is exact and what is held by tolerance:

* the filter banks, the float64 numpy transform and the host noise
  (``_draw_noise``) are copies: bitwise equal to the JAX package's;
* ``dwt2`` / ``idwt2`` add each filter's taps as separate float32 multiplies
  and adds in tap order, XLA:CPU runs a convolution and contracts
  multiply-adds: atol 1e-3 on the coefficients and 1e-2 on the
  reconstruction, the margins tests/test_core.py gives the JAX package's own
  transform against its numpy twin;
* the facade against the JAX facade: pixel identity >= 0.98.
  ``floor(norm*q + noise)`` sits on a boundary for about one coefficient in
  10**6 of relative rounding difference, one flipped coefficient moves an
  L x L block of the reconstruction by ``scale / (q - 1)``, and the pick's
  direct differences round otherwise than the JAX package's expansion
  ``x^2 - 2xp + p^2`` off the integers; at these sizes one block is up to
  4 % of a frame. The observed identity is 0.9998 to 1.0;
* inside the port everything is exact: a batch equals its frames one by
  one, the index stream equals the colour output through ``pal[idx]``, and
  a batched transform equals the per-plane one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import bench
import dither_pie_tpu as jdpt
import dither_pie_tpu_torch as tdpt
from dither_pie_tpu.api import ditherer as jditherer
from dither_pie_tpu.ops import wavelet as jwav
from dither_pie_tpu_torch.api import ditherer as tditherer
from dither_pie_tpu_torch.core import palette as tpal
from dither_pie_tpu_torch.ops import wavelet as twav
import torch_workers  # noqa: F401

FACADE_WAVELETS = ["haar", "db2", "db4", "bior2.2"]
FACADE_SHAPES = [(40, 56), (33, 47), (64, 80)]
FACADE_IDENTITY = 0.98


def _identity(a, b):
    return float(np.all(a == b, axis=-1).mean())


def _frames(b, h, w, seed=50):
    return np.stack([bench.synth_image(h, w, seed + i) for i in range(b)])


# ---------------------------------------------------------------------------
# Host state: filter banks, the numpy transform, the noise
# ---------------------------------------------------------------------------


def test_wavelet_choices_equal_jax():
    assert twav.WAVELET_CHOICES == jwav.WAVELET_CHOICES
    info = tdpt.WaveletDitherStrategy.get_parameter_info()
    assert info["wavelet"]["choices"] == twav.WAVELET_CHOICES
    with pytest.raises(ValueError, match="unknown wavelet"):
        twav.filter_bank("db9")


@pytest.mark.parametrize("name", twav.WAVELET_CHOICES)
def test_filter_bank_bitwise(name):
    ours, ref = twav.filter_bank(name), jwav.filter_bank(name)
    assert len(ours) == 4
    for a, b in zip(ours, ref):
        assert a.dtype == np.float64
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", twav.WAVELET_CHOICES)
def test_numpy_twin_bitwise(name):
    a = np.random.RandomState(2).rand(13, 17) * 255
    cA, hvd = twav.dwt2_np(a, name)
    jA, jhvd = jwav.dwt2_np(a, name)
    for x, y in zip((cA, *hvd), (jA, *jhvd)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(twav.idwt2_np(cA, hvd, name), jwav.idwt2_np(jA, jhvd, name))


@pytest.mark.parametrize("wavelet,seed,h,w", [("haar", 42, 37, 53), ("db4", 7, 40, 56),
                                              ("bior2.2", 0, 16, 16)])
def test_draw_noise_bitwise(wavelet, seed, h, w):
    ours = tdpt.WaveletDitherStrategy(wavelet, 8, seed, device="cpu")._draw_noise(h, w)
    ref = jdpt.WaveletDitherStrategy(wavelet, 8, seed)._draw_noise(h, w)
    for a, b in zip(ours, ref):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The tensor transform
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w", [(16, 20), (13, 17)])
@pytest.mark.parametrize("name", twav.WAVELET_CHOICES)
def test_dwt2_idwt2_against_jnp_and_numpy(name, h, w):
    a = np.random.RandomState(1).rand(h, w).astype(np.float32) * 255
    cA, hvd = twav.dwt2(torch.from_numpy(a), name)
    jA, jhvd = jwav.dwt2_jnp(jnp.asarray(a), name)
    nA, nhvd = twav.dwt2_np(a, name)
    for ours, ref, twin in zip((cA, *hvd), (jA, *jhvd), (nA, *nhvd)):
        assert ours.dtype == torch.float32 and tuple(ours.shape) == ref.shape
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-3)
        np.testing.assert_allclose(ours.numpy(), twin, atol=1e-3)
    rec = twav.idwt2(cA, hvd, name)
    jrec = jwav.idwt2_jnp(jA, jhvd, name)
    assert tuple(rec.shape) == jrec.shape
    np.testing.assert_allclose(rec.numpy(), np.asarray(jrec), atol=1e-2)


@pytest.mark.parametrize("name", twav.WAVELET_CHOICES)
def test_perfect_reconstruction(name):
    a = np.random.RandomState(0).rand(13, 17).astype(np.float32) * 255
    cA, hvd = twav.dwt2(torch.from_numpy(a), name)
    L = len(twav.filter_bank(name)[0])
    assert tuple(cA.shape) == ((13 + L - 1) // 2, (17 + L - 1) // 2)
    rec = twav.idwt2(cA, hvd, name)[:13, :17]
    np.testing.assert_allclose(rec.numpy(), a, atol=1e-2)  # test_core.py's margin
    assert np.abs(rec.numpy() - a).max() < 5e-4  # what float32 taps give


@pytest.mark.parametrize("name", ["haar", "db4", "bior1.3"])
def test_batched_transform_equals_per_plane(name):
    planes = torch.from_numpy(np.random.RandomState(3).rand(2, 3, 21, 30).astype(np.float32) * 255)
    cA, hvd = twav.dwt2(planes, name)
    rec = twav.idwt2(cA, hvd, name)
    for b in range(2):
        for c in range(3):
            one_a, one_hvd = twav.dwt2(planes[b, c], name)
            for got, want in zip((cA, *hvd), (one_a, *one_hvd)):
                assert torch.equal(got[b, c], want)
            assert torch.equal(rec[b, c], twav.idwt2(one_a, one_hvd, name))
    with pytest.raises(ValueError, match="float32"):
        twav.dwt2(planes.double(), name)


# ---------------------------------------------------------------------------
# The subband quantiser
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q_levels", [2, 8, 32])
def test_quant_subband_against_jax_per_frame(q_levels):
    """Minimum and maximum belong to one subband of one channel of one
    frame: every (frame, channel) slice equals the JAX package's quantiser
    on that slice alone (the values are a few exact float32 steps; atol
    covers one ulp of ``qn * scale + mn``), and a flat subband comes back
    unchanged."""
    rng = np.random.RandomState(q_levels)
    sub = rng.normal(0, 90, (2, 3, 9, 11)).astype(np.float32)
    sub[1] *= 0.01  # a frame of another range: a batch-wide min/max would show
    sub[0, 2] = 5.0  # flat: scale == 0
    noise = rng.rand(3, 9, 11).astype(np.float32)
    ours = tditherer._quant_subband(torch.from_numpy(sub), torch.from_numpy(noise), q_levels)
    assert ours.dtype == torch.float32
    for b in range(2):
        for c in range(3):
            ref = np.asarray(jditherer._quant_subband_jnp(
                jnp.asarray(sub[b, c]), jnp.asarray(noise[c]), q_levels))
            np.testing.assert_allclose(ours[b, c].numpy(), ref, rtol=0, atol=2e-5)
            assert len(np.unique(ours[b, c].numpy())) <= q_levels
            one = tditherer._quant_subband(torch.from_numpy(sub[b:b + 1, c:c + 1]),
                                           torch.from_numpy(noise[c:c + 1]), q_levels)
            assert torch.equal(one[0, 0], ours[b, c])
    np.testing.assert_array_equal(ours[0, 2].numpy(), sub[0, 2])


# ---------------------------------------------------------------------------
# The facade
# ---------------------------------------------------------------------------


def _pair(params, use_gamma, palette):
    kw = dict(num_colors=len(palette), palette=palette, use_gamma=use_gamma,
              dither_params=dict(params))
    return (jdpt.ImageDitherer(dither_mode=jdpt.DitherMode.WAVELET, **kw),
            tdpt.ImageDitherer(dither_mode=tdpt.DitherMode.WAVELET, device="cpu", **kw))


@pytest.mark.parametrize("use_gamma", [False, True], ids=["srgb", "gamma"])
@pytest.mark.parametrize("shape", FACADE_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("wavelet", FACADE_WAVELETS)
def test_wavelet_facade_vs_jax(wavelet, shape, use_gamma, monkeypatch):
    """apply_dithering_batch and apply_dithering against the JAX facade,
    and inside the port the batch against its frames one by one, exactly."""
    monkeypatch.setenv("DITHER_PIE_TPU_INDEX_TRANSFER", "0")
    h, w = shape
    frames = _frames(2, h, w)
    palette = tpal.median_cut_palette(frames[0], 16)
    params = {"wavelet": wavelet, "subband_quant": 8 if wavelet == "haar" else 16,
              "seed": 42 if wavelet == "haar" else 7}
    jd, td = _pair(params, use_gamma, palette)
    out = td.apply_dithering_batch(frames)
    assert out.dtype == np.uint8 and out.shape == frames.shape
    ref = jd.apply_dithering_batch(frames)
    idents = [_identity(o, r) for o, r in zip(out, ref)]
    assert min(idents) >= FACADE_IDENTITY, idents
    allowed = {tuple(c) for c in td._from_dither(td._palette_for_dither().astype(np.uint8))}
    assert {tuple(c) for c in out.reshape(-1, 3)} <= allowed
    for i, frame in enumerate(frames):
        single = np.asarray(td.apply_dithering(Image.fromarray(frame)))
        np.testing.assert_array_equal(single, out[i])
    single_ref = np.asarray(jd.apply_dithering(Image.fromarray(frames[0])))
    assert _identity(out[0], single_ref) >= FACADE_IDENTITY


@pytest.mark.parametrize("use_gamma", [False, True], ids=["srgb", "gamma"])
@pytest.mark.parametrize("p", [2, 16, 256])
def test_wavelet_indices_equal_colours(p, use_gamma, monkeypatch):
    """``dither_batch_indices`` through ``pal[idx]`` is ``dither_batch``'s
    output, and the facade's index stream equals its RGB path."""
    frames = _frames(2, 22, 30)
    rng = np.random.RandomState(p)
    palette = [tuple(int(v) for v in c)
               for c in np.unique(rng.randint(0, 256, (8 * p + 64, 3)), axis=0)[:p]]
    d = tdpt.ImageDitherer(num_colors=p, dither_mode=tdpt.DitherMode.WAVELET, palette=palette,
                           use_gamma=use_gamma, dither_params={"wavelet": "db2"}, device="cpu")
    strategy = d._get_dither_strategy(d.dither_mode)
    pal = d._palette_for_dither()
    idx = strategy.dither_batch_indices(frames, pal)
    assert idx.dtype == np.uint8 and idx.shape == frames.shape[:3]
    np.testing.assert_array_equal(pal.astype(np.uint8)[idx], strategy.dither_batch(frames, pal))
    monkeypatch.setenv("DITHER_PIE_TPU_INDEX_TRANSFER", "0")
    rgb = d.apply_dithering_batch(frames)
    monkeypatch.setenv("DITHER_PIE_TPU_INDEX_TRANSFER", "1")
    np.testing.assert_array_equal(d.apply_dithering_batch(frames), rgb)


def test_wavelet_has_no_planar_and_no_wide_index_output():
    frames = _frames(1, 12, 16)
    strategy = tdpt.WaveletDitherStrategy(device="cpu")
    jstrategy = jdpt.WaveletDitherStrategy()
    assert strategy.get_current_parameters() == jstrategy.get_current_parameters()
    wide = np.random.RandomState(0).randint(0, 256, (257, 3)).astype(np.float32)
    for planar, pal in ((True, wide[:16]), (False, wide)):
        assert strategy.dither_batch_indices(frames, pal, planar=planar) is None
        assert jstrategy.dither_batch_indices(frames, pal, planar=planar) is None
    assert not hasattr(strategy, "dither_batch_planar")
    d = tdpt.ImageDitherer(dither_mode=tdpt.DitherMode.WAVELET, palette=[(0, 0, 0), (9, 9, 9)],
                           device="cpu")
    assert not d.supports_planar_batch()
    # More than 256 colours still dither, through the colour output.
    out = strategy.dither_batch(frames, wide)
    assert out.dtype == np.uint8 and out.shape == frames.shape


def test_wavelet_reconstruction_is_not_integer_valued():
    """The pick's input is a float32 reconstruction with fractions: the
    reason the ordered kernel takes float32 frames as they are."""
    frames = _frames(2, 24, 32)
    strategy = tdpt.WaveletDitherStrategy("db2", 8, 42, device="cpu")
    noises, _ = strategy._draw_noise(24, 32)
    rec = strategy.reconstruct(torch.from_numpy(frames), torch.from_numpy(noises))
    assert rec.dtype == torch.float32 and tuple(rec.shape) == frames.shape
    assert rec.is_contiguous() and 0 <= float(rec.min()) and float(rec.max()) <= 255
    assert float((rec != rec.floor()).float().mean()) > 0.5

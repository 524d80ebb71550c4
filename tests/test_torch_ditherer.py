"""The port's public surface (dither_pie_tpu_torch.ImageDitherer) against
the JAX package's, on the CPU, for the modes it serves: the error-diffusion
family (fixed-weight, Ostromoukhov, hybrid, perceptual, adaptive variance)
and the ordered family (none, Bayer, blue noise, IGN, polka dot); wavelet
and halftone have files of their own (test_torch_wavelet.py,
test_torch_halftone.py) and join the index-stream cases here.

* error diffusion, apply_dithering_batch: bitwise equal to the JAX
  package's for the same palette, gamma off and on (the JAX package runs
  its batch through the golden engine's f32 twin on the CPU);
* error diffusion, apply_dithering (single image): perceptual (identity
  >= 0.98, 4x4 block mean <= 8, max <= 48), because the JAX package's
  single-image CPU path searches the palette in float64 and the port in
  float32; and bitwise against the golden engine's f32 twin of the mode;
* the ordered family, apply_dithering_batch and apply_dithering: bitwise
  equal to the JAX package's, gamma off and on (the gamma path's palettes
  are not integers, and still every pixel agrees);
* the index stream (DITHER_PIE_TPU_INDEX_TRANSFER=1) and planar batches:
  bitwise equal to the RGB NHWC path, gamma off and on, every served mode;
  the ordered modes' index stream also bitwise equal to the JAX package's;
  supports_planar_batch and the link probe's verdict equal to the JAX
  package's rules;
* parameter metadata: get_mode_parameters equals the JAX package's for
  every mode;
* failure behaviour: CUDA without a GPU raises, unported modes and options
  raise NotImplementedError naming their ROADMAP item, and importing the
  port loads no jax.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import bench
import dither_pie_tpu as jdpt
import dither_pie_tpu_torch as tdpt
from dither_pie_tpu.core.fidelity import assert_perceptually_matched
from dither_pie_tpu_torch.api import linkspeed as tlink
from dither_pie_tpu_torch.core import palette as tpal
from dither_pie_tpu_torch.ops import idxpack as tpack

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture()
def golden_engine_batches(monkeypatch):
    """Pin the JAX package's batch path to the golden engine on the CPU."""
    monkeypatch.setenv("DITHER_PIE_TPU_ED_BACKEND", "native")
    monkeypatch.setenv("DITHER_PIE_TPU_INDEX_TRANSFER", "0")


def _frames(b=3, h=36, w=52):
    return np.stack([bench.synth_image(h, w, 30 + i) for i in range(b)])


@pytest.mark.parametrize("use_gamma", [False, True], ids=["srgb", "gamma"])
@pytest.mark.parametrize("variant", ["floyd_steinberg", "stucki"])
def test_apply_dithering_batch_bitwise_vs_jax(variant, use_gamma,
                                              golden_engine_batches):
    frames = _frames()
    palette = tpal.median_cut_palette(frames[0], 32)
    kw = dict(num_colors=32, palette=palette, use_gamma=use_gamma,
              dither_params={"variant": variant})
    ref = jdpt.ImageDitherer(dither_mode=jdpt.DitherMode.ERROR_DIFFUSION,
                             **kw).apply_dithering_batch(frames)
    out = tdpt.ImageDitherer(dither_mode=tdpt.DitherMode.ERROR_DIFFUSION,
                             device="cpu", **kw).apply_dithering_batch(frames)
    assert out.dtype == np.uint8 and out.shape == frames.shape
    np.testing.assert_array_equal(out, ref)


def test_apply_dithering_single_image_perceptual_vs_jax(golden_engine_batches):
    img = Image.fromarray(bench.synth_image(45, 64, 5))
    kw = dict(num_colors=16, dither_params={"variant": "floyd_steinberg"})
    jd = jdpt.ImageDitherer(dither_mode=jdpt.DitherMode.ERROR_DIFFUSION, **kw)
    td = tdpt.ImageDitherer(dither_mode=tdpt.DitherMode.ERROR_DIFFUSION,
                            device="cpu", **kw)
    ref = np.asarray(jd.apply_dithering(img))
    out = np.asarray(td.apply_dithering(img))
    assert td.palette == jd.palette  # median-cut palette cached on both
    assert out.shape == ref.shape and out.dtype == np.uint8
    assert_perceptually_matched(out, ref, min_identical=0.98, block=4,
                                max_block_mean=8.0, max_block_max=48.0)


# The rest of the error-diffusion family: (mode, dither_params).
ED_MODE_CASES = [
    ("ostromoukhov", {}),
    ("hybrid", {"lum_factor": 0.8, "col_factor": 0.35}),
    ("perceptual", {}),
    ("adaptive_variance", {"var_threshold": 250.0, "window_radius": 2}),
]
ED_MODE_IDS = [m for m, _ in ED_MODE_CASES]


@pytest.mark.parametrize("use_gamma", [False, True], ids=["srgb", "gamma"])
@pytest.mark.parametrize("mode,params", ED_MODE_CASES, ids=ED_MODE_IDS)
def test_ed_modes_batch_bitwise_vs_jax(mode, params, use_gamma, golden_engine_batches):
    """The JAX package's batch runs the golden engine's f32 twin of the
    mode; the port's equals it bit for bit, gamma off and on."""
    frames = _frames()
    palette = tpal.median_cut_palette(frames[0], 32)
    kw = dict(num_colors=32, palette=palette, use_gamma=use_gamma,
              dither_params=dict(params))
    ref = jdpt.ImageDitherer(dither_mode=jdpt.DitherMode(mode),
                             **kw).apply_dithering_batch(frames)
    out = tdpt.ImageDitherer(dither_mode=tdpt.DitherMode(mode), device="cpu",
                             **kw).apply_dithering_batch(frames)
    assert out.dtype == np.uint8 and out.shape == frames.shape
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("mode,params", ED_MODE_CASES, ids=ED_MODE_IDS)
def test_ed_modes_single_image_vs_jax_and_twin(mode, params, golden_engine_batches):
    """apply_dithering: the JAX package's single image runs its exact
    float64 engine, so it is held perceptually; the f32 twin (which the JAX
    package's one-frame batch runs) bitwise."""
    arr = bench.synth_image(45, 64, 5)
    img = Image.fromarray(arr)
    kw = dict(num_colors=16, dither_params=dict(params))
    jd = jdpt.ImageDitherer(dither_mode=jdpt.DitherMode(mode), **kw)
    td = tdpt.ImageDitherer(dither_mode=tdpt.DitherMode(mode), device="cpu", **kw)
    ref = np.asarray(jd.apply_dithering(img))
    out = np.asarray(td.apply_dithering(img))
    assert td.palette == jd.palette
    assert out.shape == ref.shape and out.dtype == np.uint8
    assert_perceptually_matched(out, ref, min_identical=0.98, block=4,
                                max_block_mean=8.0, max_block_max=48.0)
    np.testing.assert_array_equal(out, jd.apply_dithering_batch(arr[None])[0])
    strategy = td._get_dither_strategy(td.dither_mode)
    assert strategy.device == torch.device("cpu")
    jstrategy = jd._get_dither_strategy(jd.dither_mode)
    assert strategy.get_current_parameters() == jstrategy.get_current_parameters()


@pytest.mark.parametrize("num_colors", [256, 2048])
def test_large_palette_batch_bitwise_vs_jax(num_colors, golden_engine_batches):
    """ERROR_DIFFUSION with a 256-colour k-means palette (K2's route) and a
    2048-colour palette (K8 -> K9's route)."""
    frames = _frames(2, 24, 40)
    if num_colors == 256:
        palette = tdpt.ColorReducer.generate_kmeans_palette(
            Image.fromarray(frames[0]), 256, device="cpu")
    else:
        cols = np.unique(np.random.RandomState(3).randint(0, 256, (9000, 3)), axis=0)
        palette = [tuple(int(v) for v in c) for c in cols[:2048]]
    assert len(palette) == num_colors
    kw = dict(num_colors=num_colors, palette=palette,
              dither_params={"variant": "floyd_steinberg"})
    ref = jdpt.ImageDitherer(dither_mode=jdpt.DitherMode.ERROR_DIFFUSION,
                             **kw).apply_dithering_batch(frames)
    out = tdpt.ImageDitherer(dither_mode=tdpt.DitherMode.ERROR_DIFFUSION,
                             device="cpu", **kw).apply_dithering_batch(frames)
    np.testing.assert_array_equal(out, ref)


def test_kmeans_palette_drives_the_batch():
    """The main path in miniature: k-means palette, then the batch; every
    output pixel is a palette colour."""
    frames = _frames(2, 24, 40)
    palette = tdpt.ColorReducer.generate_kmeans_palette(
        Image.fromarray(frames[0]), 32, device="cpu")
    out = tdpt.ImageDitherer(
        num_colors=32, dither_mode=tdpt.DitherMode.ERROR_DIFFUSION,
        palette=palette, dither_params={"variant": "floyd_steinberg"},
        device="cpu").apply_dithering_batch(frames)
    assert set(map(tuple, out.reshape(-1, 3).tolist())) <= set(palette)


# The ordered family: (mode, dither_params), every Bayer size included.
ORDERED_CASES = [
    ("none", {}),
    ("bayer", {"size": "2x2"}),
    ("bayer", {"size": "4x4"}),
    ("bayer", {"size": "8x8"}),
    ("bayer", {"size": "16x16"}),
    ("bayer", {"size": "psx4x4"}),
    ("blue_noise", {"size": 32, "seed": 42}),
    ("IGN", {"scale": 2.5, "seed": 7}),
    ("polka_dot", {"tile_size": 6, "gamma": 2.0}),
]
ORDERED_IDS = [f"{m}-{p.get('size', '')}".rstrip("-") for m, p in ORDERED_CASES]
ORDERED_MODES = {tdpt.DitherMode(m) for m, _ in ORDERED_CASES}
ED_MODES = {tdpt.DitherMode.ERROR_DIFFUSION} | {tdpt.DitherMode(m) for m, _ in ED_MODE_CASES}


@pytest.fixture()
def rgb_batches(monkeypatch):
    """Pin both packages' batch paths to their RGB output (the index
    stream has tests of its own below)."""
    monkeypatch.setenv("DITHER_PIE_TPU_INDEX_TRANSFER", "0")


def _ordered_pair(mode, params, use_gamma, palette):
    kw = dict(num_colors=len(palette), palette=palette, use_gamma=use_gamma,
              dither_params=dict(params))
    return (jdpt.ImageDitherer(dither_mode=jdpt.DitherMode(mode), **kw),
            tdpt.ImageDitherer(dither_mode=tdpt.DitherMode(mode), device="cpu", **kw))


@pytest.mark.parametrize("use_gamma", [False, True], ids=["srgb", "gamma"])
@pytest.mark.parametrize("mode,params", ORDERED_CASES, ids=ORDERED_IDS)
def test_ordered_batch_bitwise_vs_jax(mode, params, use_gamma, rgb_batches):
    frames = _frames(2, 30, 44)
    palette = tpal.median_cut_palette(frames[0], 16)
    jd, td = _ordered_pair(mode, params, use_gamma, palette)
    ref = jd.apply_dithering_batch(frames)
    out = td.apply_dithering_batch(frames)
    assert out.dtype == np.uint8 and out.shape == frames.shape
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("use_gamma", [False, True], ids=["srgb", "gamma"])
@pytest.mark.parametrize("mode,params", ORDERED_CASES, ids=ORDERED_IDS)
def test_ordered_single_image_bitwise_vs_jax(mode, params, use_gamma):
    img = Image.fromarray(bench.synth_image(27, 41, 8))
    palette = tpal.median_cut_palette(np.asarray(img), 8)
    jd, td = _ordered_pair(mode, params, use_gamma, palette)
    ref = np.asarray(jd.apply_dithering(img))
    out = np.asarray(td.apply_dithering(img))
    assert out.shape == ref.shape and out.dtype == np.uint8
    np.testing.assert_array_equal(out, ref)


def test_default_ditherer_dithers_bayer_4x4():
    """ImageDitherer() with default arguments (BAYER, 16 colours, median-cut
    palette) dithers, as the JAX package's does."""
    img = Image.fromarray(bench.synth_image(33, 47, 9))
    td = tdpt.ImageDitherer(device="cpu")
    assert td.dither_mode is tdpt.DitherMode.BAYER
    out = np.asarray(td.apply_dithering(img))
    jd = jdpt.ImageDitherer()
    np.testing.assert_array_equal(out, np.asarray(jd.apply_dithering(img)))
    assert td.palette == jd.palette and len(td.palette) == 16
    strategy = td._get_dither_strategy(td.dither_mode)
    assert isinstance(strategy, tdpt.BayerDitherStrategy)
    assert strategy.get_current_parameters() == {"size": "4x4"}
    explicit = tdpt.ImageDitherer(dither_mode=tdpt.DitherMode.BAYER, palette=td.palette,
                                  dither_params={"size": "4x4"}, device="cpu")
    np.testing.assert_array_equal(out, np.asarray(explicit.apply_dithering(img)))


def test_parameterless_strategy_built_with_device_only():
    """NONE has no parameters (get_parameter_info() is None): it is built
    with the device alone and ignores dither_params, as in the JAX package."""
    assert tdpt.NoDitherStrategy.get_parameter_info() is None
    d = tdpt.ImageDitherer(dither_mode=tdpt.DitherMode.NONE, palette=[(0, 0, 0), (255, 255, 255)],
                           dither_params={"size": "8x8"}, device="cpu")
    strategy = d._get_dither_strategy(tdpt.DitherMode.NONE)
    assert isinstance(strategy, tdpt.NoDitherStrategy)
    assert strategy.device == torch.device("cpu")
    out = d.apply_dithering_batch(np.full((1, 2, 3, 3), 200, np.uint8))
    np.testing.assert_array_equal(out, np.full((1, 2, 3, 3), 255, np.uint8))


@pytest.mark.parametrize("mode", list(tdpt.DitherMode), ids=lambda m: m.value)
def test_get_mode_parameters_equals_jax(mode):
    jmode = jdpt.DitherMode(mode.value)
    ours = tdpt.ImageDitherer.get_mode_parameters(mode)
    ref = jdpt.ImageDitherer.get_mode_parameters(jmode)
    assert ours == ref
    assert (tdpt.ImageDitherer.mode_has_parameters(mode)
            == jdpt.ImageDitherer.mode_has_parameters(jmode))
    if ours is not None:
        def types(info):
            return {k: type(v["default"]) for k, v in info.items()}
        assert types(ours) == types(ref)  # 1 == 1.0, so compare types too
        ours["mutated"] = {}  # a fresh dict each call
        assert "mutated" not in tdpt.ImageDitherer.get_mode_parameters(mode)


def test_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the check is for machines without")
    with pytest.raises(RuntimeError, match="cuda"):
        tdpt.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        tdpt.ImageDitherer(dither_mode=tdpt.DitherMode.ERROR_DIFFUSION)
    with pytest.raises(RuntimeError):
        tdpt.ImageDitherer()
    with pytest.raises(RuntimeError):
        tdpt.BayerDitherStrategy(device="cuda")
    with pytest.raises(RuntimeError):
        tpal.kmeans_palette(np.zeros((4, 4, 3), np.uint8), 2, device="cuda")
    with pytest.raises(ValueError):
        tdpt.resolve_device("meta")
    assert tdpt.resolve_device("cpu") == torch.device("cpu")


TRANSFORM_MODES = {tdpt.DitherMode.WAVELET, tdpt.DitherMode.HALFTONE}


@pytest.mark.parametrize("mode", [m for m in tdpt.DitherMode
                                  if m not in ED_MODES | ORDERED_MODES | TRANSFORM_MODES])
def test_unported_modes_raise(mode):
    assert mode is tdpt.DitherMode.RIEMERSMA  # the one mode still to port
    d = tdpt.ImageDitherer(dither_mode=mode, palette=[(0, 0, 0), (255, 255, 255)],
                           device="cpu")
    with pytest.raises(NotImplementedError, match=r"ROADMAP A5"):
        d.apply_dithering_batch(np.zeros((1, 4, 4, 3), np.uint8))


@pytest.mark.parametrize("mode", sorted(TRANSFORM_MODES, key=lambda m: m.value),
                         ids=lambda m: m.value)
def test_wavelet_and_halftone_are_served(mode):
    """The two modes the facade refused before dither now, single image
    and batch, to palette colours only (their tests against the JAX package
    are tests/test_torch_wavelet.py and tests/test_torch_halftone.py)."""
    frames = _frames(2, 20, 28)
    palette = tpal.median_cut_palette(frames[0], 8)
    d = tdpt.ImageDitherer(num_colors=8, dither_mode=mode, palette=palette, device="cpu")
    out = d.apply_dithering_batch(frames)
    assert out.dtype == np.uint8 and out.shape == frames.shape
    assert {tuple(c) for c in out.reshape(-1, 3)} <= set(palette)
    np.testing.assert_array_equal(
        np.asarray(d.apply_dithering(Image.fromarray(frames[1]))), out[1])
    assert not hasattr(tdpt, "parameters") and "parameters" not in dir(tdpt.api)


def test_unported_options_raise():
    frames = np.zeros((1, 4, 4, 3), np.uint8)
    pal = [(0, 0, 0), (255, 255, 255)]
    ed = tdpt.DitherMode.ERROR_DIFFUSION
    serp = tdpt.ImageDitherer(dither_mode=ed, palette=pal, device="cpu",
                              dither_params={"serpentine": "true"})
    with pytest.raises(NotImplementedError, match="A5"):
        serp.apply_dithering_batch(frames)
    serp = tdpt.ImageDitherer(dither_mode=tdpt.DitherMode.OSTROMOUKHOV, palette=pal,
                              device="cpu", dither_params={"serpentine": "true"})
    with pytest.raises(NotImplementedError, match="A5"):
        serp.apply_dithering_batch(frames)
    # Planar batches are served by the error-diffusion strategies only.
    bayer = tdpt.ImageDitherer(dither_mode=tdpt.DitherMode.BAYER, palette=pal, device="cpu")
    with pytest.raises(ValueError, match="supports_planar_batch"):
        bayer.apply_dithering_batch(np.zeros((3, 1, 4, 4), np.uint8), planar=True)
    with pytest.raises(ValueError, match="palette"):
        tdpt.ImageDitherer(dither_mode=ed, device="cpu").apply_dithering_batch(frames)


# ---------------------------------------------------------------------------
# The index stream and planar batches
# ---------------------------------------------------------------------------

ALL_ED_CASES = [("error_diffusion", {"variant": "floyd_steinberg"})] + ED_MODE_CASES
INDEX_ORDERED_CASES = [
    ("none", {}),
    ("bayer", {"size": "4x4"}),
    ("blue_noise", {"size": 32, "seed": 42}),
    ("IGN", {"scale": 2.5, "seed": 7}),
    ("polka_dot", {"tile_size": 6, "gamma": 2.0}),
]
INDEX_CASES = ALL_ED_CASES + INDEX_ORDERED_CASES + [
    ("wavelet", {"wavelet": "db2"}), ("halftone", {"cell_size": 4})]
INDEX_IDS = [m for m, _ in INDEX_CASES]


def _unique_palette(p, seed):
    rng = np.random.RandomState(seed)
    pal = np.unique(rng.randint(0, 256, (8 * p + 64, 3)), axis=0)
    return [tuple(int(v) for v in c) for c in pal[rng.permutation(len(pal))[:p]]]


def _spy_indices(monkeypatch, strategy_class):
    """Count the index-output calls of a strategy class that return indices."""
    calls = []
    real = strategy_class.dither_batch_indices

    def spy(self, images, palette_arr, planar=False):
        idx = real(self, images, palette_arr, planar=planar)
        calls.append(None if idx is None else idx.dtype)
        return idx

    monkeypatch.setattr(strategy_class, "dither_batch_indices", spy)
    return calls


@pytest.mark.parametrize("use_gamma", [False, True], ids=["srgb", "gamma"])
@pytest.mark.parametrize("p", [2, 4, 16, 32, 256])
@pytest.mark.parametrize("mode,params", INDEX_CASES, ids=INDEX_IDS)
def test_index_stream_equals_rgb_path(mode, params, p, use_gamma, monkeypatch):
    """apply_dithering_batch with the index stream forced on equals the RGB
    path bit for bit (gamma folds into the palette), bit-packed (P <= 16),
    packing switched off, and plain u8 alike."""
    frames = _frames(2, 12, 18)
    d = tdpt.ImageDitherer(num_colors=p, dither_mode=tdpt.DitherMode(mode),
                           palette=_unique_palette(p, p), use_gamma=use_gamma,
                           dither_params=dict(params), device="cpu")
    monkeypatch.setenv("DITHER_PIE_TPU_INDEX_TRANSFER", "0")
    rgb = d.apply_dithering_batch(frames)
    calls = _spy_indices(monkeypatch, type(d._get_dither_strategy(d.dither_mode)))
    assert d.apply_dithering_batch(frames) is not None and calls == []
    monkeypatch.setenv("DITHER_PIE_TPU_INDEX_TRANSFER", "1")
    out = d.apply_dithering_batch(frames)
    assert calls == [np.uint8]  # the index branch ran and returned indices
    assert out.dtype == np.uint8 and out.shape == frames.shape
    np.testing.assert_array_equal(out, rgb)
    monkeypatch.setenv("DITHER_PIE_TPU_INDEX_PACK", "0")
    np.testing.assert_array_equal(d.apply_dithering_batch(frames), rgb)


@pytest.mark.parametrize("use_gamma", [False, True], ids=["srgb", "gamma"])
@pytest.mark.parametrize("p", [2, 16, 256])
@pytest.mark.parametrize("mode,params", INDEX_ORDERED_CASES,
                         ids=[m for m, _ in INDEX_ORDERED_CASES])
def test_ordered_index_stream_bitwise_vs_jax(mode, params, p, use_gamma, monkeypatch):
    """The JAX package's ordered index path is exact on the CPU: both
    facades with the index stream forced on give the same bytes."""
    monkeypatch.setenv("DITHER_PIE_TPU_INDEX_TRANSFER", "1")
    frames = _frames(2, 12, 18)
    jd, td = _ordered_pair(mode, params, use_gamma, _unique_palette(p, p))
    np.testing.assert_array_equal(td.apply_dithering_batch(frames),
                                  jd.apply_dithering_batch(frames))


@pytest.mark.parametrize("p,dtype", [(300, np.uint16), (1024, np.uint16), (1025, None)])
def test_index_stream_wide_palettes(p, dtype, monkeypatch):
    """257-1024 colours ride a uint16 stream; above, the error-diffusion
    strategy has no index output and the RGB path answers. Ordered
    strategies stop at 256."""
    frames = _frames(1, 10, 14)
    palette = _unique_palette(p, 3)
    d = tdpt.ImageDitherer(num_colors=p, dither_mode=tdpt.DitherMode.ERROR_DIFFUSION,
                           palette=palette, dither_params={"variant": "floyd_steinberg"},
                           device="cpu")
    monkeypatch.setenv("DITHER_PIE_TPU_INDEX_TRANSFER", "0")
    rgb = d.apply_dithering_batch(frames)
    monkeypatch.setenv("DITHER_PIE_TPU_INDEX_TRANSFER", "1")
    strategy = d._get_dither_strategy(d.dither_mode)
    idx = strategy.dither_batch_indices(frames, np.array(palette, np.float32))
    assert (idx is None) if dtype is None else (idx.dtype == dtype)
    np.testing.assert_array_equal(d.apply_dithering_batch(frames), rgb)
    bayer = tdpt.BayerDitherStrategy(device="cpu")
    assert (bayer.dither_batch_indices(frames, np.array(palette, np.float32)) is None)
    assert bayer.dither_batch_indices(frames, np.array(palette[:256], np.float32),
                                      planar=True) is None


def test_index_stream_failure_raises(monkeypatch):
    """No fallback to RGB: a failing index path is the caller's to see."""
    def boom(idx, p, w):
        raise RuntimeError("index copy failed")

    monkeypatch.setenv("DITHER_PIE_TPU_INDEX_TRANSFER", "1")
    monkeypatch.setattr(tpack, "packed_transfer", boom)
    for mode in (tdpt.DitherMode.ERROR_DIFFUSION, tdpt.DitherMode.BAYER):
        d = tdpt.ImageDitherer(dither_mode=mode, palette=_unique_palette(8, 1), device="cpu")
        with pytest.raises(RuntimeError, match="index copy failed"):
            d.apply_dithering_batch(_frames(1, 8, 8))


@pytest.mark.parametrize("index", ["0", "1"], ids=["rgb", "index"])
@pytest.mark.parametrize("use_gamma", [False, True], ids=["srgb", "gamma"])
@pytest.mark.parametrize("mode,params", ALL_ED_CASES, ids=[m for m, _ in ALL_ED_CASES])
def test_planar_batch_equals_nhwc(mode, params, use_gamma, index, monkeypatch):
    """apply_dithering_batch(planar=True): (3, B, H, W) planes in and out,
    the NHWC result transposed, with and without the index stream."""
    frames = _frames(3, 14, 20)
    planes = np.ascontiguousarray(np.moveaxis(frames, -1, 0))
    d = tdpt.ImageDitherer(num_colors=16, dither_mode=tdpt.DitherMode(mode),
                           palette=_unique_palette(16, 5), use_gamma=use_gamma,
                           dither_params=dict(params), device="cpu")
    assert d.supports_planar_batch()
    monkeypatch.setenv("DITHER_PIE_TPU_INDEX_TRANSFER", "0")
    nhwc = d.apply_dithering_batch(frames)
    monkeypatch.setenv("DITHER_PIE_TPU_INDEX_TRANSFER", index)
    out = d.apply_dithering_batch(planes, planar=True)
    assert out.dtype == np.uint8 and out.shape == planes.shape
    np.testing.assert_array_equal(np.moveaxis(out, 0, -1), nhwc)


@pytest.mark.parametrize("mode", list(tdpt.DitherMode), ids=lambda m: m.value)
def test_supports_planar_batch_equals_jax(mode, monkeypatch):
    """The JAX package's answer when its wavefront backend serves error
    diffusion, for every mode, serpentine scans and an oversized palette."""
    monkeypatch.setenv("DITHER_PIE_TPU_ED_BACKEND", "wavefront")
    jmode = jdpt.DitherMode(mode.value)
    serp = {"serpentine": "true"}
    for kw in ({"palette": None}, {"palette": _unique_palette(16, 1)},
               {"palette": _unique_palette(1024, 2)}, {"palette": _unique_palette(2048, 3)},
               {"palette": _unique_palette(16, 1), "dither_params": serp}):
        ours = tdpt.ImageDitherer(dither_mode=mode, device="cpu", **kw).supports_planar_batch()
        assert ours == jdpt.ImageDitherer(dither_mode=jmode, **kw).supports_planar_batch(), kw
        if ours:
            assert mode in ED_MODES and len(kw["palette"] or []) <= 1024


def test_link_probe_verdict(monkeypatch):
    assert tlink.d2h_bandwidth_mb_s("cpu") is None
    monkeypatch.delenv("DITHER_PIE_TPU_INDEX_TRANSFER", raising=False)
    assert tlink.index_transfer_wins("cpu") is False  # no link to relieve
    for env, want in (("1", True), ("0", False)):
        monkeypatch.setenv("DITHER_PIE_TPU_INDEX_TRANSFER", env)
        assert tlink.index_transfer_wins("cpu") is want
    # The measured side of the rule: 2 bytes a pixel saved on the link
    # against the host gather's measured time a pixel. A gather of 2 ns a
    # pixel puts the break-even at the JAX package's 1000 MB/s, one of 16 ns
    # at 125 MB/s; a forced choice never probes.
    ns = tlink.host_gather_ns_per_px()
    assert 0.0 < ns < 1e4 and tlink.host_gather_ns_per_px() == ns  # measured once
    assert tlink.break_even_mb_s() == 2e3 / ns
    monkeypatch.delenv("DITHER_PIE_TPU_INDEX_TRANSFER")
    monkeypatch.setattr(tlink, "host_gather_ns_per_px", lambda: 16.0)
    monkeypatch.setattr(tlink, "d2h_bandwidth_mb_s", lambda device: 124.9)
    assert tlink.break_even_mb_s() == 125.0 and tlink.index_transfer_wins("cpu") is True
    monkeypatch.setattr(tlink, "d2h_bandwidth_mb_s", lambda device: 125.0)
    assert tlink.index_transfer_wins("cpu") is False
    monkeypatch.setattr(tlink, "host_gather_ns_per_px", lambda: 2.0)
    asked = []
    for mb_s, want in ((999.9, True), (1000.0, False), (2400.0, False), (40.0, True)):
        monkeypatch.setattr(tlink, "d2h_bandwidth_mb_s",
                            lambda device, v=mb_s: asked.append(device) or v)
        monkeypatch.delenv("DITHER_PIE_TPU_INDEX_TRANSFER", raising=False)
        assert tlink.index_transfer_wins("cpu") is want
        monkeypatch.setenv("DITHER_PIE_TPU_INDEX_TRANSFER", "0" if want else "1")
        assert tlink.index_transfer_wins("cpu") is (not want)
    assert asked == ["cpu"] * 4
    if not torch.cuda.is_available():
        monkeypatch.undo()
        with pytest.raises(RuntimeError, match="cuda"):
            tlink.d2h_bandwidth_mb_s("cuda")  # an absent card raises, no None


def test_facade_follows_the_probe(monkeypatch):
    """With the environment unset the facade takes the path the probe's
    verdict names."""
    monkeypatch.delenv("DITHER_PIE_TPU_INDEX_TRANSFER", raising=False)
    frames = _frames(1, 10, 12)
    d = tdpt.ImageDitherer(dither_mode=tdpt.DitherMode.ERROR_DIFFUSION,
                           palette=_unique_palette(16, 4), device="cpu")
    calls = _spy_indices(monkeypatch, tdpt.ErrorDiffusionDitherStrategy)
    rgb = d.apply_dithering_batch(frames)
    assert calls == []  # a CPU device has no link: RGB
    monkeypatch.setattr(tlink, "host_gather_ns_per_px", lambda: 16.0)  # even at 125 MB/s
    monkeypatch.setattr(tlink, "d2h_bandwidth_mb_s", lambda device: 40.0)
    np.testing.assert_array_equal(d.apply_dithering_batch(frames), rgb)
    assert calls == [np.uint8]
    monkeypatch.setattr(tlink, "d2h_bandwidth_mb_s", lambda device: 2400.0)
    d.apply_dithering_batch(frames)
    assert calls == [np.uint8]


def test_import_loads_no_jax():
    code = ("import sys, dither_pie_tpu_torch; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m.startswith('dither_pie_tpu.') or m == 'dither_pie_tpu']; "
            "assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_chip_smoke_refuses_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the check is for machines without")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={**os.environ})
    assert res.returncode != 0
    assert '"ok"' not in res.stdout

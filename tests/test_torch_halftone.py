"""The port's halftone mode (dither_pie_tpu_torch.ops.halftone and
HalftoneDitherStrategy) against the JAX package's, on the CPU.

What is exact and what is held by tolerance:

* ``halftone_screen`` is a copy of host float64 code: screen, cell layout
  and cell count bitwise equal to the JAX package's;
* the per-pixel work against the JAX package: XLA:CPU contracts
  multiply-adds and runs the cell search as a dot product, the port writes
  every product and sum as its own float32 op. So a cell whose two nearest
  colours are a near tie may take the other colour (and with it about
  ``cell_size**2`` pixels: at 37x53 one cell is over 0.5 % of the frame),
  and a pixel whose ink margin ``(1 - gray/255) - screen`` is a rounding
  error wide may flip. The tests therefore hold that **every differing
  pixel lies in such a cell or is such a pixel** (judged in float64:
  relative gap of the two best distances under 1e-4, ink margin under
  1e-6) at every size, and pixel identity >= 0.995 from 256x256 up, the
  margin tests/test_parity_ordered.py gives the JAX package itself;
* inside the port everything is exact: a batch equals its frames one by
  one, indices through ``pal[idx]`` equal the colours, chunking the cell
  search changes nothing, and ties go to the first colour.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import bench
import dither_pie_tpu as jdpt
import dither_pie_tpu_torch as tdpt
from dither_pie_tpu.ops import halftone as jhalf
from dither_pie_tpu_torch.core import palette as tpal
from dither_pie_tpu_torch.ops import halftone as thalf

SCREEN_CASES = [
    (37, 53, {}),
    (64, 80, {"cell_size": 6, "angle": 30.0, "shape": "diamond"}),
    (40, 40, {"cell_size": 4, "angle": 0.0, "shape": "square", "sharpness": 1.0}),
    (33, 47, {"cell_size": 12, "angle": 75.0, "dot_gain": 1.7, "min_dot_size": 0.1,
              "max_dot_size": 0.9}),
    (20, 90, {"cell_size": 32, "angle": 90.0, "shape": "other"}),
    (256, 256, {}),
]
FACADE_PARAMS = [{}, {"cell_size": 6, "angle": 30.0, "shape": "diamond"},
                 {"cell_size": 4, "angle": 0.0, "shape": "square", "dot_gain": 1.5}]
FACADE_SHAPES = [(37, 53), (64, 80), (256, 256)]


def _frames(b, h, w, seed=70):
    return np.stack([bench.synth_image(h, w, seed + i) for i in range(b)])


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _explained(frame, pal, screen, cell_idx, n_cells, differs):
    """True where a differing pixel is explained in float64: its cell's two
    best colours are a near tie, or its ink margin is a rounding error."""
    px = frame.reshape(-1, 3).astype(np.float64)
    flat = cell_idx.reshape(-1)
    counts = np.maximum(np.bincount(flat, minlength=n_cells), 1)[:, None]
    avgs = np.stack([np.bincount(flat, px[:, c], n_cells) for c in range(3)], 1) / counts
    d = ((avgs[:, None, :] - pal[None].astype(np.float64)) ** 2).sum(-1)
    best = np.sort(d, axis=1)[:, :2]
    near_tie = (best[:, 1] - best[:, 0]) <= 1e-4 * np.maximum(best[:, 1], 1.0)
    gray = px @ np.array([0.299, 0.587, 0.114])
    margin = np.abs((1.0 - gray / 255.0) - screen.reshape(-1).astype(np.float64))
    ok = near_tie[flat] | (margin < 1e-6)
    return ok.reshape(differs.shape) | ~differs


# ---------------------------------------------------------------------------
# The host screen
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w,params", SCREEN_CASES, ids=[str(i) for i in range(len(SCREEN_CASES))])
def test_halftone_screen_bitwise(h, w, params):
    screen, cell_idx, n_cells = thalf.halftone_screen(h, w, **params)
    jscreen, jcell, jn = jhalf.halftone_screen(h, w, **params)
    assert screen.dtype == np.float32 and cell_idx.dtype == np.int32
    assert n_cells == jn == int(cell_idx.max()) + 1
    np.testing.assert_array_equal(screen, jscreen)
    np.testing.assert_array_equal(cell_idx, jcell)
    assert thalf.halftone_screen(h, w, **params)[0] is screen  # cached


# ---------------------------------------------------------------------------
# The torch ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p", [2, 16, 100])
@pytest.mark.parametrize("h,w,params", SCREEN_CASES[:4] + SCREEN_CASES[5:],
                         ids=["37x53", "64x80", "40x40", "33x47", "256x256"])
def test_halftone_ops_against_jax(h, w, params, p):
    frames = _frames(2, h, w)
    pal = np.asarray(tpal.median_cut_palette(frames[0], p), np.float32)
    screen, cell_idx, n_cells = thalf.halftone_screen(h, w, **params)
    ours = thalf.halftone_dither_batch(*_t(frames, pal, screen, cell_idx), n_cells)
    idx = thalf.halftone_dither_batch_indices(*_t(frames, pal, screen, cell_idx), n_cells)
    assert ours.dtype == torch.uint8 and tuple(ours.shape) == frames.shape
    assert idx.dtype == torch.uint8 and tuple(idx.shape) == frames.shape[:3]
    np.testing.assert_array_equal(pal.astype(np.uint8)[idx.numpy()], ours.numpy())
    ja = [jnp.asarray(frames, jnp.float32), jnp.asarray(pal), jnp.asarray(screen),
          jnp.asarray(cell_idx)]
    ref = np.asarray(jhalf.halftone_dither_batch(*ja, n_cells))
    ref_idx = np.asarray(jhalf.halftone_dither_batch_indices(*ja, n_cells))
    for k in range(2):
        differs = idx.numpy()[k] != ref_idx[k]
        assert _explained(frames[k], pal, screen, cell_idx, n_cells, differs).all()
        np.testing.assert_array_equal(np.any(ours.numpy()[k] != ref[k], axis=-1) & ~differs, False)
        if h >= 256:
            assert 1.0 - differs.mean() >= 0.995
    # float32 frames of the same integers give the same picks.
    assert torch.equal(thalf.halftone_dither_batch(
        *_t(frames.astype(np.float32), pal, screen, cell_idx), n_cells), ours)


def test_halftone_batch_equals_single_frames():
    frames = _frames(3, 37, 53)
    pal = np.asarray(tpal.median_cut_palette(frames[0], 8), np.float32)
    screen, cell_idx, n_cells = thalf.halftone_screen(37, 53)
    args = _t(pal, screen, cell_idx)
    batch = thalf.halftone_dither_batch(torch.from_numpy(frames), *args, n_cells)
    for k in range(3):
        one = thalf.halftone_dither_batch(torch.from_numpy(frames[k:k + 1]), *args, n_cells)
        assert torch.equal(one[0], batch[k])


def test_halftone_search_chunks_change_nothing(monkeypatch):
    frames = _frames(2, 40, 56)
    pal = np.asarray(tpal.median_cut_palette(frames[0], 16), np.float32)
    screen, cell_idx, n_cells = thalf.halftone_screen(40, 56, cell_size=4)
    args = _t(frames, pal, screen, cell_idx)
    whole = thalf.halftone_dither_batch(*args, n_cells)
    monkeypatch.setattr(thalf, "SEARCH_CHUNK_ENTRIES", 16 * 7)  # 7 cells a chunk
    assert torch.equal(thalf.halftone_dither_batch(*args, n_cells), whole)
    monkeypatch.setattr(thalf, "SEARCH_CHUNK_ENTRIES", 1)  # one cell a chunk
    assert torch.equal(thalf.halftone_dither_batch(*args, n_cells), whole)


def test_halftone_ties_go_to_the_first_colour():
    """Duplicate colours: a cell takes the lower index, and the paper is the
    first of the brightest colours (the JAX package's argmin / argmax)."""
    pal = np.array([[10, 10, 10], [250, 250, 250], [10, 10, 10], [250, 250, 250]], np.float32)
    frames = np.full((1, 16, 16, 3), 12, np.uint8)
    frames[0, :, 8:] = 240
    screen, cell_idx, n_cells = thalf.halftone_screen(16, 16, cell_size=8, angle=0.0)
    idx = thalf.halftone_dither_batch_indices(*_t(frames, pal, screen, cell_idx), n_cells).numpy()
    assert set(np.unique(idx)) <= {0, 1}
    assert (idx[0, :, :8] == 0).any() and (idx[0, :, 8:] == 1).all()
    ref = np.asarray(jhalf.halftone_dither_batch_indices(
        jnp.asarray(frames, jnp.float32), jnp.asarray(pal), jnp.asarray(screen),
        jnp.asarray(cell_idx), n_cells))
    np.testing.assert_array_equal(idx, ref)


def test_halftone_refuses_what_it_does_not_take():
    frames = _frames(1, 8, 8)
    pal = np.zeros((300, 3), np.float32)
    screen, cell_idx, n_cells = thalf.halftone_screen(8, 8)
    ti, tp, ts, tc = _t(frames, pal, screen, cell_idx)
    with pytest.raises(ValueError, match="256"):
        thalf.halftone_dither_batch_indices(ti, tp, ts, tc, n_cells)
    assert thalf.halftone_dither_batch(ti, tp, ts, tc, n_cells).shape == ti.shape
    with pytest.raises(ValueError, match="screen"):
        thalf.halftone_dither_batch(ti, tp, ts[:, :4], tc, n_cells)
    with pytest.raises(ValueError, match="cell_idx"):
        thalf.halftone_dither_batch(ti, tp, ts, tc.float(), n_cells)
    with pytest.raises(ValueError, match="palette"):
        thalf.halftone_dither_batch(ti, tp.double(), ts, tc, n_cells)
    with pytest.raises(TypeError):
        thalf.halftone_dither_batch(ti.to(torch.int32), tp, ts, tc, n_cells)


# ---------------------------------------------------------------------------
# The facade
# ---------------------------------------------------------------------------


def _pair(params, use_gamma, palette):
    kw = dict(num_colors=len(palette), palette=palette, use_gamma=use_gamma,
              dither_params=dict(params))
    return (jdpt.ImageDitherer(dither_mode=jdpt.DitherMode.HALFTONE, **kw),
            tdpt.ImageDitherer(dither_mode=tdpt.DitherMode.HALFTONE, device="cpu", **kw))


@pytest.mark.parametrize("use_gamma", [False, True], ids=["srgb", "gamma"])
@pytest.mark.parametrize("shape", FACADE_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("params", FACADE_PARAMS, ids=["default", "diamond", "square"])
def test_halftone_facade_vs_jax(params, shape, use_gamma, monkeypatch):
    """apply_dithering_batch and apply_dithering against the JAX facade
    (every difference explained, identity >= 0.995 at 256x256), and inside
    the port the batch against its frames one by one, exactly."""
    monkeypatch.setenv("DITHER_PIE_TPU_INDEX_TRANSFER", "0")
    h, w = shape
    frames = _frames(2, h, w)
    palette = tpal.median_cut_palette(frames[0], 16)
    jd, td = _pair(params, use_gamma, palette)
    out = td.apply_dithering_batch(frames)
    assert out.dtype == np.uint8 and out.shape == frames.shape
    ref = jd.apply_dithering_batch(frames)
    work = frames
    if use_gamma:  # the frames the strategies see: 8-bit linear
        lin = tdpt.DitherUtils.srgb_to_linear(frames.astype(np.float32) / 255.0)
        work = np.clip(lin * 255.0, 0, 255).astype(np.uint8)
    strategy = td._get_dither_strategy(td.dither_mode)
    screen, cell_idx, n_cells = thalf.halftone_screen(h, w, **strategy.get_current_parameters())
    pal = td._palette_for_dither()
    for k in range(2):
        differs = np.any(out[k] != ref[k], axis=-1)
        assert _explained(work[k], pal, screen, cell_idx, n_cells, differs).all()
        if h >= 256:
            assert 1.0 - differs.mean() >= 0.995
        single = np.asarray(td.apply_dithering(Image.fromarray(frames[k])))
        np.testing.assert_array_equal(single, out[k])
    single_ref = np.asarray(jd.apply_dithering(Image.fromarray(frames[0])))
    differs = np.any(out[0] != single_ref, axis=-1)
    assert _explained(work[0], pal, screen, cell_idx, n_cells, differs).all()


@pytest.mark.parametrize("use_gamma", [False, True], ids=["srgb", "gamma"])
@pytest.mark.parametrize("p", [2, 16, 256])
def test_halftone_indices_equal_colours(p, use_gamma, monkeypatch):
    frames = _frames(2, 22, 30)
    rng = np.random.RandomState(p)
    palette = [tuple(int(v) for v in c)
               for c in np.unique(rng.randint(0, 256, (8 * p + 64, 3)), axis=0)[:p]]
    d = tdpt.ImageDitherer(num_colors=p, dither_mode=tdpt.DitherMode.HALFTONE, palette=palette,
                           use_gamma=use_gamma, dither_params={"cell_size": 4}, device="cpu")
    strategy = d._get_dither_strategy(d.dither_mode)
    pal = d._palette_for_dither()
    idx = strategy.dither_batch_indices(frames, pal)
    assert idx.dtype == np.uint8 and idx.shape == frames.shape[:3]
    np.testing.assert_array_equal(pal.astype(np.uint8)[idx], strategy.dither_batch(frames, pal))
    monkeypatch.setenv("DITHER_PIE_TPU_INDEX_TRANSFER", "0")
    rgb = d.apply_dithering_batch(frames)
    monkeypatch.setenv("DITHER_PIE_TPU_INDEX_TRANSFER", "1")
    np.testing.assert_array_equal(d.apply_dithering_batch(frames), rgb)


def test_halftone_has_no_planar_and_no_wide_index_output():
    frames = _frames(1, 12, 16)
    strategy = tdpt.HalftoneDitherStrategy(device="cpu")
    jstrategy = jdpt.HalftoneDitherStrategy()
    assert strategy.get_current_parameters() == jstrategy.get_current_parameters()
    wide = np.random.RandomState(0).randint(0, 256, (257, 3)).astype(np.float32)
    for planar, pal in ((True, wide[:16]), (False, wide)):
        assert strategy.dither_batch_indices(frames, pal, planar=planar) is None
        assert jstrategy.dither_batch_indices(frames, pal, planar=planar) is None
    assert not hasattr(strategy, "dither_batch_planar")
    d = tdpt.ImageDitherer(dither_mode=tdpt.DitherMode.HALFTONE, palette=[(0, 0, 0), (9, 9, 9)],
                           device="cpu")
    assert not d.supports_planar_batch()
    out = strategy.dither_batch(frames, wide)
    assert out.dtype == np.uint8 and out.shape == frames.shape

"""The port's GUI view-model (``dither_pie_tpu_torch.gui.viewmodel``,
``device="cpu"``) side by side with the JAX package's
(``dither_pie_tpu.gui.viewmodel``), on one seeded image, through the flow of
``tests/test_gui_viewmodel.py``:

* load, then regular pixelize: bitwise, cached alike;
* ``palette_options``: equal labels; Median Cut, Uniform and every builtin
  palette exactly equal; K-means equal under ``DITHER_PIE_TPU_KMEANS=sklearn``
  (the torch k-means fit is not the JAX package's; both then take sklearn's);
* previews in every ordered mode and on the host engine (serpentine,
  Riemersma): bitwise against the JAX view-model's (an ordered mode on the
  gamma path only up to near ties at the screen, where the JAX package's
  CPU distances round, ROADMAP C17); the row-major
  error-diffusion modes: identity 1.0 against the golden engine (the JAX
  package's batch path pinned to its f32 twin), with the JAX preview as a
  perceptual witness at >= 0.98 (XLA:CPU contracts multiply-adds, ROADMAP
  C2); wavelet at the identity of ``tests/test_torch_wavelet.py``, halftone
  with every differing pixel explained as in ``tests/test_torch_halftone.py``;
* neural pixelize at random weights (``load_random(0)`` in both packages):
  within one u8 step of the JAX package's;
* the LRU bound and supersession, adopt, save xN, toggle, persist: equal;
* ``video_apply_args``: the same validation errors and the same tuple;
* ``load_video``, ``random_video_frame`` and ``apply_to_video`` with the
  ffmpeg IO faked: every written frame is ``apply_dithering`` of its frame;
* ``device="cuda"`` without a card raises (view-model, app, ``launch_gui``);
  importing the view-model loads neither tkinter nor jax.
"""

import json
import random
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
from dither_pie_tpu.api.config_manager import ConfigManager as JConfig
from dither_pie_tpu.gui.viewmodel import AppViewModel as JAppViewModel
from dither_pie_tpu.models import inference as jinf
from dither_pie_tpu.models.pixelizer import NeuralPixelizer as JNeuralPixelizer
from dither_pie_tpu.pipeline import pixelize as jpix
from dither_pie_tpu_torch.api.config_manager import ConfigManager as TConfig
from dither_pie_tpu_torch.gui import viewmodel as tvm
from dither_pie_tpu_torch.gui.viewmodel import AppViewModel as TAppViewModel
from dither_pie_tpu_torch.models import inference as tinf
from dither_pie_tpu_torch.models.pixelizer import NeuralPixelizer
from dither_pie_tpu_torch.ops import halftone as thalf
from dither_pie_tpu_torch.pipeline import pixelize as tpix
from test_torch_halftone import _explained
from test_torch_multihost import RecordingWriter, fake_io
from test_torch_wavelet import FACADE_IDENTITY
import torch_workers  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
H, W = 48, 64


@pytest.fixture
def vms(tmp_path, monkeypatch):
    """(port, JAX) view-models with configs of their own under tmp_path,
    the working directory (palette.json lands there); the RGB path; the JAX
    package's batches on the golden engine."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DITHER_PIE_TPU_INDEX_TRANSFER", "0")
    monkeypatch.setenv("DITHER_PIE_TPU_ED_BACKEND", "native")
    monkeypatch.delenv("DITHER_PIE_TPU_KMEANS", raising=False)
    return (TAppViewModel(TConfig(str(tmp_path / "port.json")), device="cpu"),
            JAppViewModel(JConfig(str(tmp_path / "jax.json"))))


@pytest.fixture
def image_path(tmp_path):
    p = tmp_path / "in.png"
    Image.fromarray(bench.synth_image(H, W, 7)).save(p)
    return str(p)


def _both(vms, fn):
    return fn(vms[0]), fn(vms[1])


def _arr(img):
    return np.asarray(img)


def _identity(a, b):
    return float(np.all(a == b, axis=-1).mean())


def test_load_and_regular_pixelize_bitwise(vms, image_path):
    ours, theirs = _both(vms, lambda vm: vm.load_image(image_path))
    np.testing.assert_array_equal(_arr(ours), _arr(theirs))
    for vm in vms:
        assert vm.display_state == "current" and vm.active_source() is vm.current_image
        vm.pixelize_max_size = 16
    assert vms[0]._pixelize_key("regular", 16) == vms[1]._pixelize_key("regular", 16)
    ours, theirs = _both(vms, lambda vm: vm.pixelize("regular"))
    assert ours.size == theirs.size and min(ours.size) <= 17
    np.testing.assert_array_equal(_arr(ours), _arr(theirs))
    for vm, pix in zip(vms, (ours, theirs)):
        assert vm.display_state == "pixelized" and vm.active_source() is pix
        assert vm.pixelize("regular") is pix and vm.cached_pixelize("regular") is pix
        assert vm.cached_pixelize("neural") is None
        with pytest.raises(ValueError, match="unknown pixelize method"):
            vm.pixelize("bicubic")


@pytest.mark.parametrize("kmeans", ["sklearn", "port"])
@pytest.mark.parametrize("source", ["current", "pixelized"])
@pytest.mark.parametrize("num_colors", [2, 8, 16])
def test_palette_options_equal_jax(vms, image_path, monkeypatch, num_colors, source, kmeans):
    if kmeans == "sklearn":
        monkeypatch.setenv("DITHER_PIE_TPU_KMEANS", "sklearn")
    for vm in vms:
        vm.load_image(image_path)
        vm.num_colors = num_colors
        if source == "pixelized":
            vm.pixelize("regular", 24)
    ours, theirs = _both(vms, lambda vm: vm.palette_options(vm.active_source()))
    assert [label for label, _ in ours] == [label for label, _ in theirs]
    assert [label for label, _ in ours[:3]] == ["Median Cut", "K-means", "Uniform"]
    assert len(ours) > 20  # the builtin palettes ride along
    for (label, a), (_, b) in zip(ours, theirs):
        if label == "K-means" and kmeans == "port":
            # The torch fit: num_colors distinct in-range colours of its own.
            assert len(a) == num_colors and len(set(a)) == num_colors
            assert all(0 <= v <= 255 for c in a for v in c)
            continue
        assert [tuple(c) for c in a] == [tuple(c) for c in b], label


ORDERED_CASES = [
    ("none", {}), ("bayer", {}), ("bayer", {"size": "8x8"}), ("bayer", {"size": "psx4x4"}),
    ("blue_noise", {"size": "32", "seed": "7"}), ("IGN", {}), ("IGN", {"scale": "2.5", "seed": "3"}),
    ("polka_dot", {}), ("polka_dot", {"tile_size": "5", "gamma": "2.0"}),
]
HOST_CASES = [
    ("riemersma", {}), ("error_diffusion", {"variant": "floyd_steinberg", "serpentine": "true"}),
    ("ostromoukhov", {"serpentine": "true"}),
]
ED_CASES = [
    ("error_diffusion", {}), ("error_diffusion", {"variant": "floyd_steinberg"}),
    ("error_diffusion", {"variant": "stucki"}), ("ostromoukhov", {}),
    ("hybrid", {"lum_factor": "0.8", "col_factor": "0.35"}), ("perceptual", {}),
    ("adaptive_variance", {"var_threshold": "250", "window_radius": "2"}),
]


def _ids(cases):
    return [f"{m}-{'-'.join(map(str, p.values())) or 'default'}" for m, p in cases]


def _setup(vms, image_path, mode, params, use_gamma, source):
    for vm in vms:
        vm.load_image(image_path)
        vm.mode, vm.use_gamma = mode, use_gamma
        vm.dither_parameters[mode] = dict(params)
        if source == "pixelized":
            vm.pixelize("regular", 24)
    assert vms[0].params_for_mode() == vms[1].params_for_mode()
    src = vms[0].active_source()
    colors = tdpt.ColorReducer.reduce_colors(src, 8)
    assert colors == jdpt.ColorReducer.reduce_colors(vms[1].active_source(), 8)
    assert (vms[0].preview_cache_key("Median Cut", colors)
            == vms[1].preview_cache_key("Median Cut", colors))
    return colors, src


def _screen_ties(vm, colors, src, ours, theirs):
    """True where the two previews of an ordered mode on the gamma path
    differ only by a near tie at the screen. The gamma path's palette is not
    integer-valued, and the JAX package's CPU path takes squared distances
    as |x|^2 - 2 x.p + |p|^2 in float32 (``core/distance.py``), exact only
    for integer palettes; the port (and the JAX Pallas kernel) subtract
    first. So the float64 factor d1 / (d1 + d2) must lie within that form's
    rounding of the screen, and both outputs must be the pixel's two
    nearest colours."""
    d = vm.build_ditherer(list(colors), len(colors))
    lin = tdpt.DitherUtils.srgb_to_linear(_arr(src).astype(np.float32) / 255.0)
    work = np.clip(lin * 255.0, 0, 255).astype(np.uint8).reshape(-1, 3).astype(np.float64)
    pal = np.clip(tdpt.DitherUtils.srgb_to_linear(np.asarray(colors, np.float32) / 255.0)
                  * 255.0, 0, 255).astype(np.float32)
    out_lin = np.floor(pal).astype(np.float32) / 255.0
    shown = np.clip(tdpt.DitherUtils.linear_to_srgb(out_lin) * 255.0, 0, 255).astype(np.uint8)
    screen = d._get_dither_strategy(d.dither_mode)._screen(*_arr(src).shape[:2]).numpy()
    differs = np.flatnonzero(np.any(ours != theirs, axis=-1).reshape(-1))
    for i in differs:
        dist = ((work[i] - pal.astype(np.float64)) ** 2).sum(-1)
        i1, i2 = np.argsort(dist, kind="stable")[:2]
        factor = dist[i1] / (dist[i1] + dist[i2])
        tol = 16 * np.finfo(np.float32).eps * (work[i] @ work[i] + (pal.astype(np.float64) ** 2
                                                                   ).sum(-1).max())
        pair = {tuple(shown[i1]), tuple(shown[i2])}
        if not (abs(factor - screen.reshape(-1)[i]) * (dist[i1] + dist[i2]) <= tol
                and {tuple(ours.reshape(-1, 3)[i]), tuple(theirs.reshape(-1, 3)[i])} <= pair):
            return False
    return True


@pytest.mark.parametrize("source", ["current", "pixelized"])
@pytest.mark.parametrize("use_gamma", [False, True], ids=["srgb", "gamma"])
@pytest.mark.parametrize("mode,params", ORDERED_CASES + HOST_CASES,
                         ids=_ids(ORDERED_CASES + HOST_CASES))
def test_preview_bitwise_jax(vms, image_path, mode, params, use_gamma, source):
    """The ordered family (K4's plain version) and the host engine's modes:
    the JAX view-model's preview, bit for bit; on the gamma path an ordered
    mode may differ from the JAX package's CPU path only at near ties at
    the screen (``_screen_ties``, ROADMAP C17)."""
    colors, src = _setup(vms, image_path, mode, params, use_gamma, source)
    ours = _arr(vms[0].render_preview("Median Cut", colors, src))
    theirs = _arr(vms[1].render_preview("Median Cut", colors, vms[1].active_source()))
    assert ours.shape == (src.size[1], src.size[0], 3) and ours.dtype == np.uint8
    if use_gamma and (mode, params) in ORDERED_CASES:
        assert np.any(ours != theirs, axis=-1).mean() <= 0.001
        assert _screen_ties(vms[0], colors, src, ours, theirs)
    else:
        np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("source", ["current", "pixelized"])
@pytest.mark.parametrize("use_gamma", [False, True], ids=["srgb", "gamma"])
@pytest.mark.parametrize("mode,params", ED_CASES, ids=_ids(ED_CASES))
def test_ed_preview_golden_identity(vms, image_path, mode, params, use_gamma, source):
    """Row-major error diffusion: identity 1.0 with the golden engine's f32
    twin of the mode (the JAX package's one-frame batch on its native
    engine), and the JAX preview a perceptual witness."""
    colors, src = _setup(vms, image_path, mode, params, use_gamma, source)
    ours = _arr(vms[0].render_preview("Median Cut", colors, src))
    golden = vms[1].build_ditherer(list(colors), len(colors)).apply_dithering_batch(
        _arr(src)[None])[0]
    assert _identity(ours, golden) == 1.0
    witness = _arr(vms[1].render_preview("Median Cut", colors, vms[1].active_source()))
    assert _identity(ours, witness) >= 0.98


@pytest.mark.parametrize("use_gamma", [False, True], ids=["srgb", "gamma"])
@pytest.mark.parametrize("params", [{}, {"wavelet": "db4", "subband_quant": "16", "seed": "7"}],
                         ids=["haar", "db4"])
def test_wavelet_preview_vs_jax(vms, image_path, params, use_gamma):
    colors, src = _setup(vms, image_path, "wavelet", params, use_gamma, "current")
    ours = _arr(vms[0].render_preview("Median Cut", colors, src))
    theirs = _arr(vms[1].render_preview("Median Cut", colors, src))
    assert _identity(ours, theirs) >= FACADE_IDENTITY
    d = vms[0].build_ditherer(list(colors), len(colors))
    np.testing.assert_array_equal(ours, d.apply_dithering_batch(_arr(src)[None])[0])


@pytest.mark.parametrize("params", [{}, {"cell_size": "6", "angle": "30", "shape": "diamond"}],
                         ids=["default", "diamond"])
def test_halftone_preview_vs_jax(vms, image_path, params):
    colors, src = _setup(vms, image_path, "halftone", params, False, "current")
    ours = _arr(vms[0].render_preview("Median Cut", colors, src))
    theirs = _arr(vms[1].render_preview("Median Cut", colors, src))
    d = vms[0].build_ditherer(list(colors), len(colors))
    strategy = d._get_dither_strategy(d.dither_mode)
    screen, cell_idx, n_cells = thalf.halftone_screen(H, W, **strategy.get_current_parameters())
    differs = np.any(ours != theirs, axis=-1)
    assert _explained(_arr(src), d._palette_for_dither(), screen, cell_idx, n_cells,
                      differs).all()


@pytest.fixture(scope="module")
def models():
    model = tinf.PixelizationModel(device="cpu")
    model.load_random(0)
    jmodel = jinf.PixelizationModel()
    jmodel.load_random(0)
    return model, jmodel


@pytest.fixture
def neural(monkeypatch, models):
    """Both packages' pixelizers over load_random(0), float32, gates unset."""
    monkeypatch.setenv("DITHER_PIE_TPU_NEURAL_PRECISION", "float32")
    for name in ("U8_IN", "DS4", "DS4_STRIDE"):
        monkeypatch.delenv(f"DITHER_PIE_TPU_NEURAL_{name}", raising=False)
    model, jmodel = models
    model._video_prec = model._ds4_stride = None
    jmodel._video_prec = jmodel._ds4_stride = None
    monkeypatch.setattr(tpix, "_neural_singletons", {})
    tpix.install_neural_pixelizer(NeuralPixelizer.from_model(model))
    jp = JNeuralPixelizer.__new__(JNeuralPixelizer)
    jp._model = jmodel
    monkeypatch.setattr(jpix, "_neural_singleton", jp)


@pytest.mark.parametrize("max_size", [12, 16])
def test_neural_pixelize_within_one_step(vms, image_path, neural, max_size):
    for vm in vms:
        vm.load_image(image_path)
    ours, theirs = _both(vms, lambda vm: vm.pixelize("neural", max_size))
    assert ours.size == theirs.size and min(ours.size) == max_size
    a, b = _arr(ours).astype(np.int16), _arr(theirs).astype(np.int16)
    assert np.abs(a - b).max() <= 1
    assert vms[0].cached_pixelize("neural", max_size) is ours
    assert vms[0].pixelize("regular", max_size) is not ours  # a key of its own
    # A HYBRID preview of the port's pixelization holds to the golden engine.
    vm = vms[0]
    vm.set_pixelized(ours)
    vm.mode = "hybrid"
    colors = tdpt.ColorReducer.reduce_colors(ours, 8)
    preview = _arr(vm.render_preview("Median Cut", colors, ours))
    golden = jdpt.ImageDitherer(num_colors=8, dither_mode=jdpt.DitherMode.HYBRID,
                                palette=colors).apply_dithering_batch(_arr(ours)[None])[0]
    assert _identity(preview, golden) == 1.0


def test_lru_bound_and_supersession_equal(vms, image_path):
    for vm in vms:
        vm.load_image(image_path)
    small = vms[0].current_image.resize((16, 12))
    log = []
    for vm in vms:
        got = []
        for i in range(35):
            got.append(vm.commit_preview(vm.begin_preview(), f"k{i}", small))
        got.append(vm.get_cached_preview("k7") is small)  # moved to the end
        got.append(vm.get_cached_preview("k0") is None)  # evicted
        stale = vm.begin_preview()
        vm.begin_preview()
        got.append(vm.commit_preview(stale, "late", small))
        got.append(vm.commit_preview(vm.begin_preview(), "k40", small))
        log.append((got, list(vm._preview_cache)))
    assert log[0] == log[1]
    assert len(log[0][1]) == tvm.PREVIEW_CACHE_SIZE == 30
    assert log[0][1][-2:] == ["k7", "k40"] and "late" not in log[0][1]


@pytest.mark.parametrize("mult", [1, 2, 3])
def test_adopt_save_toggle_persist_equal(vms, image_path, tmp_path, mult):
    pal = [(0, 0, 0), (255, 255, 255), (200, 40, 40), (30, 90, 200)]
    results = []
    for k, vm in enumerate(vms):
        vm.load_image(image_path)
        vm.mode, vm.num_colors = "bayer", 4
        vm.pixelize("regular", 24)
        preview = vm.render_preview("mine", pal, vm.active_source())
        vm.adopt_preview(pal, preview)
        assert vm.display_state == "dithered" and vm.dithered_image is preview
        assert vm.last_palette == pal and vm.last_gamma is False
        vm.final_resize_multiplier = mult
        out = tmp_path / f"out{k}.png"
        assert vm.save_result(str(out))
        toggles = [vm.toggle_state()[0] for _ in range(4)]
        vm.persist_settings()
        results.append((np.asarray(Image.open(out)), vm.result_size_note(), toggles,
                        json.loads(Path(vm.config.config_file).read_text())))
    (a, note_a, tog_a, cfg_a), (b, note_b, tog_b, cfg_b) = results
    assert a.shape == (24 * mult, 32 * mult, 3)
    np.testing.assert_array_equal(a, b)
    assert note_a == note_b == f"result: {32 * mult}x{24 * mult}"
    assert tog_a == tog_b == ["current", "pixelized", "dithered", "current"]
    assert cfg_a == cfg_b and cfg_a["defaults"]["num_colors"] == 4
    assert cfg_a["defaults"]["final_resize_multiplier"] == mult
    for vm in vms:
        vm.set_pixelized(vm.current_image.resize((8, 8)))
        assert vm.dithered_image is None and vm.display_state == "pixelized"


def test_empty_state_equal(vms, tmp_path):
    for vm in vms:
        assert vm.toggle_state() is None and vm.result_image() is None
        assert vm.result_size_note() == "" and not vm.save_result(str(tmp_path / "x.png"))
        assert vm.cached_pixelize("regular") is None
        with pytest.raises(ValueError, match="No image open"):
            vm.pixelize("regular")


def test_save_palette_and_lospec_equal(vms, tmp_path, monkeypatch):
    import types

    data = {"name": "PICO-8", "colors": ["000000", "1d2b53", "FFF1E8"]}
    resp = types.SimpleNamespace(raise_for_status=lambda: None, json=lambda: data)
    monkeypatch.setitem(sys.modules, "requests",
                        types.SimpleNamespace(get=lambda url, timeout: resp))
    files = []
    for k, vm in enumerate(vms):
        d = tmp_path / f"pal{k}"
        d.mkdir()
        monkeypatch.chdir(d)
        vm.save_palette("mine", [(1, 2, 3), "#a1b2c3", (255, 0, 16)])
        assert vm.import_lospec("https://lospec.com/palette-list/pico-8") == {
            "name": "PICO-8", "colors": ["#000000", "#1d2b53", "#fff1e8"]}
        Image.fromarray(bench.synth_image(20, 24, 3)).save(d / "p.png")
        monkeypatch.setenv("DITHER_PIE_TPU_KMEANS", "sklearn")
        files.append((json.loads((d / "palette.json").read_text()),
                      vm.kmeans_palette_from_image(str(d / "p.png"))))
    assert files[0] == files[1]
    names = [p["name"] for p in files[0][0]]
    assert names[-2:] == ["mine", "PICO-8"]


def _video_args(vm):
    try:
        d, pix, mult = vm.video_apply_args("out.mp4")
    except ValueError as e:
        return str(e)
    return (d.palette, d.num_colors, d.dither_mode.value, d.dither_params, d.use_gamma, pix, mult)


@pytest.mark.parametrize("pixelize", [None, "regular", "neural"])
@pytest.mark.parametrize("mult", [1, 3])
def test_video_apply_args_equal(vms, image_path, neural, pixelize, mult):
    pal = [(0, 0, 0), (255, 255, 255)]
    for vm in vms:
        vm.load_image(image_path)
    assert _both(vms, _video_args) == ("No video open",) * 2
    for vm in vms:
        vm.video_path = "fake.mp4"
    first = _both(vms, _video_args)
    assert first[0] == first[1] and "palette" in first[0]
    for vm in vms:
        vm.mode, vm.pixelize_max_size, vm.final_resize_multiplier = "error_diffusion", 12, mult
        vm.dither_parameters["error_diffusion"] = {"variant": "stucki"}
        if pixelize:
            vm.pixelize(pixelize)
        vm.adopt_preview(pal, vm.active_source())
    ours, theirs = _both(vms, _video_args)
    assert ours == theirs
    # After a neural pixelize too, the video is pixelized "regular" (C16).
    assert ours[-2:] == ((("regular", 12) if pixelize else None), (mult if mult > 1 else None))
    assert vms[0].video_apply_args("out.mp4")[0].device == torch.device("cpu")


VIDEO_CASES = [("bayer", {"size": "8x8"}, None, 1), ("error_diffusion",
               {"variant": "floyd_steinberg"}, 16, 2), ("ostromoukhov", {}, 16, 3)]


@pytest.mark.parametrize("mode,params,max_size,mult", VIDEO_CASES,
                         ids=[c[0] for c in VIDEO_CASES])
def test_video_flow_with_fake_io(vms, monkeypatch, tmp_path, mode, params, max_size, mult):
    frames = [bench.synth_image(24, 32, 40 + i) for i in range(5)]
    fake_io(monkeypatch, frames)
    vm = vms[0]
    img = vm.load_video("in.mp4")
    np.testing.assert_array_equal(_arr(img), frames[0])
    assert vm.video_path == "in.mp4" and vm.display_state == "current"
    img, idx, n = vm.random_video_frame(3)
    assert (idx, n) == (3, 5)
    np.testing.assert_array_equal(_arr(img), frames[3])
    random.seed(0)
    img, idx, n = vm.random_video_frame()
    assert 0 <= idx < 5
    np.testing.assert_array_equal(_arr(img), frames[idx])
    vm.mode, vm.final_resize_multiplier = mode, mult
    vm.dither_parameters[mode] = dict(params)
    if max_size:
        vm.pixelize("regular", max_size)
        vm.pixelize_max_size = max_size
    pal = tdpt.ColorReducer.reduce_colors(vm.active_source(), 8)
    vm.adopt_preview(pal, vm.render_preview("Median Cut", pal, vm.active_source()))
    progress = []
    out = str(tmp_path / "out.mp4")
    assert vm.apply_to_video(out, progress_callback=lambda f, m: progress.append(f))
    written = RecordingWriter.written[out]
    assert len(written) == len(frames) and progress
    d = vm.build_ditherer(list(pal), len(pal))
    for i, (frame, got) in enumerate(zip(frames, written)):
        src = Image.fromarray(frame)
        if max_size:
            src = tpix.pixelize_regular(src, max_size)
        want = _arr(d.apply_dithering(src))
        want = np.repeat(np.repeat(want, mult, axis=0), mult, axis=1)
        np.testing.assert_array_equal(got, want, err_msg=f"frame {i}")


def test_video_needs_an_open_video(vms):
    for vm in vms:
        with pytest.raises(ValueError, match="No video open"):
            vm.random_video_frame()
        with pytest.raises(ValueError, match="No video open"):
            vm.apply_to_video("out.mp4")


def test_cuda_without_a_card_raises(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the check is for machines without")
    from dither_pie_tpu_torch.gui import app

    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        TAppViewModel()
    with pytest.raises(RuntimeError, match="cuda"):
        TAppViewModel(TConfig(str(tmp_path / "c.json")), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        app.DitheringApp()  # raised before any window is built
    with pytest.raises(SystemExit) as e:
        app.launch_gui()
    assert "python -m dither_pie_tpu_torch <config.json>" in str(e.value.code)
    assert not (tmp_path / "config.json").exists()  # nothing ran on the CPU
    assert TAppViewModel(device="cpu").device == torch.device("cpu")


def test_viewmodel_import_loads_no_tkinter_and_no_jax():
    code = ("import sys, dither_pie_tpu_torch.gui.viewmodel, dither_pie_tpu_torch.gui.logic; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('tkinter', '_tkinter', 'jax', "
            "'dither_pie_tpu')]; assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr

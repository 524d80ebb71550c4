"""The neural pixelizer in the port's pipelines, on the CPU.

* ``process_frames(..., pixelize_func=("neural", n))`` on a CPU ditherer ==
  ``pixelize_batch`` then ``apply_dithering_batch`` in the same batches
  (overlap on and off; a batch of one goes through ``pixelize``), and its
  pixelized frames are the JAX package's within one uint8 step, same
  weights (the dithered frames are not compared: error diffusion carries a
  one-step difference on through the frame);
* ``process_single_image`` with ``method: neural`` runs, and its
  pixelization is the JAX package's within one step;
* the pixelizer is one a device, and the default device is the card: on a
  machine without one, asking raises instead of using the CPU.
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

import bench
import dither_pie_tpu as jdpt
import dither_pie_tpu_torch as tdpt
from dither_pie_tpu.models import inference as jinf
from dither_pie_tpu.models.pixelizer import NeuralPixelizer as JNeuralPixelizer
from dither_pie_tpu.pipeline import image as jimage
from dither_pie_tpu.pipeline import pixelize as jpix
from dither_pie_tpu.pipeline import video as jvideo
from dither_pie_tpu_torch.api import config as tconfig
from dither_pie_tpu_torch.api import profiling as tprof
from dither_pie_tpu_torch.models import inference as tinf
from dither_pie_tpu_torch.models.pixelizer import NeuralPixelizer
from dither_pie_tpu_torch.pipeline import image as timage
from dither_pie_tpu_torch.pipeline import pixelize as tpix
from dither_pie_tpu_torch.pipeline import video as tvideo

PAL = [(0, 0, 0), (250, 250, 250), (200, 40, 40), (30, 90, 200), (240, 200, 60)]
MAX_SIZE = 16


@pytest.fixture(scope="module")
def model():
    m = tinf.PixelizationModel(device="cpu")
    m.load_random(0)
    return m


@pytest.fixture(scope="module")
def jmodel():
    m = jinf.PixelizationModel()
    m.load_random(0)
    return m


@pytest.fixture(autouse=True)
def pixelizers(monkeypatch, model, jmodel):
    """The port's CPU pixelizer and the JAX package's over load_random(0),
    installed as the process-wide ones (float32, gates unset)."""
    monkeypatch.setenv("DITHER_PIE_TPU_NEURAL_PRECISION", "float32")
    monkeypatch.setenv("DITHER_PIE_TPU_INDEX_TRANSFER", "0")
    for name in ("U8_IN", "DS4", "DS4_STRIDE"):
        monkeypatch.delenv(f"DITHER_PIE_TPU_NEURAL_{name}", raising=False)
    monkeypatch.setattr(tpix, "_neural_singletons", {})
    model._video_prec = model._ds4_stride = None
    jmodel._video_prec = jmodel._ds4_stride = None
    tpix.install_neural_pixelizer(NeuralPixelizer.from_model(model))
    jp = JNeuralPixelizer.__new__(JNeuralPixelizer)
    jp._model = jmodel
    monkeypatch.setattr(jpix, "_neural_singleton", jp)
    return tpix.get_neural_pixelizer(device="cpu"), jp


def _frames(n, h=40, w=56, seed=0):
    return [bench.synth_image(h, w, seed + i) for i in range(n)]


def _ours(mode="hybrid"):
    return tdpt.ImageDitherer(num_colors=len(PAL), dither_mode=tdpt.DitherMode(mode),
                              palette=list(PAL), device="cpu")


def _recording(d):
    """Wrap d.apply_dithering_batch: record the frames it is given."""
    seen, orig = [], d.apply_dithering_batch

    def spy(stacked, **kw):
        seen.extend(np.asarray(stacked))
        return orig(stacked, **kw)

    d.apply_dithering_batch = spy
    return seen


@pytest.mark.parametrize("overlap", [False, True], ids=["serial", "overlap"])
def test_process_frames_equals_pixelize_batch_then_dither(pixelizers, overlap):
    frames = _frames(6)
    d = _ours()
    got = list(tvideo.process_frames(iter(frames), d, pixelize_func=("neural", MAX_SIZE),
                                     batch_size=4, overlap=overlap))
    pix = pixelizers[0]
    want = []
    for i in (0, 4):  # batches of 4 and 2
        px = [np.asarray(o) for o in pix.pixelize_batch(
            [Image.fromarray(f) for f in frames[i:i + 4]], MAX_SIZE)]
        want.extend(_ours().apply_dithering_batch(np.stack(px)))
    assert len(got) == 6
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape == (MAX_SIZE, 22, 3) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b, err_msg=f"frame {i}")


def test_a_batch_of_one_goes_through_pixelize(pixelizers):
    frames = _frames(2, seed=5)
    d = _ours("bayer")
    seen = _recording(d)
    list(tvideo.process_frames(iter(frames), d, pixelize_func=("neural", MAX_SIZE),
                               batch_size=1, overlap=False))
    for f, px in zip(frames, seen):
        want = np.asarray(pixelizers[0].pixelize(Image.fromarray(f), MAX_SIZE))
        np.testing.assert_array_equal(px, want)


def test_pixelized_frames_equal_the_jax_package(pixelizers):
    frames = _frames(5, seed=10)
    ours_d, theirs_d = _ours(), jdpt.ImageDitherer(
        num_colors=len(PAL), dither_mode=jdpt.DitherMode.HYBRID, palette=list(PAL))
    ours, theirs = _recording(ours_d), _recording(theirs_d)
    out = list(tvideo.process_frames(iter(frames), ours_d, pixelize_func=("neural", MAX_SIZE),
                                     batch_size=3))
    list(jvideo.process_frames(iter(frames), theirs_d, pixelize_func=("neural", MAX_SIZE),
                               batch_size=3))
    # The JAX package pads its tail batch (2 frames) to the batch size.
    assert len(out) == len(ours) == 5 and len(theirs) == 6
    for i, (a, b) in enumerate(zip(ours, theirs[:5])):
        assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
        assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1, i
    # Both packages' gates ran on the first batch: float32 was asked for.
    assert pixelizers[0]._model._video_prec == pixelizers[1]._model._video_prec == "float32"


def test_stage_report_times_the_neural_pixelize(pixelizers):
    tprof.reset()
    list(tvideo.process_frames(iter(_frames(3, seed=20)), _ours("bayer"),
                               pixelize_func=("neural", MAX_SIZE), batch_size=3))
    report = tprof.stage_report()
    assert "video.pixelize" in report and "video.dither_batch" in report
    tprof.reset()


def _neural_config(tmp_path):
    rng = np.random.RandomState(3)
    Image.fromarray(rng.randint(0, 256, (40, 60, 3), dtype=np.uint8)).save(tmp_path / "in.png")
    raw = {"input": "in.png", "output": "out.png",
           "pixelization": {"enabled": True, "method": "neural", "max_size": 12},
           "dithering": {"enabled": True, "mode": "bayer", "parameters": {"size": "4x4"}},
           "palette": {"source": "median_cut", "num_colors": 8},
           "final_resize": {"enabled": True, "multiplier": 2}}
    path = tmp_path / "config.json"
    path.write_text(json.dumps(raw))
    return path


def test_process_single_image_neural_runs(tmp_path, pixelizers):
    path = _neural_config(tmp_path)
    ours = tconfig.load_config(path)
    assert timage.process_single_image(ours, device="cpu")
    out = np.asarray(Image.open(ours["output"]))
    assert out.shape == (24, 36, 3) and out.dtype == np.uint8
    assert len(np.unique(out.reshape(-1, 3), axis=0)) <= 8
    # The pixelization step against the JAX package's.
    img = Image.open(tmp_path / "in.png").convert("RGB")
    got = np.asarray(timage.apply_pixelization(img, ours["pixelization"], device="cpu"))
    want = np.asarray(jimage.apply_pixelization(img, ours["pixelization"]))
    assert got.shape == want.shape == (12, 18, 3)
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1


def test_one_pixelizer_a_device(pixelizers, model):
    pix = pixelizers[0]
    assert tpix.get_neural_pixelizer(device="cpu") is pix
    assert tpix.get_neural_pixelizer(device=torch.device("cpu")) is pix
    assert pix.device == torch.device("cpu") and pix._model is model


def test_the_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the check is for machines without")
    with pytest.raises(RuntimeError, match="cuda"):
        tpix.get_neural_pixelizer()
    with pytest.raises(RuntimeError, match="cuda"):
        timage.apply_pixelization(Image.fromarray(_frames(1)[0]),
                                  {"enabled": True, "method": "neural", "max_size": 8})
    with pytest.raises(RuntimeError, match="cuda"):
        NeuralPixelizer()
    # A ditherer on the card would take its pixelizer there too.
    with pytest.raises(RuntimeError, match="cuda"):
        tvideo._pixelize_frames(_frames(2), "neural", MAX_SIZE, "cuda")

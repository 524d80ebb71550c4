"""The port's pipelines (dither_pie_tpu_torch.pipeline: video, image,
resume; api.config and api.profiling) against the JAX package's, on the
CPU, bitwise.

* ``process_frames`` in the modes where the JAX package's CPU path is
  bitwise the port's (NONE, BAYER, serpentine Floyd-Steinberg, Riemersma)
  equals the JAX package's frame for frame, tail batches included; row-major
  error diffusion (where the JAX package's CPU path is only perceptually
  the port's) equals the golden engine's float32 twin through the JAX
  package's ``ed_host.ed_fixed_fast``;
* overlap == serial, a tail batch == full batches, planar == interleaved,
  final resize and regular pixelize == the JAX package's, retry and
  patching of failed frames;
* the neural pixelizer without its checkpoints raises, and what is not
  ported raises: multi-host sharding (A11); the entry points default to
  the card;
* the resume plan and manifest, the config validation and
  ``process_single_image``'s PNG equal the JAX package's;
* ``stage_report`` lists the pipeline's stages.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import bench
import dither_pie_tpu as jdpt
import dither_pie_tpu_torch as tdpt
from dither_pie_tpu.api import config as jconfig
from dither_pie_tpu.ops import ed_host as jhost
from dither_pie_tpu.pipeline import ffio as jffio
from dither_pie_tpu.pipeline import image as jimage
from dither_pie_tpu.pipeline import resume as jresume
from dither_pie_tpu.pipeline import video as jvideo
from dither_pie_tpu_torch.api import config as tconfig
from dither_pie_tpu_torch.api import profiling as tprof
from dither_pie_tpu_torch.pipeline import ffio as tffio
from dither_pie_tpu_torch.pipeline import image as timage
from dither_pie_tpu_torch.pipeline import resume as tresume
from dither_pie_tpu_torch.pipeline import video as tvideo

PAL = [(0, 0, 0), (250, 250, 250), (200, 40, 40), (30, 90, 200), (240, 200, 60)]

# Modes whose JAX CPU path is bitwise the port's.
BITWISE_MODES = [
    ("none", {}),
    ("bayer", {"size": "8x8"}),
    ("error_diffusion", {"variant": "floyd_steinberg", "serpentine": "true"}),
    ("riemersma", {}),
]


@pytest.fixture(autouse=True)
def rgb_path(monkeypatch):
    monkeypatch.setenv("DITHER_PIE_TPU_INDEX_TRANSFER", "0")
    monkeypatch.setenv("DITHER_PIE_TPU_ED_BACKEND", "native")


def _frames(n, h=24, w=40, seed=0):
    return [bench.synth_image(h, w, seed + i) for i in range(n)]


def _ours(mode, params, palette=PAL, **kw):
    return tdpt.ImageDitherer(num_colors=len(palette), dither_mode=tdpt.DitherMode(mode),
                              palette=list(palette), dither_params=dict(params),
                              device="cpu", **kw)


def _theirs(mode, params, palette=PAL, **kw):
    return jdpt.ImageDitherer(num_colors=len(palette), dither_mode=jdpt.DitherMode(mode),
                              palette=list(palette), dither_params=dict(params), **kw)


def _equal_lists(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype == np.uint8 and x.shape == y.shape, i
        np.testing.assert_array_equal(x, y, err_msg=f"frame {i}")


@pytest.mark.parametrize("use_gamma", [False, True], ids=["srgb", "gamma"])
@pytest.mark.parametrize("mode,params", BITWISE_MODES, ids=[m for m, _ in BITWISE_MODES])
def test_process_frames_equals_jax(mode, params, use_gamma):
    frames = _frames(11)
    want = list(jvideo.process_frames(iter(frames), _theirs(mode, params, use_gamma=use_gamma),
                                      batch_size=4))
    got = list(tvideo.process_frames(iter(frames), _ours(mode, params, use_gamma=use_gamma),
                                     batch_size=4))
    _equal_lists(got, want)


@pytest.mark.parametrize("variant", ["floyd_steinberg", "stucki"])
def test_process_frames_ed_equals_golden_engine(variant):
    """Row-major error diffusion: the wavefront path's plain version equals
    the golden engine's float32 twin on every frame."""
    frames = _frames(9, seed=20)
    got = list(tvideo.process_frames(iter(frames), _ours("error_diffusion",
                                                         {"variant": variant}),
                                     batch_size=4))
    pal = np.asarray(PAL, np.float32)
    want = [jhost.ed_fixed_fast(f.astype(np.float32), pal, variant).astype(np.uint8)
            for f in frames]
    _equal_lists(got, want)


@pytest.mark.parametrize("mode,params", BITWISE_MODES + [
    ("error_diffusion", {"variant": "stucki"}),
    ("ostromoukhov", {"serpentine": "true"})], ids=lambda v: str(v))
def test_overlap_equals_serial(mode, params):
    frames = _frames(10, seed=40)
    serial = list(tvideo.process_frames(iter(frames), _ours(mode, params), batch_size=3,
                                        overlap=False))
    overlapped = list(tvideo.process_frames(iter(frames), _ours(mode, params), batch_size=3,
                                            overlap=True))
    _equal_lists(overlapped, serial)


def test_tail_batch_equals_full_batches():
    """37 frames at batch 8 (a tail of 5, run at its own size) == the same
    frames in one batch, and == the ditherer's own batches."""
    frames = _frames(37, 16, 20, seed=60)
    d = _ours("error_diffusion", {"variant": "floyd_steinberg"})
    sizes = []
    orig = d.apply_dithering_batch

    def spy(stacked, **kw):
        sizes.append(len(stacked))
        return orig(stacked, **kw)

    d.apply_dithering_batch = spy
    got = list(tvideo.process_frames(iter(frames), d, batch_size=8, overlap=False))
    assert sizes == [8, 8, 8, 8, 5]  # no padding
    _equal_lists(got, list(orig(np.stack(frames))))


@pytest.mark.parametrize("overlap", [False, True])
def test_planar_equals_interleaved(overlap):
    frames = _frames(7, seed=80)
    d = _ours("error_diffusion", {"variant": "floyd_steinberg"})
    assert d.supports_planar_batch()
    planes = [np.ascontiguousarray(f.transpose(2, 0, 1)) for f in frames]
    got = list(tvideo.process_frames(iter(planes), d, batch_size=3, overlap=overlap,
                                     planar=True, final_resize_multiplier=3))
    want = list(tvideo.process_frames(iter(frames), d, batch_size=3, overlap=overlap,
                                      final_resize_multiplier=3))
    _equal_lists([np.ascontiguousarray(p.transpose(1, 2, 0)) for p in got], want)
    with pytest.raises(ValueError, match="pixelize"):
        next(tvideo.process_frames(iter(planes), d, planar=True,
                                   pixelize_func=("regular", 8)))


@pytest.mark.parametrize("multiplier", [2, 3])
@pytest.mark.parametrize("pixelize", [None, ("regular", 14)], ids=["none", "regular"])
def test_pixelize_and_final_resize_equal_jax(pixelize, multiplier):
    """Odd frame sizes, so the x3 resize pads to even dimensions."""
    frames = _frames(6, 23, 31, seed=100)
    kw = dict(batch_size=4, pixelize_func=pixelize, final_resize_multiplier=multiplier)
    want = list(jvideo.process_frames(iter(frames), _theirs("bayer", {"size": "4x4"}), **kw))
    got = list(tvideo.process_frames(iter(frames), _ours("bayer", {"size": "4x4"}), **kw))
    _equal_lists(got, want)
    assert got[0].shape[0] % 2 == 0 and got[0].shape[1] % 2 == 0
    im = Image.fromarray(frames[0])
    assert (tvideo.pixelize_regular(im, 9).tobytes()
            == jvideo.pixelize_regular(im, 9).tobytes())


@pytest.mark.parametrize("overlap", [False, True])
def test_failed_frames_are_retried_and_patched(monkeypatch, overlap):
    """A batch that fails is retried frame by frame; frames that fail again
    are patched with the nearest good frame, a leading one with the first
    good frame."""
    frames = _frames(8, seed=120)
    d = _ours("none", {})
    orig = d.apply_dithering_batch
    calls = []

    def flaky(stacked, **kw):
        calls.append(len(stacked))
        # Keyed on content, not call order: the overlap workers race.
        if any(np.array_equal(stacked[0], frames[i]) for i in (0, 4, 5)):
            raise RuntimeError("boom")
        return orig(stacked, **kw)

    monkeypatch.setattr(d, "apply_dithering_batch", flaky)
    outs = list(tvideo.process_frames(iter(frames), d, batch_size=2, retries=1,
                                      overlap=overlap))
    good = [orig(f[None])[0] for f in frames]
    assert len(outs) == 8
    # Frame 0 fails alone and is backfilled by frame 1; frames 4 and 5 fail
    # and take frame 3.
    for i, src in enumerate([1, 1, 2, 3, 3, 3, 6, 7]):
        np.testing.assert_array_equal(outs[i], good[src], err_msg=f"frame {i}")
    assert sorted(calls).count(2) == 4 and calls.count(1) == 4


def test_neural_pixelizer_raises_a9(tmp_path, monkeypatch):
    """The neural pixelizer is served (ROADMAP A9, tests/test_torch_neural*.py);
    without the released checkpoints it raises, on the ditherer's device,
    instead of running anything else."""
    from dither_pie_tpu_torch.pipeline import pixelize as tpix

    monkeypatch.setattr(tpix, "_neural_singletons", {})
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DITHER_PIE_TPU_CKPT_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="checkpoints not found"):
        list(tvideo.process_frames(iter(_frames(2)), _ours("none", {}),
                                   pixelize_func=("neural", 16)))
    with pytest.raises(FileNotFoundError, match="checkpoints not found"):
        timage.apply_pixelization(Image.fromarray(_frames(1)[0]),
                                  {"enabled": True, "method": "neural", "max_size": 8},
                                  device="cpu")
    assert tpix._neural_singletons == {}


def test_multi_host_raises_a11(tmp_path):
    with pytest.raises(NotImplementedError, match="A11"):
        tvideo.VideoProcessor().process_video_streaming(
            str(tmp_path / "in.mp4"), str(tmp_path / "out.mp4"), _ours("none", {}),
            host_index=0, host_count=2)
    with pytest.raises(NotImplementedError, match="A11"):
        tvideo.process_single_video({"input": "in.mp4", "output": "out.mp4"},
                                    host_count=2)


def test_without_a_video_backend_nothing_runs(monkeypatch, tmp_path):
    monkeypatch.setattr(tffio, "video_available", lambda: False)
    assert not tvideo.VideoProcessor().process_video_streaming(
        str(tmp_path / "in.mp4"), str(tmp_path / "out.mp4"), _ours("none", {}))
    assert not tvideo.process_single_video({"input": str(tmp_path / "in.mp4"),
                                            "output": str(tmp_path / "out.mp4")},
                                           device="cpu")


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the check is for machines without")
    cfg = {"palette": {"source": "median_cut", "num_colors": 4, "use_gamma": False},
           "dithering": {"mode": "bayer", "parameters": {}}}
    with pytest.raises(RuntimeError, match="cuda"):
        timage.build_ditherer(cfg, Image.fromarray(_frames(1)[0]))


def test_resume_plan_and_manifest_equal_jax(tmp_path):
    for total, size in ((10, 4), (8, 4), (1, 300), (901, 300)):
        assert tresume.n_segments(total, size) == jresume.n_segments(total, size)
        for done in (set(), {1}, {0, 1}):
            assert (tresume.plan_segments(total, size, done)
                    == jresume.plan_segments(total, size, done))
    with pytest.raises(ValueError):
        tresume.plan_segments(10, 0, set())
    out = str(tmp_path / "video.mp4")
    expect = {"input": "/a/b.mp4", "fps": 30.0, "segment_size": 300, "total_frames": 900}
    (tmp_path / "video.mp4.seg0001.mp4").write_bytes(b"x")
    tresume.save_manifest(out, expect, {0, 1})
    saved = Path(tresume.manifest_path(out)).read_text()
    assert tresume.load_manifest(out, expect) == jresume.load_manifest(out, expect) == {1}
    jresume.save_manifest(out, expect, {0, 1})
    assert Path(jresume.manifest_path(out)).read_text() == saved
    assert tresume.load_manifest(out, dict(expect, segment_size=100)) == set()
    assert tresume.segment_part_path(out, 7) == jresume.segment_part_path(out, 7)
    assert tresume.segment_tmp_path(out, 7) == jresume.segment_tmp_path(out, 7)


def test_encode_command_equals_jax():
    for kw in ({}, {"source_path": "in.mp4", "total_frames": 101},
               {"in_pix_fmt": "gbrp"}):
        assert (tffio.encode_command("o.mp4", 1280, 720, 29.97, **kw)
                == jffio.encode_command("o.mp4", 1280, 720, 29.97, **kw))


def _config(tmp_path, name, dithering):
    rng = np.random.RandomState(3)
    Image.fromarray(rng.randint(0, 256, (40, 60, 3), dtype=np.uint8)).save(tmp_path / "in.png")
    raw = {"input": "in.png", "output": f"{name}.png",
           "pixelization": {"enabled": True, "method": "regular", "max_size": 32},
           "dithering": dithering,
           "palette": {"source": "median_cut", "num_colors": 8},
           "final_resize": {"enabled": True, "multiplier": 2}}
    path = tmp_path / "config.json"
    path.write_text(json.dumps(raw))
    return path


@pytest.mark.parametrize("dithering", [
    {"enabled": True, "mode": "bayer", "parameters": {"size": "4x4"}},
    {"enabled": True, "mode": "error_diffusion",
     "parameters": {"variant": "floyd_steinberg", "serpentine": "true"}},
], ids=["bayer", "fs-serpentine"])
def test_process_single_image_equals_jax(tmp_path, dithering):
    path = _config(tmp_path, "x", dithering)
    ours = tconfig.load_config(path)
    theirs = jconfig.load_config(path)
    assert ours == theirs
    theirs["output"] = str(tmp_path / "jax.png")
    assert jimage.process_single_image(theirs)
    assert timage.process_single_image(ours, device="cpu")
    got = Path(ours["output"]).read_bytes()
    assert got == (tmp_path / "jax.png").read_bytes()
    assert np.asarray(Image.open(ours["output"])).shape == (64, 96, 3)


def test_config_validation_equals_jax(tmp_path):
    (tmp_path / "in.png").write_bytes(b"")
    for raw in ({}, {"input": "in.png", "output": "o.png", "mode": "bogus",
                     "dithering": {"mode": "nope"}, "palette": {"num_colors": -1}},
                {"input": "in.png", "output": "o.png", "palette": {"source": "gb_dmg_palette"}},
                {"input": "in.png", "output": "o.png", "palette": {"source": "no_such"}},
                {"input": "in.png", "output": "o.png", "dithering": {"mode": "riemersma"},
                 "final_resize": {"multiplier": "x"}}):
        results = []
        for mod in (tconfig, jconfig):
            try:
                results.append(mod.validate_config(json.loads(json.dumps(raw)),
                                                   tmp_path / "c.json"))
            except mod.ConfigValidationError as e:
                results.append(str(e))
        assert results[0] == results[1], raw
    for name in ("a.mp4", "b.PNG", "c.mkv"):
        assert tconfig.detect_mode(Path(name)) == jconfig.detect_mode(Path(name))
    with pytest.raises(tconfig.ConfigValidationError):
        tconfig.detect_mode(Path("x.xyz"))


def test_stage_report_lists_the_stages():
    tprof.reset()
    list(tvideo.process_frames(iter(_frames(5)), _ours("bayer", {"size": "4x4"}),
                               batch_size=2, pixelize_func=("regular", 8)))
    report = tprof.stage_report()
    assert "video.dither_batch" in report and "video.pixelize" in report
    assert "(3x," in report  # batches of 2, 2 and 1
    tprof.reset()
    assert tprof.stage_report() == "stage timings:"

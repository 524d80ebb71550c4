"""The port's tools, preference store, shims and host utilities against the
JAX package's, on the CPU.

* ``tools/resizer.py``: ``resize_image`` bitwise, the ffmpeg command of
  ``resize_video``; ``tools/vid_conc.py``: ``sanitize_cmd``,
  ``combine_cmd`` and the whole command sequence of
  ``concat_side_by_side`` (``tests/test_pipeline.py`` TestTools and
  TestFFmpegCommandParity are the spec), False without ffmpeg;
* ``tools/pixelize.py`` on ``load_random(0)`` weights: the native x4 flow,
  ``--target_size`` and a folder within one u8 step of the JAX tool;
* ``api/config_manager.py``: the GUI's sequence of get / set / recent-file
  operations writes the JAX package's JSON file;
* the ``dithering_lib`` and ``config_manager`` shims;
* ``utils.py``'s ``import_lospec_palette`` (a stub ``requests.get``: no
  network), ``estimate_video_memory_usage``, ``validate_video_file``,
  ``validate_image_file``, ``get_image_info`` and the extension sets;
* ROADMAP C14: ``video_processor.NeuralPixelizer`` and
  ``generate_blue_noise`` at the package's top.
"""

import inspect
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import bench
import dither_pie_tpu as jdpt
import dither_pie_tpu.dithering_lib as jlib
import dither_pie_tpu.utils as jutils
import dither_pie_tpu_torch as tdpt
import dither_pie_tpu_torch.dithering_lib as tlib
import dither_pie_tpu_torch.utils as tutils
from dither_pie_tpu.api.config_manager import ConfigManager as JConfigManager
from dither_pie_tpu.models import inference as jinf
from dither_pie_tpu.tools import pixelize as jpixtool
from dither_pie_tpu.tools import resizer as jres
from dither_pie_tpu.tools import vid_conc as jvc
from dither_pie_tpu_torch.api.config_manager import ConfigManager
from dither_pie_tpu_torch.models import inference as tinf
from dither_pie_tpu_torch.tools import pixelize as tpixtool
from dither_pie_tpu_torch.tools import resizer as tres
from dither_pie_tpu_torch.tools import vid_conc as tvc
import torch_workers  # noqa: F401


def _image(path, h, w, seed=0, mode="RGB"):
    path.parent.mkdir(parents=True, exist_ok=True)
    img = Image.fromarray(bench.synth_image(h, w, seed))
    if mode != "RGB":
        img = img.convert(mode)
    img.save(path)
    return path


# ---------------------------------------------------------------------------
# tools/resizer.py, tools/vid_conc.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw,max_size", [((40, 60), 20), ((60, 40), 21), ((33, 33), 8),
                                         ((100, 30), 64), ((31, 75), 200)])
def test_resize_image_equals_jax(tmp_path, hw, max_size):
    src = _image(tmp_path / "in.png", *hw, seed=4)
    tres.resize_image(str(src), str(tmp_path / "ours.png"), max_size)
    jres.resize_image(str(src), str(tmp_path / "theirs.png"), max_size)
    ours = np.asarray(Image.open(tmp_path / "ours.png"))
    np.testing.assert_array_equal(ours, np.asarray(Image.open(tmp_path / "theirs.png")))
    assert ours.shape[0] % 2 == 0 and ours.shape[1] % 2 == 0


class _Recorder:
    """Stands in for subprocess.run: records each command."""

    def __init__(self):
        self.cmds = []

    def __call__(self, cmd, check=False, **kw):
        self.cmds.append(list(cmd))
        return types.SimpleNamespace(returncode=0)


@pytest.mark.parametrize("max_size", [240, 97])
def test_resize_video_command_equals_jax(monkeypatch, max_size):
    rec = _Recorder()
    monkeypatch.setattr("subprocess.run", rec)
    for mod in (tres, jres):
        monkeypatch.setattr(mod, "ffmpeg_available", lambda: True)
        monkeypatch.setattr(mod, "FFMPEG", "ffmpeg")
        assert mod.resize_video("in.mp4", "out.mp4", max_size)
    assert len(rec.cmds) == 2 and rec.cmds[0] == rec.cmds[1]
    assert "flags=neighbor" in " ".join(rec.cmds[0])


def test_resize_video_without_ffmpeg(monkeypatch, capsys):
    monkeypatch.setattr(tres, "ffmpeg_available", lambda: False)
    assert tres.resize_video("in.mp4", "out.mp4", 64) is False
    assert "ffmpeg not found on PATH" in capsys.readouterr().err


@pytest.mark.parametrize("fps,height", [(29.97, 720), (24.0, 481), (60.0, 2)])
def test_sanitize_cmd_equals_jax(fps, height):
    assert tvc.sanitize_cmd("a.mp4", "c.mp4", fps, height) == \
        jvc.sanitize_cmd("a.mp4", "c.mp4", fps, height)
    assert "flags=neighbor" in " ".join(tvc.sanitize_cmd("a.mp4", "c.mp4", fps, height))


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("vertical", [False, True])
@pytest.mark.parametrize("merge_audio", [False, True])
def test_combine_cmd_equals_jax(n, vertical, merge_audio):
    clean = [f"c{i}.mp4" for i in range(n)]
    ours = tvc.combine_cmd(clean, "out.mp4", vertical, merge_audio)
    assert ours == jvc.combine_cmd(clean, "out.mp4", vertical, merge_audio)
    fc = ours[ours.index("-filter_complex") + 1]
    assert f"{'vstack' if vertical else 'hstack'}=inputs={n}[v]" in fc
    assert ("amerge" in fc) == merge_audio
    if merge_audio and n == 2:
        assert "amerge=inputs=2,pan=stereo|c0<c0+c2|c1<c1+c3[a]" in fc


def _normalized(cmds):
    return [[Path(a).name if "clean_" in a else a for a in cmd] for cmd in cmds]


def test_concat_side_by_side_commands_equal_jax(monkeypatch):
    infos = {"a.mp4": {"fps": 30.0, "height": 721}, "b.mp4": {"fps": 24.0, "height": 540}}
    runs = {}
    for mod in (tvc, jvc):
        rec = _Recorder()
        monkeypatch.setattr("subprocess.run", rec)
        monkeypatch.setattr(mod, "ffmpeg_available", lambda: True)
        monkeypatch.setattr(mod, "probe_video", lambda p: infos[p])
        assert mod.concat_side_by_side(["a.mp4", "b.mp4"], "out.mp4", vertical=True)
        runs[mod.__name__] = _normalized(rec.cmds)
    ours, theirs = runs[tvc.__name__], runs[jvc.__name__]
    assert ours == theirs and len(ours) == 3
    assert "scale=-2:540:flags=neighbor,fps=30.00000" in ours[0]


def test_concat_side_by_side_without_ffmpeg(monkeypatch, capsys):
    for mod in (tvc, jvc):
        monkeypatch.setattr(mod, "ffmpeg_available", lambda: False)
        assert mod.concat_side_by_side(["a.mp4", "b.mp4"], "out.mp4") is False
    err = capsys.readouterr().err
    assert err.count("ffmpeg not found on PATH") == 2


# ---------------------------------------------------------------------------
# tools/pixelize.py and ROADMAP C14
# ---------------------------------------------------------------------------


@pytest.fixture()
def random_models(monkeypatch):
    """Both packages' PixelizationModel.load give load_random(0) (the
    released checkpoints are absent), in float32."""
    monkeypatch.setenv("DITHER_PIE_TPU_NEURAL_PRECISION", "float32")
    monkeypatch.setattr(tinf.PixelizationModel, "load", lambda self: self.load_random(0))
    monkeypatch.setattr(jinf.PixelizationModel, "load", lambda self: self.load_random(0))


def _jax_tool(monkeypatch, *args):
    monkeypatch.setattr(sys, "argv", ["pixelize", *args])
    return jpixtool.main()


def _within_one_step(a_path, b_path):
    a = np.asarray(Image.open(a_path)).astype(np.int16)
    b = np.asarray(Image.open(b_path)).astype(np.int16)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 1
    return a.shape


@pytest.mark.parametrize("target", [0, 16], ids=["native-x4", "target16"])
def test_pixelize_tool_equals_jax(tmp_path, monkeypatch, random_models, target):
    src = _image(tmp_path / "in.png", 64, 96, seed=7)
    extra = ["--target_size", str(target)] if target else []
    assert tpixtool.main(["--input", str(src), "--output", str(tmp_path / "ours.png"),
                          "--device", "cpu", *extra]) == 0
    assert _jax_tool(monkeypatch, "--input", str(src), "--output",
                     str(tmp_path / "theirs.png"), *extra) == 0
    shape = _within_one_step(tmp_path / "ours.png", tmp_path / "theirs.png")
    assert shape == ((16, 24, 3) if target else (64, 96, 3))


def test_pixelize_tool_folder_and_default_names(tmp_path, monkeypatch, random_models):
    folder = tmp_path / "imgs"
    for i in range(2):
        _image(folder / f"p{i}.png", 32, 40, seed=i)
    assert tpixtool.main(["--input", str(folder), "--output", str(tmp_path / "ours"),
                          "--device", "cpu"]) == 0
    assert _jax_tool(monkeypatch, "--input", str(folder), "--output",
                     str(tmp_path / "theirs")) == 0
    for i in range(2):
        _within_one_step(tmp_path / "ours" / f"p{i}.png", tmp_path / "theirs" / f"p{i}.png")
    one = _image(tmp_path / "single.png", 32, 40, seed=9)
    assert tpixtool.main(["--input", str(one), "--device", "cpu"]) == 0
    assert (tmp_path / "single_pixelized.png").exists()
    assert tpixtool.main(["--input", str(tmp_path / "missing.png"), "--device", "cpu"]) == 1


def test_pixelize_tool_defaults_to_the_card(tmp_path, random_models):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the check is for machines without")
    src = _image(tmp_path / "in.png", 32, 40)
    with pytest.raises(RuntimeError, match="cuda"):
        tpixtool.main(["--input", str(src)])
    assert not (tmp_path / "in_pixelized.png").exists()


def test_c14_public_names():
    from dither_pie_tpu.core.thresholds import generate_blue_noise as jblue
    from dither_pie_tpu_torch.video_processor import NeuralPixelizer, VideoProcessor

    from dither_pie_tpu_torch.pipeline import video as tvideo

    assert NeuralPixelizer is tvideo.NeuralPixelizer
    assert NeuralPixelizer is not tdpt.NeuralPixelizer  # the models' class stays exported
    assert VideoProcessor is tvideo.VideoProcessor
    assert "generate_blue_noise" in tdpt.__all__
    for size, seed in ((8, 42), (16, 3)):
        np.testing.assert_array_equal(tdpt.generate_blue_noise(size, seed), jblue(size, seed))
    assert jdpt.generate_blue_noise is jblue


def test_c14_video_neural_pixelizer_equals_get_neural_pixelizer(monkeypatch):
    from dither_pie_tpu_torch.models.pixelizer import NeuralPixelizer as ModelPixelizer
    from dither_pie_tpu_torch.pipeline import pixelize as tpix
    from dither_pie_tpu_torch.video_processor import NeuralPixelizer

    monkeypatch.setenv("DITHER_PIE_TPU_NEURAL_PRECISION", "float32")
    monkeypatch.setattr(tpix, "_neural_singletons", {})
    m = tinf.PixelizationModel(device="cpu")
    m.load_random(0)
    tpix.install_neural_pixelizer(ModelPixelizer.from_model(m))
    img = Image.fromarray(bench.synth_image(40, 56, 11))
    got = NeuralPixelizer(device="cpu").pixelize(img, 16)
    want = tpix.get_neural_pixelizer(device="cpu").pixelize(img, 16)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert got.size[1] == 16
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            NeuralPixelizer()  # the default device is the card


# ---------------------------------------------------------------------------
# api/config_manager.py and the shims
# ---------------------------------------------------------------------------


def _gui_sequence(cls, path, recent):
    """The GUI's and its tests' operations on the preference store."""
    cfg = cls(str(path))
    out = [cfg.get("defaults", "num_colors"), cfg.get("nope", default="d"),
           cfg.get("window", "geometry", "deeper", default=5)]
    cfg.set("pixelization_editor", "dialog_width", value=801)  # the keyword form
    cfg.set("pixelization_editor", "dialog_height", 601)       # positional
    cfg.set("new_section", "key", [1, 2])
    cfg.set_window_geometry("1024x768+10+20")
    cfg.set_last_dir("image", "/pics")
    cfg.set_last_dir("video", "/clips")
    for p in recent + [recent[0], "/no/such/file.png"]:
        cfg.add_recent_file(p, max_entries=3)
    for key, value in (("num_colors", 8), ("dither_mode", "stucki"), ("pixelize_max_size", 96),
                       ("final_resize_multiplier", 3), ("use_gamma", True)):
        cfg.set("defaults", key, value)
    cfg.save()
    out += [cfg.get_window_geometry(), cfg.get_last_dir("image"), cfg.get_last_dir("audio"),
            cfg.get_recent_files(), cfg.get("pixelization_editor", "dialog_width")]
    again = cls(str(path))
    out += [again.config, again.get("defaults", "num_colors")]
    return out


def test_config_manager_equals_jax(tmp_path, capsys):
    recent = [str(_image(tmp_path / "r" / f"{i}.png", 4, 4)) for i in range(4)]
    ours = _gui_sequence(ConfigManager, tmp_path / "ours.json", recent)
    theirs = _gui_sequence(JConfigManager, tmp_path / "theirs.json", recent)
    assert ours == theirs
    assert (tmp_path / "ours.json").read_text() == (tmp_path / "theirs.json").read_text()
    assert ours[-2]["recent_files"] == ["/no/such/file.png", recent[0], recent[3]]
    assert ours[-4] == [recent[0], recent[3]]  # get_recent_files: existing files only
    # A partial file merges over the defaults; a broken one keeps them.
    (tmp_path / "partial.json").write_text(json.dumps({"window": {"state": "zoomed"}, "x": 1}))
    (tmp_path / "broken.json").write_text("{not json")
    for name in ("partial.json", "broken.json"):
        assert ConfigManager(str(tmp_path / name)).config == \
            JConfigManager(str(tmp_path / name)).config
    printed = capsys.readouterr().out.splitlines()
    assert len(printed) == 2 and printed[0] == printed[1]
    assert printed[0].startswith("Error loading config: ")


def test_config_manager_shim():
    from dither_pie_tpu_torch.config_manager import ConfigManager as Shimmed

    assert Shimmed is ConfigManager


def test_dithering_lib_exports_the_jax_shims_names():
    """The JAX shim's names are what ``import *`` of its facade brings plus
    ``generate_blue_noise``; its own classes and functions (the module
    imports and typing names aside) are the port's shim's ``__all__``, but
    ``map_to_palette``, a jitted function of ``core/distance.py``, which
    the port does not have (ROADMAP "Not to port")."""
    theirs = {n for n in dir(jlib) if not n.startswith("_")
              and (inspect.isclass(getattr(jlib, n)) or callable(getattr(jlib, n)))
              and getattr(getattr(jlib, n), "__module__", "").startswith("dither_pie_tpu")}
    assert "map_to_palette" in theirs
    assert set(tlib.__all__) == theirs - {"map_to_palette"}
    for name in tlib.__all__:
        obj = getattr(tlib, name)
        assert obj.__module__.startswith("dither_pie_tpu_torch."), name
        assert getattr(tdpt, name, obj) is obj, name
    ns = {}
    exec("from dither_pie_tpu_torch.dithering_lib import *", ns)
    assert set(ns) - {"__builtins__"} == set(tlib.__all__)


# ---------------------------------------------------------------------------
# utils.py
# ---------------------------------------------------------------------------


def test_extension_sets_equal_jax():
    assert tutils.VIDEO_EXTENSIONS == jutils.VIDEO_EXTENSIONS
    assert tutils.IMAGE_EXTENSIONS == jutils.IMAGE_EXTENSIONS


@pytest.mark.parametrize("whf", [(1920, 1080, 1), (1280, 720, 101), (0, 5, 3), (7, 3, 0)])
def test_estimate_video_memory_usage_equals_jax(whf):
    assert tutils.estimate_video_memory_usage(*whf) == jutils.estimate_video_memory_usage(*whf)


@pytest.mark.parametrize("name", ["a.mp4", "b.MKV", "c.webm", "d.m4v", "e.png", "f.JPEG",
                                  "g.tiff", "h.webp", "i.txt", "j", "missing.mp4",
                                  "missing.png"])
def test_validate_files_equal_jax(tmp_path, name):
    path = tmp_path / name
    if not name.startswith("missing"):
        path.write_bytes(b"x")
    for fn in ("validate_video_file", "validate_image_file"):
        assert getattr(tutils, fn)(str(path)) == getattr(jutils, fn)(str(path)), fn


@pytest.mark.parametrize("kind", ["png-rgb", "png-rgba", "jpeg", "gif", "bmp-l", "corrupt",
                                  "missing"])
def test_get_image_info_equals_jax(tmp_path, kind, capsys):
    name, mode = {"png-rgb": ("a.png", "RGB"), "png-rgba": ("b.png", "RGBA"),
                  "jpeg": ("c.jpg", "RGB"), "gif": ("d.gif", "P"), "bmp-l": ("e.bmp", "L"),
                  "corrupt": ("f.png", None), "missing": ("g.png", None)}[kind]
    path = tmp_path / name
    if mode:
        _image(path, 12, 17, mode=mode)
    elif kind == "corrupt":
        path.write_bytes(b"\x89PNG\r\n\x1a\nbroken")
    ours = tutils.get_image_info(str(path))
    theirs = jutils.get_image_info(str(path))
    assert ours == theirs
    printed = capsys.readouterr().out.splitlines()
    if mode:
        assert ours["width"] == 17 and ours["height"] == 12 and ours["mode"] == mode
        assert not printed
    else:
        assert ours is None and len(printed) == 2 and printed[0] == printed[1]
        assert printed[0].startswith("Error getting image info: ")


class _Response:
    def __init__(self, data, status=200):
        self.data, self.status = data, status

    def raise_for_status(self):
        if self.status >= 400:
            raise RuntimeError(f"HTTP {self.status}")

    def json(self):
        return self.data


@pytest.mark.parametrize("case", ["ok", "ok-trailing-slash", "no-name", "no-colors",
                                  "http-error", "network-error", "bad-hex"])
def test_import_lospec_palette_equals_jax(monkeypatch, capsys, case):
    calls = []
    url = "https://lospec.com/palette-list/pico-8" + ("/" if case == "ok-trailing-slash" else "")
    data = {"ok": {"name": "PICO-8", "colors": ["000000", "1d2b53", "FFF1E8"]},
            "no-name": {"colors": ["ff0000"]}, "no-colors": {"name": "empty", "colors": []},
            "bad-hex": {"name": "bad", "colors": ["zz0000"]}}
    data["ok-trailing-slash"] = data["ok"]

    def get(api_url, timeout):
        calls.append((api_url, timeout))
        if case == "network-error":
            raise ConnectionError("no network")
        return _Response(data.get(case), status=404 if case == "http-error" else 200)

    monkeypatch.setitem(sys.modules, "requests", types.SimpleNamespace(get=get))
    ours = tutils.import_lospec_palette(url)
    theirs = jutils.import_lospec_palette(url)
    assert ours == theirs
    assert calls == [("https://lospec.com/palette-list/pico-8.json", 10)] * 2
    printed = capsys.readouterr().out.splitlines()
    if case.startswith("ok"):
        assert ours == {"name": "PICO-8", "colors": ["#000000", "#1d2b53", "#fff1e8"]}
    elif case == "no-name":
        assert ours == {"name": "pico-8", "colors": ["#ff0000"]}
    else:
        assert ours is None
    if case in ("http-error", "network-error", "bad-hex"):
        assert len(printed) == 2 and printed[0] == printed[1]
        assert printed[0].startswith("Error importing from Lospec: ")
    else:
        assert not printed

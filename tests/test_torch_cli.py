"""The port's command line (``dither_pie_tpu_torch.cli.main``, ``python -m
dither_pie_tpu_torch``) on the CPU, against the JAX package's CLI
(``tests/test_pipeline.py::TestCLI`` is the spec) and the port's own
pipelines.

* ``--example-config`` through the three module entry points parses to the
  JAX package's JSON (its ``_comment`` names the port's module); ``--help``
  exits 0; the router with no arguments calls the GUI's ``launch_gui``,
  which without a card or a display exits 1 naming the command line;
* exit 1 for a missing config, an invalid config, a missing override, bad
  ``--shard`` specs and ``--device cuda`` without a card (which writes
  nothing: nothing falls back to the CPU); 130 on Ctrl+C;
* ``generate_output_filename`` equals the JAX package's over a grid of
  pixelization, palette source and gamma settings;
* image runs through ``main()`` equal the port's ``process_single_image``
  bitwise, and the JAX CLI's output bitwise for the ordered modes and none;
  for error diffusion the identity with the JAX CLI's output is >= 0.98
  (XLA:CPU contracts multiply-adds, ROADMAP C2). The port's k-means fit is
  not the JAX package's (``tests/test_torch_palette.py`` holds its inertia
  close), so the k-means comparison with JAX runs both packages under
  ``DITHER_PIE_TPU_KMEANS=sklearn``, which gives both the same palette;
* the input override writes the smart name; the folder batch, a corrupt
  file in it and an empty folder; every ``examples/*.json`` that needs no
  ffmpeg; ``setup_logging`` and ``CLIProgressCallback``.
"""

import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import bench
from dither_pie_tpu.cli import main as jcli
from dither_pie_tpu_torch.cli import main as tcli
from dither_pie_tpu_torch.pipeline import image as timage
import torch_workers  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"


@pytest.fixture(autouse=True)
def isolated(monkeypatch):
    """The RGB path; the JAX CLI without its persistent compilation cache;
    the root logger's handlers and both packages' logger levels restored
    after each test (setup_logging replaces them)."""
    monkeypatch.setenv("DITHER_PIE_TPU_INDEX_TRANSFER", "0")
    import dither_pie_tpu.api.cache as jcache

    monkeypatch.setattr(jcache, "enable_compilation_cache", lambda: None)
    root = logging.getLogger()
    saved = (root.handlers[:], root.level,
             {n: logging.getLogger(n).level for n in ("dither_pie_tpu", "dither_pie_tpu_torch")})
    yield
    root.handlers[:] = saved[0]
    root.setLevel(saved[1])
    for name, level in saved[2].items():
        logging.getLogger(name).setLevel(level)


def _image(path, h=40, w=60, seed=3):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(bench.synth_image(h, w, seed)).save(path)
    return path


def _write_config(path, cfg):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(cfg))
    return path


def _run(*args, env=None):
    e = dict(os.environ, JAX_PLATFORMS="cpu", **(env or {}))
    return subprocess.run([sys.executable, *args], capture_output=True, text=True,
                          env=e, cwd=ROOT, timeout=300)


def _jax_example_config(capsys):
    jcli.generate_example_config()
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("module", ["dither_pie_tpu_torch.cli.main", "dither_pie_tpu_torch.cli",
                                    "dither_pie_tpu_torch"])
def test_example_config_equals_jax(module, capsys):
    r = _run("-m", module, "--example-config")
    assert r.returncode == 0, r.stderr
    ours = json.loads(r.stdout)
    theirs = _jax_example_config(capsys)
    assert "python -m dither_pie_tpu_torch" in ours["_comment"]
    assert ours["_comment"].startswith(theirs["_comment"])
    ours["_comment"] = theirs["_comment"]
    assert ours == theirs


def test_router_without_arguments_launches_the_gui(monkeypatch):
    """No arguments: the router calls gui.app.launch_gui (the GUI's own
    checks are in tests/test_torch_gui_*.py); arguments go to the CLI."""
    from dither_pie_tpu_torch import __main__ as router
    from dither_pie_tpu_torch.gui import app

    calls = []
    monkeypatch.setattr(app, "launch_gui", lambda *a, **k: calls.append((a, k)))
    monkeypatch.setattr(sys, "argv", ["dither_pie_tpu_torch"])
    router.main()
    assert calls == [((), {})]


def test_router_without_a_card_or_display_exits_1():
    """Here, with no card and no display, the GUI does not start: exit 1,
    a message that names the command line, and no traceback."""
    r = _run("-m", "dither_pie_tpu_torch", env={"DISPLAY": ""})
    assert r.returncode == 1 and not r.stdout
    assert "Cannot start GUI" in r.stderr
    assert "python -m dither_pie_tpu_torch <config.json>" in r.stderr
    assert "Traceback" not in r.stderr


def test_help_exits_0(capsys):
    assert tcli.main(["--help"]) == 0
    out = capsys.readouterr().out
    assert "python -m dither_pie_tpu_torch" in out and "--device" in out
    for mode in ("bayer", "error_diffusion", "riemersma"):
        assert mode in out
    r = _run("-m", "dither_pie_tpu_torch.cli", "--help")
    assert r.returncode == 0 and "Usage" in r.stdout


def _basic_config(tmp_path, **over):
    _image(tmp_path / "in.png")
    cfg = {"input": "in.png", "output": "out.png",
           "dithering": {"enabled": True, "mode": "bayer"},
           "palette": {"source": "median_cut", "num_colors": 4}}
    cfg.update(over)
    return _write_config(tmp_path / "config.json", cfg)


def test_missing_config_exits_1(tmp_path, capsys):
    assert tcli.main([str(tmp_path / "none.json"), "--device", "cpu"]) == 1
    assert "Configuration file not found" in capsys.readouterr().out


def test_no_config_exits_1(capsys):
    assert tcli.main(["--device", "cpu"]) == 1
    assert "No configuration file specified" in capsys.readouterr().out


def test_invalid_config_exits_1(tmp_path, capsys):
    cfgp = _basic_config(tmp_path, mode="bogus", dithering={"mode": "nope"})
    assert tcli.main([str(cfgp), "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "Invalid mode" in out and "Invalid dither mode" in out
    assert not (tmp_path / "out.png").exists()


def test_missing_override_exits_1(tmp_path, capsys):
    cfgp = _basic_config(tmp_path)
    assert tcli.main([str(cfgp), str(tmp_path / "nope.png"), "--device", "cpu"]) == 1
    assert "Input override file/folder not found" in capsys.readouterr().out


@pytest.mark.parametrize("spec", ["4:4", "-1:2", "1", "a:b", "1:0", "0:2:1"])
def test_bad_shard_exits_1(tmp_path, spec, capsys):
    cfgp = _basic_config(tmp_path)
    assert tcli.main([str(cfgp), f"--shard={spec}", "--device", "cpu"]) == 1
    assert "shard spec" in capsys.readouterr().out
    assert not (tmp_path / "out.png").exists()


def test_shard_in_image_mode_is_ignored(tmp_path, capsys):
    cfgp = _basic_config(tmp_path)
    assert tcli.main([str(cfgp), "--shard", "1:2", "--device", "cpu"]) == 0
    assert "--shard applies to video/folder modes; ignored" in capsys.readouterr().out
    assert (tmp_path / "out.png").exists()


def test_device_cuda_without_a_card_exits_1(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the check is for machines without")
    cfgp = _basic_config(tmp_path)
    assert tcli.main([str(cfgp)]) == 1
    assert tcli.main([str(cfgp), "--device", "cuda"]) == 1
    out = capsys.readouterr().out
    assert "torch.cuda.is_available() is False" in out
    assert not (tmp_path / "out.png").exists()  # nothing ran on the CPU instead
    r = _run("-m", "dither_pie_tpu_torch", str(cfgp))
    assert r.returncode == 1 and not (tmp_path / "out.png").exists()


def test_ctrl_c_exits_130(tmp_path, monkeypatch):
    cfgp = _basic_config(tmp_path)

    def interrupted(config, device="cuda"):
        raise KeyboardInterrupt

    monkeypatch.setattr(tcli, "process_single_image", interrupted)
    assert tcli.main([str(cfgp), "--device", "cpu"]) == 130


def _name_config(pix, source, gamma, dither=True):
    enabled, method = pix
    return {"pixelization": {"enabled": enabled, "method": method, "max_size": 48},
            "dithering": {"enabled": dither, "mode": "error_diffusion"},
            "palette": {"source": source, "num_colors": 12, "use_gamma": gamma}}


@pytest.mark.parametrize("gamma", [False, True], ids=["srgb", "gamma"])
@pytest.mark.parametrize("source", ["median_cut", "kmeans", "uniform", "file:pal.png",
                                    "custom:my_long_palette_name", "pico8"])
@pytest.mark.parametrize("pix", [(False, "regular"), (True, "regular"), (True, "neural"),
                                 (True, "none")], ids=["off", "regular", "neural", "none"])
def test_output_filename_equals_jax(pix, source, gamma):
    cfg = _name_config(pix, source, gamma)
    for p in (Path("/data/in.png"), Path("rel/a_very_long_input_file_name_over_30_chars.jpg")):
        assert tcli.generate_output_filename(p, cfg) == jcli.generate_output_filename(p, cfg)


def test_output_filename_without_dithering_equals_jax():
    cfg = _name_config((True, "regular"), "kmeans", True, dither=False)
    p = Path("x/in.webp")
    assert tcli.generate_output_filename(p, cfg) == jcli.generate_output_filename(p, cfg)
    assert tcli.generate_output_filename(p, cfg) == Path("x/in_pix48.webp")


IMAGE_RUNS = [  # (id, dithering, palette, bitwise with the JAX CLI)
    ("bayer-mc4", {"enabled": True, "mode": "bayer", "parameters": {"size": "4x4"}},
     {"source": "median_cut", "num_colors": 4}, True),
    ("none-uni8", {"enabled": True, "mode": "none"}, {"source": "uniform", "num_colors": 8},
     True),
    ("fs-km8", {"enabled": True, "mode": "error_diffusion",
                "parameters": {"variant": "floyd_steinberg"}},
     {"source": "kmeans", "num_colors": 8}, False),
]


@pytest.mark.parametrize("dithering,palette,bitwise", [r[1:] for r in IMAGE_RUNS],
                         ids=[r[0] for r in IMAGE_RUNS])
def test_image_run_equals_pipeline_and_jax(tmp_path, monkeypatch, dithering, palette, bitwise):
    cfg = {"input": "placeholder.png", "output": "placeholder_out.png",
           "pixelization": {"enabled": True, "method": "regular", "max_size": 32},
           "dithering": dithering, "palette": palette,
           "final_resize": {"enabled": True, "multiplier": 2}}
    cfgp = _write_config(tmp_path / "config.json", cfg)
    ours_in = _image(tmp_path / "port" / "in.png")
    theirs_in = _image(tmp_path / "jax" / "in.png")
    assert tcli.main([str(cfgp), str(ours_in), "--device", "cpu"]) == 0
    expected = tcli.generate_output_filename(ours_in, tcli.load_config(
        cfgp, skip_input_check=True))
    assert expected.exists()
    got = np.asarray(Image.open(expected))

    # The port's own pipeline on the same config, bitwise.
    full = tcli.load_config(cfgp, skip_input_check=True)
    full.update(input=str(ours_in), output=str(tmp_path / "pipeline.png"), mode="image")
    assert timage.process_single_image(full, device="cpu")
    assert expected.read_bytes() == (tmp_path / "pipeline.png").read_bytes()

    # The JAX CLI on the same image (both k-means fits through sklearn).
    if palette["source"] == "kmeans":
        monkeypatch.setenv("DITHER_PIE_TPU_KMEANS", "sklearn")
        assert tcli.main([str(cfgp), str(ours_in), "--device", "cpu"]) == 0
        got = np.asarray(Image.open(expected))
    assert jcli.main([str(cfgp), str(theirs_in)]) == 0
    want = np.asarray(Image.open(theirs_in.parent / expected.name))
    assert got.shape == want.shape == (64, 96, 3)
    if bitwise:
        np.testing.assert_array_equal(got, want)
    else:
        ident = float(np.mean(np.all(got == want, axis=-1)))
        assert ident >= 0.98, ident


def test_input_override_writes_the_smart_name(tmp_path):
    cfgp = _write_config(tmp_path / "config.json", {
        "input": "placeholder.png", "output": "placeholder_out.png",
        "dithering": {"enabled": True, "mode": "bayer"},
        "palette": {"source": "kmeans", "num_colors": 8}})
    img = _image(tmp_path / "in.png")
    assert tcli.main([str(cfgp), str(img), "--device", "cpu"]) == 0
    assert (tmp_path / "in_bayer_km8c.png").exists()
    assert not (tmp_path / "placeholder_out.png").exists()


def _folder_cfg(tmp_path, folder, dithering=None):
    return _write_config(tmp_path / "folder.json", {
        "input": str(folder), "output": str(tmp_path / "out"), "mode": "folder",
        "dithering": dithering or {"enabled": True, "mode": "error_diffusion",
                                   "parameters": {"variant": "floyd_steinberg"}},
        "palette": {"source": "kmeans", "num_colors": 8}})


def test_folder_batch_equals_single_images(tmp_path):
    folder = tmp_path / "imgs"
    for i in range(3):
        _image(folder / f"img{i}.png", 20 + 4 * i, 24, seed=i)
    (folder / "notes.txt").write_text("not media")
    cfgp = _folder_cfg(tmp_path, folder)
    assert tcli.main([str(cfgp), "--device", "cpu"]) == 0
    outs = sorted((tmp_path / "out").iterdir())
    assert [p.name for p in outs] == ["img0.png", "img1.png", "img2.png"]
    base = tcli.load_config(cfgp)
    for i, out in enumerate(outs):
        single = dict(base, input=str(folder / out.name), output=str(tmp_path / f"s{i}.png"),
                      mode="image")
        assert timage.process_single_image(single, device="cpu")
        assert out.read_bytes() == (tmp_path / f"s{i}.png").read_bytes()


def test_folder_batch_counts_a_corrupt_file(tmp_path, capsys):
    folder = tmp_path / "imgs"
    for i in range(2):
        _image(folder / f"img{i}.png", 16, 20, seed=i)
    (folder / "broken.png").write_bytes(b"\x89PNG\r\n\x1a\nnot really")
    cfgp = _folder_cfg(tmp_path, folder, {"enabled": True, "mode": "bayer"})
    assert tcli.main([str(cfgp), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Successful:      2" in out and "Failed:          1" in out and "- broken.png" in out
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == ["img0.png", "img1.png"]


def test_empty_folder_fails(tmp_path):
    (tmp_path / "empty").mkdir()
    cfg = tcli.load_config(_folder_cfg(tmp_path, tmp_path / "empty"))
    assert not tcli.process_folder(cfg, device="cpu")
    assert tcli.main([str(tmp_path / "folder.json"), "--device", "cpu"]) == 1


def _needs_ffmpeg(cfg):
    return cfg.get("mode") == "video" or Path(cfg["input"]).suffix in (".mp4", ".mkv")


EXAMPLE_NAMES = sorted(p.stem for p in EXAMPLES.glob("*.json"))


def test_every_example_is_run_or_needs_ffmpeg():
    needs = [n for n in EXAMPLE_NAMES
             if _needs_ffmpeg(json.loads((EXAMPLES / f"{n}.json").read_text()))]
    assert needs == ["video_basic"]
    assert len(EXAMPLE_NAMES) == 9


@pytest.fixture(scope="module")
def random_pixelizer():
    from dither_pie_tpu_torch.models import inference as tinf
    from dither_pie_tpu_torch.models.pixelizer import NeuralPixelizer

    m = tinf.PixelizationModel(device="cpu")
    m.load_random(0)
    return NeuralPixelizer.from_model(m)


@pytest.mark.parametrize("name", [n for n in EXAMPLE_NAMES if n != "video_basic"])
def test_example_config_runs(tmp_path, monkeypatch, name, request):
    cfg = json.loads((EXAMPLES / f"{name}.json").read_text())
    if cfg.get("pixelization", {}).get("method") == "neural":
        from dither_pie_tpu_torch.pipeline import pixelize as tpix

        monkeypatch.setattr(tpix, "_neural_singletons", {})
        monkeypatch.setenv("DITHER_PIE_TPU_NEURAL_PRECISION", "float32")
        tpix.install_neural_pixelizer(request.getfixturevalue("random_pixelizer"))
    monkeypatch.chdir(tmp_path)  # no palette.json of the working directory
    if cfg.get("mode") == "folder":
        target = tmp_path / "photos"
        for i in range(2):
            _image(target / f"p{i}.png", 30, 40, seed=i)
        assert tcli.main([str(EXAMPLES / f"{name}.json"), str(target), "--device", "cpu"]) == 0
        outs = sorted(p.name for p in (tmp_path / "photos_processed").iterdir())
        assert outs == ["p0.png", "p1.png"]
        return
    target = _image(tmp_path / "photo.png")
    assert tcli.main([str(EXAMPLES / f"{name}.json"), str(target), "--device", "cpu"]) == 0
    full = tcli.load_config(EXAMPLES / f"{name}.json", skip_input_check=True)
    out = tcli.generate_output_filename(target, full)
    arr = np.asarray(Image.open(out))
    assert arr.dtype == np.uint8 and arr.ndim == 3 and arr.shape[2] == 3


@pytest.mark.parametrize("verbose,quiet,level", [(False, False, logging.INFO),
                                                 (True, False, logging.DEBUG),
                                                 (False, True, logging.ERROR)])
def test_setup_logging_levels_and_file(tmp_path, verbose, quiet, level, capsys):
    log_file = tmp_path / "run.log"
    logger = tcli.setup_logging(verbose=verbose, quiet=quiet, log_file=str(log_file))
    assert logger.name == "dither_pie_tpu_torch" and logger.level == level
    logger.debug("debug line")
    logger.info("info line")
    logger.error("error line")
    out = capsys.readouterr().out
    text = log_file.read_text()
    for line, lvl in (("debug line", logging.DEBUG), ("info line", logging.INFO),
                      ("error line", logging.ERROR)):
        assert (line in out) == (lvl >= level)
        assert (line in text) == (lvl >= level)
    assert " - dither_pie_tpu_torch - ERROR - error line" in text


def test_progress_callback_non_tty_line(capsys):
    with tcli.CLIProgressCallback() as cb:
        assert not cb.use_rich
        cb.update(0.5, "Half way")
        cb.finish()
    assert capsys.readouterr().out.splitlines() == ["Progress: 50% - Half way",
                                                    "Progress: 100% - Complete!"]


def test_reexports_the_pipelines():
    from dither_pie_tpu_torch.pipeline.video import process_single_video

    assert tcli.process_single_image is timage.process_single_image
    assert tcli.process_single_video is process_single_video
    assert set(tcli.__all__) == set(jcli.__all__)

"""The port's neural pixelizer against the benchmark's plain reference of
it (``portbench/references/pixelization.py``), on the CPU, without JAX.

The reference shares no code with the port: it draws its own weights and
runs the released code's forward in plain float32 ``torch``. Here, at small
sizes and on seeded random weights:

* its weight draw equals the port's ``load_random`` weights bitwise;
* the port's float32 forward equals it within 1e-4, the whole-forward
  tolerance of ``tests/test_torch_neural.py``: both sum the same products
  in float32, in other orders, through about 40 convolutions whose norms
  rescale what the sums round;
* the port's batched path as the video runs it (its gates lock bfloat16
  and the stride-4 final conv) lies within the benchmark configuration's
  neural limits, while the reference with float8 operands (the precision
  below the configuration's) and the reference without AliasNet lie
  outside them;
* the whole configuration through ``process_frames`` (pixelize, then
  Atkinson to the k-means palette) equals the reference's error diffusion
  of the port's own pixelized frames, bitwise, in the row-major order.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from dither_pie_tpu_torch.models import convert, param_shapes  # noqa: E402
from dither_pie_tpu_torch.models import inference as inf  # noqa: E402
from dither_pie_tpu_torch.models.pixelizer import NeuralPixelizer  # noqa: E402
from portbench.references import pixelization as ref  # noqa: E402
import torch_workers  # noqa: E402, F401

CPU = torch.device("cpu")
CONFIG = json.loads((ROOT / "portbench" / "configs" / "pix128-atk-km16.json").read_text())
MAX_SIZE = 16  # frames of 96 x 160 become a 64 x 104 forward and 16 x 26 frames
FRAMES_HW = (96, 160)


def _config():
    cfg = json.loads(json.dumps(CONFIG))
    cfg["pixelization"]["max_size"] = MAX_SIZE
    return cfg


def _frames(n, seed=0):
    from portbench import frames as frame_gen

    traffic = json.loads((ROOT / "portbench" / "traffic" / "neural-stream-1080p.json")
                         .read_text())
    traffic.update(height=FRAMES_HW[0], width=FRAMES_HW[1], pool=n)
    return frame_gen.make_pool(traffic, seed, CPU)


@pytest.fixture(autouse=True)
def no_switches(monkeypatch):
    for name in ("PRECISION", "U8_IN", "DS4", "DS4_STRIDE"):
        monkeypatch.delenv(f"DITHER_PIE_TPU_NEURAL_{name}", raising=False)


@pytest.fixture(scope="module")
def model():
    m = inf.PixelizationModel(device="cpu")
    m.load_random(CONFIG["neural"]["weights_seed"])
    return m


@pytest.fixture(scope="module")
def frames():
    return _frames(4, seed=2**31 + 7)


@pytest.fixture(scope="module")
def reference_f32(frames):
    return ref.pixelize(frames, _config(), CPU)


@pytest.mark.parametrize("seed", [0, 5])
def test_the_reference_draws_the_programs_weights(seed):
    gen, alias = ref.draw_weights(seed)
    want_gen, want_alias = convert.state_from_jax(*param_shapes.random_params(seed))
    for got, want in ((gen, want_gen), (alias, want_alias)):
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_the_float32_forward_equals_the_reference(model, frames):
    x = inf.process(inf.resize_image_nearest(Image.fromarray(frames[0]), 4 * MAX_SIZE))
    got = model.forward_tensor(model._tensor(x), "float32")
    nets = ref.Nets(*ref.draw_weights(CONFIG["neural"]["weights_seed"]))
    grey = np.asarray(Image.open(ref.STYLE_IMAGE).convert("L"))
    style = torch.from_numpy(ref._normalized(Image.fromarray(np.stack([grey] * 3, -1))))
    with torch.inference_mode():
        code = nets.style_code(style)
        want = nets.aliasnet(nets.c2pgen(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                                         code))
    torch.testing.assert_close(code, model._style(), rtol=0, atol=1e-4)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_the_pixelized_frames_have_the_reference_shape(frames, reference_f32):
    h, w = ref.output_size(*FRAMES_HW, MAX_SIZE)
    assert reference_f32.shape == (len(frames), h, w, 3)
    assert (h, w) == (16, 26)
    assert ref.output_size(1080, 1920, 128) == (128, 228)


def _deltas(got, want, far_steps):
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    means = d.reshape(len(d), -1).mean(1)
    far = (d.max(-1) > far_steps).reshape(len(d), -1).mean(1)
    return float(means.max()), float(far.max())


def test_the_video_path_lies_within_the_limits(frames, reference_f32):
    m = inf.PixelizationModel(device="cpu")
    m.load_random(CONFIG["neural"]["weights_seed"])
    got = [np.array(o) for o in NeuralPixelizer.from_model(m).pixelize_batch(
        [Image.fromarray(f) for f in frames], MAX_SIZE)]
    assert (m._video_prec, m._ds4_stride) == (CONFIG["neural"]["precision"],
                                              CONFIG["neural"]["ds4_stride"])
    mean, far = _deltas(np.stack(got), reference_f32, CONFIG["neural"]["far_steps"])
    assert mean <= CONFIG["limits"]["neural_mean_u8_delta"]
    assert far <= CONFIG["limits"]["neural_far_share"]


@pytest.mark.parametrize("control", ["float8 operands", "no AliasNet"])
def test_the_controls_lie_outside_the_limits(frames, reference_f32, control):
    if control == "float8 operands":
        got = ref.pixelize(frames, _config(), CPU, torch.float8_e4m3fn)
    else:
        got = ref.pixelize(frames, _config(), CPU, alias=False)
    mean, far = _deltas(got, reference_f32, CONFIG["neural"]["far_steps"])
    assert (mean > CONFIG["limits"]["neural_mean_u8_delta"]
            or far > CONFIG["limits"]["neural_far_share"]), (mean, far)


def test_the_configuration_equals_the_references_dither_of_its_pixelized_frames(frames):
    from dither_pie_tpu_torch.pipeline.image import build_ditherer
    from dither_pie_tpu_torch.pipeline.pixelize import _neural_singletons, \
        install_neural_pixelizer
    from dither_pie_tpu_torch.pipeline.video import process_frames
    from portbench.kinds.neural_stream import Tee

    cfg = _config()
    m = inf.PixelizationModel(device="cpu")
    m.load_random(cfg["neural"]["weights_seed"])
    tee = Tee(NeuralPixelizer.from_model(m))
    before = dict(_neural_singletons)
    install_neural_pixelizer(tee)
    try:
        ditherer = build_ditherer(cfg, Image.fromarray(frames[0]), CPU)
        tee.record(lambda j: True)
        outs = list(process_frames(iter(frames), ditherer, batch_size=2,
                                   pixelize_func=("neural", MAX_SIZE)))
    finally:
        _neural_singletons.clear()
        _neural_singletons.update(before)
    pal = ref.palette(frames[0], cfg, CPU)
    assert np.array_equal(np.asarray(ditherer.palette, dtype=np.int64), pal)
    px = np.stack([np.array(tee.kept[j].convert("RGB")) for j in range(len(frames))])
    want = ref.dither(px, pal, cfg, CPU)
    assert len(outs) == len(frames)
    assert all(np.array_equal(o, w) for o, w in zip(outs, want))
    assert ref.outputs(frames[:1], pal, cfg, CPU).shape[1:] == outs[0].shape

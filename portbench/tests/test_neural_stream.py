"""The neural stream's cell on the CPU at a tiny size: the FLOP count
against hand counts, each new reader on a synthetic trace and counters,
whole runs through the harness, and the check against planted faults."""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import cells, harness, neural_work, readers
from portbench.references import error_diffusion
from portbench.references import pixelization as reference
from portbench.trace import Trace

from test_reference import row_major

CPU = torch.device("cpu")
DATA = Path(__file__).resolve().parent / "data"
CELL = "pix128-atk-km16.neural-stream-1080p"
NEW_METRICS = ["fps.neural_stream", "pixelize_ms.neural_stream",
               "neural_host_in_ms.neural_stream", "neural_forward_ms.neural_stream",
               "neural_wait_ms.neural_stream", "neural_host_out_ms.neural_stream",
               "neural_roofline.neural_stream", "mfu.neural_stream", "idle_pct.neural_stream"]


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads a test process: workers that each spin up a
    thread a core starve one another's bfloat16 convolutions, and a
    window's frames would not come back inside it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def tiny_neural_cell() -> cells.Cell:
    """The cell at 96 x 160 frames, max_size 16 (a 64 x 104 forward, 16 x
    26 pixelized frames), a pool of 5 and batches of 4."""
    cell = cells.find_cell(cells.load_benchmark(), CELL)
    cell.traffic.update(height=96, width=160, pool=5, batch=4, warmup_batches=1,
                        sample_stride=3)
    cell.config["pixelization"]["max_size"] = 16
    return cell


def run_tiny(bench, trace=False, seconds=0.8, seed=2**31 + 11):
    return harness.run(bench, tiny_neural_cell(), seed, seconds, trace, CPU,
                       time.perf_counter(), 0.0)


def test_a_strided_conv_block_by_hand():
    # RGBEnc's first down at 512 x 912: 4 x 4 taps, 64 -> 128 channels, 256 x 456 outputs.
    assert ("c2pgen.enc.down1", 4, 64, 128, 256, 456) in neural_work.layers(512, 912)
    assert neural_work.conv_flops(4, 64, 128, 256, 456) == 2 * 16 * 64 * 128 * 256 * 456 \
        == 30_601_641_984


def test_the_frame_count_at_1080p():
    h, w = neural_work.net_input(1080, 1920, 128)
    assert (h, w) == (512, 912)
    assert len(neural_work.layers(h, w)) == 40
    assert neural_work.frame_flops(h, w) == 1_878_306_521_088
    # The final conv counts at the /4 samples: 7 x 7 taps, 64 -> 3, 128 x 228.
    assert neural_work.layers(h, w)[-1] == ("alias.dec.conv_3", 7, 64, 3, 128, 228)
    assert neural_work.least_s(16 * neural_work.frame_flops(h, w)) == pytest.approx(
        30.05e12 / 989.4e12, rel=1e-3)


def _ctx(kind="neural_stream", **kw):
    trace = Trace(window=(0, 1_000_000_000))
    trace.device = [("ed_scan_kernel<float, 0>", "kernel", 0, 100_000_000, 0),
                    ("cudnn_conv_bf16", "kernel", 100_000_000, 400_000_000, 0),
                    ("elementwise_kernel", "kernel", 500_000_000, 600_000_000, 0),
                    ("Memcpy HtoD", "h2d", 600_000_000, 700_000_000, 0)]
    trace.host = [("neural.forward", 50_000_000, 250_000_000, 1),
                  ("neural.forward", 900_000_000, 1_200_000_000, 1),
                  ("video.pixelize", 0, 800_000_000, 1)]
    base = dict(kind=kind, trace=trace, latencies=[0.1] * 30, seconds=1.0,
                counters={"frames": 32, "batches": 2, "frame_flops": 10**12})
    base.update(kw)
    return readers.Context(**base)


def test_the_readers_on_a_synthetic_trace():
    ctx = _ctx()
    read = {name: readers.read_metric(name, ctx) for name in NEW_METRICS}
    assert read["fps.neural_stream"] == 30.0
    # Two neural.forward spans, the second clipped at the window's end: 200 + 100 ms over 2.
    assert read["neural_forward_ms.neural_stream"] == pytest.approx(150.0)
    assert read["pixelize_ms.neural_stream"] == pytest.approx(400.0)
    assert read["neural_host_in_ms.neural_stream"] is None  # no such span
    # 32 frames of 1 TFLOP at the bf16 peak over the 0.4 s of non-dither kernels.
    assert read["neural_roofline.neural_stream"] == pytest.approx(
        32e12 / neural_work.PEAK_BF16_FLOPS / 0.4 * 100)
    assert read["mfu.neural_stream"] == pytest.approx(30e12 / neural_work.PEAK_BF16_FLOPS * 100)
    # Busy 0.1 + 0.3 + 0.1 + 0.1 s of 1 s.
    assert read["idle_pct.neural_stream"] == pytest.approx(40.0)


@pytest.mark.parametrize("kind", ["stream", "image"])
def test_the_readers_read_nothing_outside_their_kind(kind):
    assert all(readers.read_metric(name, _ctx(kind=kind)) is None for name in NEW_METRICS)


def test_the_readers_read_nothing_of_a_program_without_the_counts():
    ctx = _ctx(counters={"frames": 32, "batches": 2})  # no frame_flops
    assert readers.read_metric("mfu.neural_stream", ctx) is None
    assert readers.read_metric("neural_roofline.neural_stream", ctx) is None
    ctx = _ctx(trace=None)
    assert all(readers.read_metric(n, ctx) is None for n in NEW_METRICS
               if n not in ("fps.neural_stream", "mfu.neural_stream"))


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run(bench, trace):
    result, lines = run_tiny(bench, trace)
    json.dumps(result, allow_nan=False)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["checks"]) == set(tiny_neural_cell().config["limits"])
    assert any(line.startswith("neural input 64x104") for line in lines)
    if trace:
        # No card here: the device readers read nothing; the span readers do.
        assert {"fps.neural_stream", "pixelize_ms.neural_stream", "mfu.neural_stream",
                "neural_forward_ms.neural_stream", "neural_wait_ms.neural_stream",
                "neural_host_in_ms.neural_stream", "neural_host_out_ms.neural_stream"} \
            <= set(result["metrics"]) <= set(NEW_METRICS)
    else:
        assert set(result["metrics"]) == {"setup_s"}


def _no_aliasnet(monkeypatch):
    from dither_pie_tpu_torch.models import inference

    monkeypatch.setattr(inference, "aliasnet_forward", lambda alias, x, precision: x)
    monkeypatch.setattr(inference, "aliasnet_forward_ds4",
                        lambda alias, x, precision: x[:, :, 2::4, 2::4])


def _one_pixel_altered(monkeypatch):
    from dither_pie_tpu_torch.ops import wavefront

    original = wavefront.unskew_unpack

    def broken(*args, **kwargs):
        out = original(*args, **kwargs)
        out[..., -1, -1, :] ^= 1
        return out

    monkeypatch.setattr(wavefront, "unskew_unpack", broken)


def _frames_shifted(monkeypatch):
    from dither_pie_tpu_torch.models.pixelizer import NeuralPixelizer

    original = NeuralPixelizer.pixelize_batch
    monkeypatch.setattr(NeuralPixelizer, "pixelize_batch",
                        lambda self, images, m: original(self, images[1:] + images[:1], m))


@pytest.mark.parametrize("fault, number", [
    ("the forward skips AliasNet", "neural_mean_u8_delta"),
    ("each batch's frames pixelized one place off", "neural_mean_u8_delta"),
    ("an answer of the dither altered", "mismatch_share"),
    ("the gate locks float32", "neural_gate_f32"),
    ("the final conv dense", "ds4_stride_mismatch"),
])
def test_planted_faults_come_out_not_correct(bench, monkeypatch, fault, number):
    if fault == "the forward skips AliasNet":
        _no_aliasnet(monkeypatch)
    elif fault == "each batch's frames pixelized one place off":
        _frames_shifted(monkeypatch)
    elif fault == "an answer of the dither altered":
        _one_pixel_altered(monkeypatch)
    elif fault == "the gate locks float32":
        monkeypatch.setenv("DITHER_PIE_TPU_NEURAL_PRECISION", "float32")
    else:
        monkeypatch.setenv("DITHER_PIE_TPU_NEURAL_DS4_STRIDE", "0")
    result, _ = run_tiny(bench)
    assert result["correct"] is False
    check = result["checks"][number]
    assert check["value"] > check["limit"]


def test_the_tee_keeps_only_the_kept_positions():
    from portbench.kinds.neural_stream import Tee

    class Inner:
        device = CPU

        def pixelize(self, image, max_size):
            return image * 10

        def pixelize_batch(self, images, max_size):
            return [i * 10 for i in images]

    tee = Tee(Inner())
    assert tee.pixelize_batch([1, 2], 8) == [10, 20]  # before a window: nothing kept
    tee.record(lambda j: j % 2 == 1)
    assert tee.pixelize_batch([1, 2, 3], 8) == [10, 20, 30]
    assert tee.pixelize(4, 8) == 40
    assert tee.kept == {1: 20, 3: 40} and tee.device == CPU
    tee.record(None)
    assert tee.kept == {} and tee.at == 0


def test_the_parent_program_without_spans_gives_a_line(bench, monkeypatch):
    """A program without the neural spans and counters (the parent of the
    change that added them) runs the cell: the span readers read nothing."""
    from dither_pie_tpu_torch.api import profiling
    from dither_pie_tpu_torch.models import inference

    monkeypatch.setattr(inference, "stage", lambda name: contextlib.nullcontext())
    monkeypatch.setattr(inference, "count", lambda *a: None)
    monkeypatch.setattr(profiling, "counters", lambda: {})
    result, _ = run_tiny(bench, trace=True)
    assert result["correct"] is True
    assert not any(n.startswith("neural_") and "roofline" not in n for n in result["metrics"])


def test_the_dither_keeps_the_row_major_order_of_atkinsons_errors():
    """At pixel (104, 2) of this case the sources (x + 1, y - 1) and
    (x - 2, y) send their errors on diagonals out of row order: the
    row-major scan, the program's plain path and ``reference.dither`` add
    them in row order."""
    case = json.loads((DATA / "atkinson_order.json").read_text())
    frame = np.array(case["frame"], dtype=np.uint8)[None]
    pal = np.array(case["palette"], dtype=np.int64)
    config = tiny_neural_cell().config
    want = row_major(frame[0], pal, error_diffusion.entries_of(config))
    assert np.array_equal(reference.dither(frame, pal, config, CPU)[0], want)

    from dither_pie_tpu_torch.api.ditherer import ImageDitherer, DitherMode
    program = ImageDitherer(num_colors=len(pal), dither_mode=DitherMode.ERROR_DIFFUSION,
                            palette=[tuple(map(int, c)) for c in pal],
                            dither_params=config["dithering"]["parameters"], device=CPU)
    assert np.array_equal(program.apply_dithering_batch(frame)[0], want)

"""The port's spans and counters (``api/profiling.py``, ``api/transfer.py``)
on the CPU, without JAX.

* Under a ``torch.profiler`` of every thread, ``process_frames`` records
  each span of the pipeline and the facade; the transfers, the dispatch and
  the host epilogue nest inside their batch's ``video.dither_batch`` on the
  worker's thread, and ``video.stack`` lies outside it.
* Without a profiler a stage enters no ``record_function`` range.
* The byte and frame counters are exact; a planted batch failure and a
  planted frame failure move the failure counters by the pipeline's own
  log records; ``reset()`` clears them.
* ``DITHER_PIE_TPU_TRACE_DIR`` writes the trace and the counters at exit.
* ``kernels.build.count_launch`` and ``profiling.count`` lose no update
  under contention.
"""

import json
import logging
import os
import subprocess
import sys
import threading
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import dither_pie_tpu_torch as tdpt
from dither_pie_tpu_torch.api import profiling
from dither_pie_tpu_torch.kernels import build
from dither_pie_tpu_torch.pipeline import video
import torch_workers  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PAL = [(0, 0, 0), (250, 250, 250), (200, 40, 40), (30, 90, 200), (240, 200, 60)]
H, W = 12, 20

PIPELINE_SPANS = {"video.prefetch_get", "video.stack", "video.dither_batch", "video.wait",
                  "facade.host_in", "transfer.h2d", "ops.ed_dispatch", "transfer.d2h",
                  "facade.host_out"}
INSIDE_BATCH = {"transfer.h2d", "ops.ed_dispatch", "transfer.d2h", "facade.host_out"}


@pytest.fixture(autouse=True)
def rgb_path(monkeypatch):
    monkeypatch.setenv("DITHER_PIE_TPU_INDEX_TRANSFER", "0")
    profiling.reset()
    yield
    profiling.reset()


def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (H, W, 3), dtype=np.uint8) for _ in range(n)]


def _fs(**kw):
    return tdpt.ImageDitherer(num_colors=len(PAL), dither_mode=tdpt.DitherMode.ERROR_DIFFUSION,
                              palette=list(PAL), dither_params={"variant": "floyd_steinberg"},
                              device="cpu", **kw)


def _host_ranges(prof):
    """(name, start_ns, end_ns, thread) of every host range of the trace."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CPU:
            s = ev.start_ns()
            out.append((ev.name(), s, s + ev.duration_ns(), ev.start_thread_id()))
    return out


def _traced(fn):
    from torch.profiler import ProfilerActivity, profile

    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    prof = profile(activities=[ProfilerActivity.CPU], experimental_config=config)
    prof.start()
    try:
        fn()
    finally:
        prof.stop()
    return _host_ranges(prof)


def test_spans_nest_by_layer_under_a_profiler_of_every_thread():
    ditherer = _fs(use_gamma=True)  # the batch path's host_in is the gamma path
    ranges = _traced(lambda: list(video.process_frames(iter(_frames(5)), ditherer,
                                                       batch_size=2)))
    names = {r[0] for r in ranges}
    assert PIPELINE_SPANS <= names, PIPELINE_SPANS - names
    assert "device.wait" not in names  # CUDA only
    batches = [r for r in ranges if r[0] == "video.dither_batch"]
    assert len(batches) == 3  # 2 + 2 + 1 frames
    main = {r[3] for r in ranges if r[0] in ("video.wait", "video.prefetch_get")}
    assert len(main) == 1 and not main & {r[3] for r in batches}
    for name, s, e, tid in ranges:
        if name in INSIDE_BATCH:
            assert any(bs <= s and e <= be and bt == tid for _, bs, be, bt in batches), name
        if name == "video.stack":
            assert not any(bs < e and s < be and bt == tid for _, bs, be, bt in batches)
    for _, bs, be, bt in batches:
        inside = {n for n, s, e, t in ranges if t == bt and bs <= s and e <= be}
        assert INSIDE_BATCH <= inside


def test_a_single_image_opens_the_facade_spans():
    img = Image.fromarray(_frames(1)[0])
    ranges = _traced(lambda: _fs().apply_dithering(img))
    names = [r[0] for r in ranges]
    assert names.count("facade.host_in") >= 2 and names.count("facade.host_out") >= 2
    assert {"transfer.h2d", "ops.ed_dispatch", "transfer.d2h"} <= set(names)


def test_without_a_profiler_no_range_is_entered(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    out = list(video.process_frames(iter(_frames(3)), _fs(), batch_size=2))
    _fs().apply_dithering(Image.fromarray(_frames(1)[0]))
    assert len(out) == 3
    assert "video.dither_batch" in profiling.stage_report()


@pytest.mark.parametrize("overlap", [True, False])
def test_batch_counters_are_exact(overlap):
    n = 5
    out = list(video.process_frames(iter(_frames(n)), _fs(), batch_size=2, overlap=overlap))
    c = profiling.counters()
    assert len(out) == n == c["video.frames"] == c["facade.frames"]
    assert c["transfer.h2d_bytes"] == c["transfer.d2h_bytes"] == n * H * W * 3
    assert c["video.prefetch_gets"] == n + 1  # the frames and the end
    assert 0 <= c["video.prefetch_depth"] <= (n + 1) * 2 * 2
    assert "video.batches_retried" not in c and "video.frames_patched" not in c


def test_single_image_counters_are_exact():
    _fs().apply_dithering(Image.fromarray(_frames(1)[0]))
    c = profiling.counters()
    assert c["facade.frames"] == 1
    assert c["transfer.h2d_bytes"] == H * W * 3 * 4  # one float32 frame
    assert c["transfer.d2h_bytes"] == H * W * 3  # uint8 colours


class _Planted:
    """A ditherer whose batches fail where they hold a marked frame (its
    first pixel 255, 0, 255), and, with ``whole``, any batch of more than
    one frame."""

    def __init__(self, inner, whole=False):
        self.inner, self.whole, self.device = inner, whole, inner.device

    def apply_dithering_batch(self, arrs, planar=False):
        marked = (arrs[:, 0, 0] == (255, 0, 255)).all(axis=-1)
        if marked.any() or (self.whole and len(arrs) > 1):
            raise RuntimeError("planted failure")
        return self.inner.apply_dithering_batch(arrs, planar=planar)


@pytest.mark.parametrize("whole", [True, False], ids=["batch", "frame"])
def test_failure_counters_follow_the_log_records(whole, caplog):
    frames = _frames(6)
    if not whole:
        frames[3][0, 0] = (255, 0, 255)
    with caplog.at_level(logging.WARNING, logger="dither_pie_tpu_torch"):
        ranges = _traced(lambda: list(video.process_frames(
            iter(frames), _Planted(_fs(), whole), batch_size=2)))
    msgs = [r.getMessage() for r in caplog.records]
    retried = sum(m.startswith("Batch dither failed") for m in msgs)
    patched = sum(m.startswith("Patched failed frame") for m in msgs)
    c = profiling.counters()
    assert c.get("video.batches_retried", 0) == retried == (3 if whole else 1)
    assert c.get("video.frames_patched", 0) == patched == (0 if whole else 1)
    assert c.get("video.frames_failed", 0) == (0 if whole else 1)
    assert c["video.frames"] == 6
    assert sum(r[0] == "video.retry" for r in ranges) == retried


def test_reset_clears_the_counters():
    profiling.count("video.frames", 3)
    assert profiling.counters() == {"video.frames": 3}
    assert "video.frames" in profiling.stage_report()
    profiling.reset()
    assert profiling.counters() == {}
    assert profiling.stage_report() == "stage timings:"


def test_the_exporter_writes_trace_and_counters_at_exit(tmp_path):
    script = (
        "import sys, numpy as np\n"
        "import dither_pie_tpu_torch as tdpt\n"
        "from dither_pie_tpu_torch.pipeline import video\n"
        "d = tdpt.ImageDitherer(num_colors=2, dither_mode=tdpt.DitherMode.ERROR_DIFFUSION,\n"
        "    palette=[(0, 0, 0), (255, 255, 255)], device='cpu')\n"
        "rng = np.random.default_rng(0)\n"
        "frames = [rng.integers(0, 256, (8, 12, 3), dtype=np.uint8) for _ in range(4)]\n"
        "assert len(list(video.process_frames(iter(frames), d, batch_size=2))) == 4\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'dither_pie_tpu')]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("DITHER_PIE_TPU_")}
    env.update(DITHER_PIE_TPU_TRACE_DIR=str(tmp_path), DITHER_PIE_TPU_INDEX_TRANSFER="0",
               PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", script], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    (trace,) = tmp_path.glob("trace_*.json")
    pid = trace.stem.split("_")[1]
    events = json.loads(trace.read_text())["traceEvents"]
    tids = {}
    for ev in events:
        tids.setdefault(ev.get("name"), set()).add(ev.get("tid"))
    assert tids.get("video.dither_batch") and tids.get("video.wait")
    assert not tids["video.dither_batch"] & tids["video.wait"]  # worker and main thread
    record = json.loads((tmp_path / f"counters_{pid}.json").read_text())
    assert record["counters"]["facade.frames"] == 4
    assert record["counters"]["transfer.h2d_bytes"] == 4 * 8 * 12 * 3
    assert record["stages"]["video.dither_batch"]["count"] == 2


def _hammer(fn, threads=16, calls=2000):
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [fn() for _ in range(calls)])
                   for _ in range(threads)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in workers)
    finally:
        sys.setswitchinterval(old)
    return threads * calls


def test_launch_and_span_counts_lose_no_update(monkeypatch):
    monkeypatch.setattr(build, "LAUNCHES", Counter())
    total = _hammer(lambda: build.count_launch("skew"))
    assert build.LAUNCHES["skew"] == total
    assert _hammer(lambda: profiling.count("transfer.h2d_bytes", 3)) * 3 == \
        profiling.counters()["transfer.h2d_bytes"]

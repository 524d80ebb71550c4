"""The readers of the program's own spans and counters (``portbench/spans.py``)
on synthetic traces and counters."""

from __future__ import annotations

import pytest

from portbench import readers, spans
from portbench.readers import Context
from portbench.trace import Trace

import bench_cells  # noqa: F401  (puts the checkout on the path)

SPAN_READERS = {
    "stack_ms.stream": "video.stack", "emit_wait_ms.stream": "video.wait",
    "h2d_host_ms.stream": "transfer.h2d", "dispatch_ms.stream": "ops.ed_dispatch",
    "device_wait_ms.stream": "device.wait", "d2h_host_ms.stream": "transfer.d2h",
    "host_out_ms.stream": "facade.host_out", "host_in_ms.image": "facade.host_in",
    "h2d_host_ms.image": "transfer.h2d", "d2h_host_ms.image": "transfer.d2h",
    "host_out_ms.image": "facade.host_out",
}
COUNTER_READERS = {
    "h2d_mb_per_frame.stream": "transfer.h2d_bytes",
    "d2h_mb_per_frame.stream": "transfer.d2h_bytes",
    "h2d_mb_per_frame.image": "transfer.h2d_bytes",
}
MS = 1_000_000


def _kind(name):
    return "stream" if name.endswith(".stream") else "image"


def _ctx(kind, host, units=2):
    tr = Trace(host=host, window=(10 * MS, 110 * MS))
    unit = "batches" if kind == "stream" else "calls"
    return Context(kind=kind, trace=tr, counters={unit: units})


def test_span_time_is_clipped_to_the_window_and_spread_over_the_units():
    host = [("transfer.h2d", 0, 20 * MS, 1),          # 10 ms inside
            ("transfer.h2d", 50 * MS, 60 * MS, 2),    # 10 ms
            ("transfer.h2d", 100 * MS, 130 * MS, 1),  # 10 ms inside
            ("transfer.h2d", 200 * MS, 210 * MS, 1),  # outside
            ("transfer.d2h", 40 * MS, 45 * MS, 1)]
    ctx = _ctx("stream", host)
    assert spans.span_ms_per_unit(ctx, "stream", "transfer.h2d") == pytest.approx(15.0)
    assert spans.span_ms_per_unit(ctx, "stream", "transfer.d2h") == pytest.approx(2.5)
    assert spans.span_ms_per_unit(ctx, "image", "transfer.h2d") is None
    assert spans.span_ms_per_unit(ctx, "stream", "device.wait") is None
    only_outside = _ctx("stream", [("transfer.h2d", 200 * MS, 210 * MS, 1)])
    assert spans.span_ms_per_unit(only_outside, "stream", "transfer.h2d") is None
    assert spans.span_ms_per_unit(_ctx("stream", host, units=0), "stream",
                                  "transfer.h2d") is None


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_each_span_reader_reads_its_span(name):
    kind = _kind(name)
    host = [(SPAN_READERS[name], 20 * MS, 30 * MS, 1), ("other", 20 * MS, 90 * MS, 1)]
    assert readers.read_metric(name, _ctx(kind, host, units=4)) == pytest.approx(2.5)
    assert readers.read_metric(name, _ctx(kind, [("other", 20 * MS, 90 * MS, 1)])) is None
    assert readers.read_metric(name, Context(kind=kind, trace=None)) is None
    other = "image" if kind == "stream" else "stream"
    assert readers.read_metric(name, _ctx(other, host)) is None


@pytest.mark.parametrize("name", sorted(COUNTER_READERS))
def test_each_counter_reader_divides_by_the_frames(name, monkeypatch):
    from dither_pie_tpu_torch.api import profiling

    kind = _kind(name)
    profiling.reset()
    try:
        assert readers.read_metric(name, Context(kind=kind, trace=None)) is None
        profiling.count("facade.frames", 32)
        profiling.count(COUNTER_READERS[name], 32 * 1080 * 1920 * 3)
        assert readers.read_metric(name, Context(kind=kind, trace=None)) == \
            pytest.approx(6.2208)
        other = "image" if kind == "stream" else "stream"
        assert readers.read_metric(name, Context(kind=other, trace=None)) is None
        # A program without counters (older than them) reads nothing.
        monkeypatch.delattr(profiling, "counters")
        assert readers.read_metric(name, Context(kind=kind, trace=None)) is None
    finally:
        profiling.reset()

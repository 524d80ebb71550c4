"""The reader of the share of sent bytes that left from pinned host memory
(``portbench/metrics/h2d_pinned_pct.stream.py``), on stub counters."""

from __future__ import annotations

import pytest

from portbench import readers
from portbench.readers import Context

import bench_cells  # noqa: F401  (puts the checkout on the path)

NAME = "h2d_pinned_pct.stream"
FRAME_BYTES = 6220800


@pytest.fixture
def counters(monkeypatch):
    """The program's counters, as a dict the test fills."""
    from dither_pie_tpu_torch.api import profiling

    read = {}
    monkeypatch.setattr(profiling, "counters", lambda: dict(read))
    return read


def test_equal_counters_read_100(counters):
    counters.update({"transfer.h2d_bytes": 32 * FRAME_BYTES,
                     "transfer.h2d_pinned_bytes": 32 * FRAME_BYTES})
    assert readers.read_metric(NAME, Context(kind="stream", trace=None)) == pytest.approx(100.0)


def test_a_partly_pinned_send_reads_its_share(counters):
    counters.update({"transfer.h2d_bytes": 32 * FRAME_BYTES,
                     "transfer.h2d_pinned_bytes": 8 * FRAME_BYTES})
    assert readers.read_metric(NAME, Context(kind="stream", trace=None)) == pytest.approx(25.0)


def test_an_image_run_reads_nothing(counters):
    counters.update({"transfer.h2d_bytes": FRAME_BYTES,
                     "transfer.h2d_pinned_bytes": FRAME_BYTES})
    assert readers.read_metric(NAME, Context(kind="image", trace=None)) is None


def test_a_program_without_the_pinned_counter_reads_nothing(counters):
    counters["transfer.h2d_bytes"] = 32 * FRAME_BYTES
    assert readers.read_metric(NAME, Context(kind="stream", trace=None)) is None


def test_a_stream_that_sent_nothing_reads_nothing(counters):
    counters.update({"transfer.h2d_bytes": 0, "transfer.h2d_pinned_bytes": 0})
    assert readers.read_metric(NAME, Context(kind="stream", trace=None)) is None

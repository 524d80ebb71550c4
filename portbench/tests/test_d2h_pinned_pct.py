"""The reader of the share of copied-back bytes that landed in pinned host
memory (``portbench/metrics/d2h_pinned_pct.stream.py``), on stub counters."""

from __future__ import annotations

import pytest

from portbench import readers
from portbench.readers import Context

import bench_cells  # noqa: F401  (puts the checkout on the path)

NAME = "d2h_pinned_pct.stream"
FRAME_BYTES = 6220800


@pytest.fixture
def counters(monkeypatch):
    """The program's counters, as a dict the test fills."""
    from dither_pie_tpu_torch.api import profiling

    read = {}
    monkeypatch.setattr(profiling, "counters", lambda: dict(read))
    return read


def test_equal_counters_read_100(counters):
    counters.update({"transfer.d2h_bytes": 32 * FRAME_BYTES,
                     "transfer.d2h_pinned_bytes": 32 * FRAME_BYTES})
    assert readers.read_metric(NAME, Context(kind="stream", trace=None)) == pytest.approx(100.0)


def test_a_partly_pinned_copy_reads_its_share(counters):
    counters.update({"transfer.d2h_bytes": 32 * FRAME_BYTES,
                     "transfer.d2h_pinned_bytes": 8 * FRAME_BYTES})
    assert readers.read_metric(NAME, Context(kind="stream", trace=None)) == pytest.approx(25.0)


def test_an_image_run_reads_nothing(counters):
    counters.update({"transfer.d2h_bytes": FRAME_BYTES,
                     "transfer.d2h_pinned_bytes": FRAME_BYTES})
    assert readers.read_metric(NAME, Context(kind="image", trace=None)) is None


def test_a_program_without_the_pinned_counter_reads_nothing(counters):
    counters["transfer.d2h_bytes"] = 32 * FRAME_BYTES
    assert readers.read_metric(NAME, Context(kind="stream", trace=None)) is None

"""What a per-layer metric's reader is given, and the helpers readers share.

Each per-layer metric of ``BENCHMARK.json`` has its reader in
``metrics/<name>.py``: a function ``read(ctx)`` that returns the metric's
value, or ``None`` when the run holds nothing for it to read (the metric
is then left out of the result's line). A reader never returns 0 for a
share of a roofline.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from portbench import stats
from portbench.cells import load_module
from portbench.trace import Trace

# The kernel K2 of ``kernels/csrc/ed_scan.cu``.
SCAN_KERNEL = "ed_scan_kernel"


@dataclass
class Context:
    """``kind``: the traffic's kind ("stream" or "image"); ``trace``: the
    traced window, None in an untraced run; ``counters``: "launches" (the
    change of the program's launch total over the window), "batches",
    "frames", "calls"; ``scan``: ``roofline.scan_work`` of one scan launch
    at the cell's shape; ``latencies``: seconds from hand-over to emit of
    each frame emitted in the window (stream), each call's wall (image);
    ``seconds``: the window's length."""

    kind: str
    trace: Optional[Trace]
    counters: Dict[str, int] = field(default_factory=dict)
    scan: Dict[str, float] = field(default_factory=dict)
    latencies: List[float] = field(default_factory=list)
    seconds: float = 0.0


def read_metric(name: str, ctx: Context) -> Optional[float]:
    """The value of per-layer metric ``name`` from its reader file."""
    value = load_module("metrics", name).read(ctx)
    return None if value is None else float(value)


def p95_ms(ctx: Context, kind: str) -> Optional[float]:
    """95th percentile of every latency of the window, in ms."""
    if ctx.kind != kind or not ctx.latencies:
        return None
    return stats.percentile(ctx.latencies, 95) * 1e3


def frames_per_s(ctx: Context) -> Optional[float]:
    """Frames emitted inside the window over its length (stream)."""
    if ctx.kind != "stream" or not ctx.latencies or ctx.seconds <= 0:
        return None
    return stats.rate(len(ctx.latencies), ctx.seconds)


def launches_per_batch(ctx: Context) -> Optional[float]:
    if ctx.kind != "stream" or not ctx.counters.get("batches"):
        return None
    return ctx.counters["launches"] / ctx.counters["batches"]


def kernel_ms_per_frame(ctx: Context) -> Optional[float]:
    """Summed device time of every kernel in the window (copies and memsets
    left out) over the frames handed in it, each of which the window
    dithered (an image a call), in ms."""
    if ctx.trace is None or not ctx.counters.get("frames"):
        return None
    if not ctx.trace.device_intervals({"kernel"}):
        return None
    return ctx.trace.device_seconds({"kernel"}) / ctx.counters["frames"] * 1e3


def mean_ms(spans: List[Tuple[int, int]]) -> Optional[float]:
    if not spans:
        return None
    return sum(e - s for s, e in spans) / len(spans) * 1e-6


def _units(ctx: Context, kind: str) -> int:
    return ctx.counters.get("batches" if kind == "stream" else "calls", 0)


def device_ms_per_unit(ctx: Context, kind: str, kinds, name_has: Optional[str] = None
                       ) -> Optional[float]:
    """Device time of the matching operations a batch (stream) or a call
    (image), in ms; None outside its kind, untraced, or when none ran."""
    if ctx.kind != kind or ctx.trace is None or not _units(ctx, kind):
        return None
    if not ctx.trace.device_intervals(kinds, name_has):
        return None
    return ctx.trace.device_seconds(kinds, name_has) / _units(ctx, kind) * 1e3


def scan_roofline_pct(ctx: Context, kind: str) -> Optional[float]:
    """K2's least time, launches times ``ctx.scan["bound_s"]``, over its
    device time, in percent."""
    if ctx.kind != kind or ctx.trace is None or not ctx.scan:
        return None
    launches = ctx.trace.device_intervals({"kernel"}, SCAN_KERNEL)
    if not launches:
        return None
    busy = sum(e - s for s, e in launches) * 1e-9
    return len(launches) * ctx.scan["bound_s"] / busy * 100.0


def idle_pct(ctx: Context, kind: str) -> Optional[float]:
    if (ctx.kind != kind or ctx.trace is None or ctx.trace.window_seconds <= 0
            or not ctx.trace.device_intervals()):
        return None
    return (1.0 - ctx.trace.busy_seconds() / ctx.trace.window_seconds) * 100.0


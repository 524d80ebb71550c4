"""Per-layer readings of the program's own spans and counters.

The program marks its layers with ``record_function`` ranges
(``dither_pie_tpu_torch/api/profiling.py``: ``transfer.h2d``,
``device.wait``, ...), which a traced run finds among the trace's host
ranges, on the profiler's clock. It counts bytes and frames in counters
that ``profiling.counters()`` returns, cumulative over the process; the
warm-up runs the cell's own shapes, so a ratio of two of them is the
window's. Both readings return None where the program has no such span
or counter (a program older than them), so the metric is left out.
"""

from __future__ import annotations

from typing import Optional

from portbench.readers import Context

# The unit a span's time is spread over, by traffic kind.
_UNIT = {"stream": "batches", "image": "calls"}


def span_ms_per_unit(ctx: Context, kind: str, name: str) -> Optional[float]:
    """The summed length of the program's ``name`` spans inside the traced
    window, each clipped to it, over the window's batches (stream) or calls
    (image), in ms; None outside its kind, untraced, or where no such span
    reaches into the window."""
    if ctx.kind != kind or ctx.trace is None or not ctx.counters.get(_UNIT[kind]):
        return None
    lo, hi = ctx.trace.window
    clipped = [min(e, hi) - max(s, lo) for s, e in ctx.trace.spans(name)]
    clipped = [d for d in clipped if d > 0]
    if not clipped:
        return None
    return sum(clipped) / ctx.counters[_UNIT[kind]] * 1e-6


def counter_ratio(ctx: Context, kind: str, num: str, den: str,
                  scale: float = 1.0) -> Optional[float]:
    """The program's counter ``num`` over its counter ``den``, times
    ``scale``; None outside its kind or where either counter is missing or
    ``den`` is 0."""
    if ctx.kind != kind:
        return None
    from dither_pie_tpu_torch.api import profiling

    read = getattr(profiling, "counters", None)
    if read is None:
        return None
    c = read()
    if num not in c or not c.get(den):
        return None
    return c[num] / c[den] * scale

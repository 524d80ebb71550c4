"""The program's ``video.wait`` spans a batch: the main thread blocked on
the oldest batch in flight."""

from portbench import spans


def read(ctx):
    return spans.span_ms_per_unit(ctx, "stream", "video.wait")

"""The program's ``video.stack`` spans a batch: ``np.stack`` of a batch's
frames on a dither worker, outside ``video.dither_batch``."""

from portbench import spans


def read(ctx):
    return spans.span_ms_per_unit(ctx, "stream", "video.stack")

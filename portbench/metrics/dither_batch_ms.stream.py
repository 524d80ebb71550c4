"""Mean length of the program's own ``video.dither_batch`` stage spans."""

from portbench import readers


def read(ctx):
    if ctx.kind != "stream" or ctx.trace is None:
        return None
    spans = ctx.trace.spans("video.dither_batch")
    return readers.mean_ms(spans)

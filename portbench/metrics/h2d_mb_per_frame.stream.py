"""MB of frames copied to the card a frame that entered a dither path: the
program's ``transfer.h2d_bytes`` over its ``facade.frames`` counter."""

from portbench import spans


def read(ctx):
    return spans.counter_ratio(ctx, "stream", "transfer.h2d_bytes", "facade.frames", 1e-6)

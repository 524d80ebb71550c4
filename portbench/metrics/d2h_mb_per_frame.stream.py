"""MB of frames copied back from the card a frame that entered a dither
path: the program's ``transfer.d2h_bytes`` over its ``facade.frames``
counter."""

from portbench import spans


def read(ctx):
    return spans.counter_ratio(ctx, "stream", "transfer.d2h_bytes", "facade.frames", 1e-6)

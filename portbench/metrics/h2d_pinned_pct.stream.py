"""The share of the bytes sent to the card that left from a pinned host
block: the program's ``transfer.h2d_pinned_bytes`` over its
``transfer.h2d_bytes`` counter, in %. None for a program without the
pinned counter."""

from portbench import spans


def read(ctx):
    return spans.counter_ratio(ctx, "stream", "transfer.h2d_pinned_bytes",
                               "transfer.h2d_bytes", 100.0)

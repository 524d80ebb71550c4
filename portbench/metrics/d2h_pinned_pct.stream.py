"""The share of the bytes copied back from the card that landed in a pinned
host block: the program's ``transfer.d2h_pinned_bytes`` over its
``transfer.d2h_bytes`` counter, in %. None for a program without the
pinned counter."""

from portbench import spans


def read(ctx):
    return spans.counter_ratio(ctx, "stream", "transfer.d2h_pinned_bytes",
                               "transfer.d2h_bytes", 100.0)

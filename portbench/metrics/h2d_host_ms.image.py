"""The program's ``transfer.h2d`` spans a call: the host's side of the
float32 frame's copy to the card."""

from portbench import spans


def read(ctx):
    return spans.span_ms_per_unit(ctx, "image", "transfer.h2d")

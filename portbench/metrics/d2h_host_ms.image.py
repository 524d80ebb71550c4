"""The program's ``transfer.d2h`` spans a call: the host's side of the
result's copy back."""

from portbench import spans


def read(ctx):
    return spans.span_ms_per_unit(ctx, "image", "transfer.d2h")

"""The program's ``transfer.d2h`` spans a batch: the host's side of the
result's copy back (``.cpu().numpy()``)."""

from portbench import spans


def read(ctx):
    return spans.span_ms_per_unit(ctx, "stream", "transfer.d2h")

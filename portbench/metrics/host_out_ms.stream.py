"""The program's ``facade.host_out`` spans a batch: the facade's host work
after the copy back (``astype``, ``_from_dither``)."""

from portbench import spans


def read(ctx):
    return spans.span_ms_per_unit(ctx, "stream", "facade.host_out")

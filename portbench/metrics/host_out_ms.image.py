"""The program's ``facade.host_out`` spans a call: the facade's host work
after the copy back, up to the PIL image it returns."""

from portbench import spans


def read(ctx):
    return spans.span_ms_per_unit(ctx, "image", "facade.host_out")

"""The program's ``device.wait`` spans a batch: the worker waiting for its
stream's kernels before the copy back."""

from portbench import spans


def read(ctx):
    return spans.span_ms_per_unit(ctx, "stream", "device.wait")

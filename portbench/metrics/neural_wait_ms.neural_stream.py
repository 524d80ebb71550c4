"""The program's ``neural.wait`` spans a batch: the copy back of the /4
samples, the wait for the forward's kernels inside it."""

from portbench import neural_work


def read(ctx):
    return neural_work.span_ms_per_batch(ctx, "neural.wait")

"""Hand-written kernel launches a batch: the change of the program's own
``kernels.build.LAUNCHES`` total over the window, over the batches."""

from portbench import readers


def read(ctx):
    return readers.launches_per_batch(ctx)

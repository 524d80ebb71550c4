"""Hand-written kernel launches a batch (as ``launches_per_batch.stream``)."""

from portbench import readers


def read(ctx):
    return readers.launches_per_batch(ctx)

"""The program's ``neural.host_in`` spans a batch: the PIL resize of each
frame to the net's input, the crop and the uint8 concat."""

from portbench import neural_work


def read(ctx):
    return neural_work.span_ms_per_batch(ctx, "neural.host_in")

"""The program's ``neural.host_out`` spans a batch: ``upsample4_u8`` and the
PIL resize of each frame to its even size."""

from portbench import neural_work


def read(ctx):
    return neural_work.span_ms_per_batch(ctx, "neural.host_out")

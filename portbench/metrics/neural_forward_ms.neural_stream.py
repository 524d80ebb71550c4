"""The program's ``neural.forward`` spans a batch: the host's dispatch of
C2PGen and AliasNet (after the copy to the card)."""

from portbench import neural_work


def read(ctx):
    return neural_work.span_ms_per_batch(ctx, "neural.forward")

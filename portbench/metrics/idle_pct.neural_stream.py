"""Share of the traced window in which nothing ran on the card."""

from portbench import neural_work, readers


def read(ctx):
    return readers.idle_pct(ctx, neural_work.KIND)

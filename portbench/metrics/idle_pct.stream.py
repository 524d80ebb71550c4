"""Share of the traced window in which nothing ran on the card."""

from portbench import readers


def read(ctx):
    return readers.idle_pct(ctx, "stream")

"""Model FLOPs of the frames emitted inside the window (``neural_work``)
over the window's seconds, as a share of the card's bf16 peak, in %."""

from portbench import neural_work


def read(ctx):
    return neural_work.mfu_pct(ctx)

"""The forwards' least time (the handed frames' FLOPs, ``neural_work``, at
the bf16 peak) over the device time of every kernel in the window but the
dither's K1, K2 and K3, in %."""

from portbench import neural_work


def read(ctx):
    return neural_work.roofline_pct(ctx)

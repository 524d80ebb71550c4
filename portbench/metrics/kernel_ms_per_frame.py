"""End to end, from the card's trace: the summed device time of every
kernel that ran in the window over the frames it dithered (an image a
call), in ms. What a frame costs the card in compute, whoever else shares
the host; copies are left out, since a pageable copy's device time is the
host's memcpy behind it."""

from portbench import readers


def read(ctx):
    return readers.kernel_ms_per_frame(ctx)

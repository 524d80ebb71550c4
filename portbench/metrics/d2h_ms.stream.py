"""Device-to-host copy time on the card a batch."""

from portbench import readers


def read(ctx):
    return readers.device_ms_per_unit(ctx, "stream", {"d2h"})

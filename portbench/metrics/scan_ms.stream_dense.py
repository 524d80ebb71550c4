"""Device time of the scan K2 (``ed_scan_kernel``) a batch."""

from portbench import readers


def read(ctx):
    return readers.device_ms_per_unit(ctx, "stream", {"kernel"}, readers.SCAN_KERNEL)

"""Device time of the scan K2 (``ed_scan_kernel``) a call."""

from portbench import readers


def read(ctx):
    return readers.device_ms_per_unit(ctx, "image", {"kernel"}, readers.SCAN_KERNEL)

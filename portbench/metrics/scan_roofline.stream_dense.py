"""K2's least time over its device time, in percent (``roofline.scan_work``)."""

from portbench import readers


def read(ctx):
    return readers.scan_roofline_pct(ctx, "stream")

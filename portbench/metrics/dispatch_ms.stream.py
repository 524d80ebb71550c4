"""The program's ``ops.ed_dispatch`` spans a batch: ``ed_batch_wavefront``'s
host side: the plan, the allocations, enqueueing K1, K2 and K3."""

from portbench import spans


def read(ctx):
    return spans.span_ms_per_unit(ctx, "stream", "ops.ed_dispatch")

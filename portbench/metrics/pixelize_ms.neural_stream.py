"""The pipeline's ``video.pixelize`` spans a batch: the main thread's whole
pixelize stage (host prep, the forward, the copy back, the host epilogue)."""

from portbench import neural_work


def read(ctx):
    return neural_work.span_ms_per_batch(ctx, "video.pixelize")

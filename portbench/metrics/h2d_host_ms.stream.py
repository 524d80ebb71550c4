"""The program's ``transfer.h2d`` spans a batch: the host's side of the
frames' copy to the card (``_frames_tensor``'s ``.to(device)``)."""

from portbench import spans


def read(ctx):
    return spans.span_ms_per_unit(ctx, "stream", "transfer.h2d")

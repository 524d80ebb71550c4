"""95th percentile, over every frame emitted in the window, of emit time
less the moment the source handed the frame to ``process_frames`` (as
``frame_p95_ms.stream``, in the dense-palette stream)."""

from portbench import readers


def read(ctx):
    return readers.p95_ms(ctx, "stream")

"""95th percentile, over every frame emitted in the window, of emit time
less the moment the source handed the frame to ``process_frames``. The
stream's source is always ready, so the queue stays full: the tail follows
the pipeline's depth over its rate and swings with both."""

from portbench import readers


def read(ctx):
    return readers.p95_ms(ctx, "stream")

"""95th percentile, over every ``apply_dithering`` call started in the
window, of its wall (PIL image in, PIL image out): the single-image
caller's tail, per layer where the shared host moves it from run to run by
more than an end-to-end bound can hold."""

from portbench import readers


def read(ctx):
    return readers.p95_ms(ctx, "image")

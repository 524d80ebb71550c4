"""The program's ``facade.host_in`` spans a call: the facade's host work
before the copy to the card (PIL ``convert``, ``np.array``, the float32
frame)."""

from portbench import spans


def read(ctx):
    return spans.span_ms_per_unit(ctx, "image", "facade.host_in")

"""Frames ``process_frames`` emitted inside the window over its length, in
the stream with the neural pixelize stage."""

from portbench import neural_work


def read(ctx):
    return neural_work.frames_per_s(ctx)

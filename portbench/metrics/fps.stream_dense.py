"""Frames ``process_frames`` emitted inside the window over its length: the
stream's rate, per layer in a cell where the shared host moves it from run
to run by more than an end-to-end bound can hold."""

from portbench import readers


def read(ctx):
    return readers.frames_per_s(ctx)

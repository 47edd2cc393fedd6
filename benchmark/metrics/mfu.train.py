"""Model FLOP utilisation of the window: model FLOPs over time at the peak."""

from benchlib.readers import mfu


def read(ctx):
    return mfu(ctx)

"""Elementwise and copy kernels' share of the traced unit's device time."""

from benchlib.readers import elementwise_share


def read(ctx):
    return elementwise_share(ctx)

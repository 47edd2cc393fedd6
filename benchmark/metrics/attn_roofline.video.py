"""The flash-attention kernels' share of their roofline in the traced unit."""

from benchlib.readers import attention_roofline


def read(ctx):
    return attention_roofline(ctx)

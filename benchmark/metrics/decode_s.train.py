"""Seconds per GRPO iteration in the trainer's decode stage (its synchronised
host timer, ``metrics["decode_time"]``), mean over the window's iterations."""

from benchlib.readers import unit_mean


def read(ctx):
    return unit_mean(ctx, "decode_time")

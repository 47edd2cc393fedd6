"""Seconds per GRPO iteration in the trainer's update stage (its synchronised
host timer, ``metrics["update_time"]``), mean over the window's iterations."""

from benchlib.readers import unit_mean


def read(ctx):
    return unit_mean(ctx, "update_time")

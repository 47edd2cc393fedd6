"""Seconds per GRPO iteration in the trainer's reward stage (its synchronised
host timer, ``metrics["reward_time"]``), mean over the window's iterations."""

from benchlib.readers import unit_mean


def read(ctx):
    return unit_mean(ctx, "reward_time")

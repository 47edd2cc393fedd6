"""Seconds per GRPO iteration in the trainer's rollout stage (its synchronised
host timer, ``metrics["rollout_time"]``), mean over the window's iterations."""

from benchlib.readers import unit_mean


def read(ctx):
    return unit_mean(ctx, "rollout_time")

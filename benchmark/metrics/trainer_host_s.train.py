"""Seconds per GRPO iteration that the trainer spends on the host before
the rollout and after the update, outside its four synchronised stage
timers, the device idle (``metrics["host_time"]``), mean over the window's
iterations."""

from benchlib.readers import unit_mean


def read(ctx):
    return unit_mean(ctx, "host_time")

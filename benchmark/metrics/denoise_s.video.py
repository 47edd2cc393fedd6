"""Seconds per video in the pipeline's denoise stage: the synchronised span
that the benchmark puts around the pipeline instance's ``_sample``, mean over the
window's videos."""

from benchlib.readers import unit_mean


def read(ctx):
    return unit_mean(ctx, "denoise_time")

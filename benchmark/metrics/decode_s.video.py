"""Seconds per video in the pipeline's decode stage: the synchronised span
that the benchmark puts around the pipeline instance's ``_decode``, mean over the
window's videos."""

from benchlib.readers import unit_mean


def read(ctx):
    return unit_mean(ctx, "decode_time")

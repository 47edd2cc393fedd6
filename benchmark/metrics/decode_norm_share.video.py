"""Share (%) of the traced video's decode device time in GroupNorm with its
SiLU: the ``norm`` spans under ``decode`` over the ``decode`` span."""

from benchlib import spans


def read(ctx):
    return spans.share(spans.record(), "norm", "decode", "video")

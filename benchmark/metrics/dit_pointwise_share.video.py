"""Share (%) of the denoise's timed DiT calls' device time outside their matrix
products (``gemm``) and attention kernel calls (``attn``), in the traced
video."""

from benchlib import spans


def read(ctx):
    return spans.dit_pointwise_share(spans.record(), "denoise")

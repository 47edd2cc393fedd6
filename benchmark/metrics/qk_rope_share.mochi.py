"""Share (%) of the traced video's sampled DiT calls' device time in Mochi's
eager QK-norm, learned RoPE and joint concatenation: the ``qk_rope`` spans
under ``dit`` over the ``dit`` spans under ``denoise``."""

from benchlib import spans


def read(ctx):
    return spans.share(spans.record(), "qk_rope", "dit", "denoise")

"""Share (%) of the rollout's timed DiT calls' device time outside their matrix
products (``gemm``) and attention kernel calls (``attn``): the pointwise
work of norms, modulation, QK-norm, RoPE, gates, residuals, GELU, casts and
copies, in the traced iteration."""

from benchlib import spans


def read(ctx):
    return spans.dit_pointwise_share(spans.record(), "rollout")

"""Model FLOPs of Mochi-1: the asymmetric joint DiT and its causal VAE
decoder, counted from shapes as ``flops.py`` counts the FLUX-block models:
each matrix product once, as 2 * m * n * k, and each attention as its two
products over the real tokens."""

from __future__ import annotations


def _gemm(tokens, din, dout):
    return 2 * tokens * din * dout


def mochi_dit_flops(cfg: dict, B: int, L_vis: int, L_txt: int) -> dict:
    """Forward FLOPs of one Mochi DiT call on B samples of ``L_vis`` video
    and ``L_txt`` (valid) text tokens: {"gemm", "attention"}.  ``cfg`` is
    the configuration file's: num_layers blocks, the last the final
    (``context_pre_only``) block that takes visual queries only and leaves
    the text stream; the pool's single query over [mean | text]."""
    H, D = cfg["num_attention_heads"], cfg["attention_head_dim"]
    d, td, te = H * D, cfg["pooled_projection_dim"], cfg["text_embed_dim"]
    fi, fci = cfg["ff_inner_dim"], cfg["ff_context_inner_dim"]
    patch = cfg["patch_size"] ** 2 * cfg["in_channels"]
    S = L_vis + L_txt
    gemm = _gemm(B * L_vis, patch, d) + _gemm(B, cfg["time_embed_dim"], d) + _gemm(B, d, d)
    gemm += _gemm(B * (L_txt + 1), te, 2 * te) + _gemm(B, te, te) + _gemm(B, te, d)
    attention = 4 * B * (L_txt + 1) * te  # the pool's one query over every head
    gemm += _gemm(B * L_txt, te, td)
    visual = _gemm(B * L_vis, d, 3 * d) + _gemm(B * L_vis, d, d) \
        + _gemm(B * L_vis, d, 2 * fi) + _gemm(B * L_vis, fi, d)
    text_kv = _gemm(B * L_txt, td, 2 * d)
    text_rest = _gemm(B * L_txt, td, d) + _gemm(B * L_txt, d, td) \
        + _gemm(B * L_txt, td, 2 * fci) + _gemm(B * L_txt, fci, td)
    n = cfg["num_layers"] - 1
    gemm += n * (_gemm(B, d, 4 * d) + _gemm(B, d, 4 * td) + visual + text_kv + text_rest)
    attention += n * 4 * B * H * S * S * D
    gemm += _gemm(B, d, 4 * d) + _gemm(B, d, 2 * td) + visual + text_kv
    attention += 4 * B * H * L_vis * S * D
    gemm += _gemm(B, d, 2 * d) + _gemm(B * L_vis, d, patch)
    return {"gemm": gemm, "attention": attention}


def mochi_decoder_flops(vcfg: dict, B: int, T: int, h: int, w: int) -> int:
    """FLOPs of the Mochi VAE decoder on B latents of T frames of h x w:
    every convolution at its output size (3x3x3 in the ResNets, 1x1x1 in
    and out) and each up block's channel Linear; time grows to te T -
    (te - 1) and space by se in each up block."""
    chans = list(vcfg["block_out_channels"])
    layers = list(vcfg["layers_per_block"])  # outermost first
    tex, sex = list(vcfg["temporal_expansions"]), list(vcfg["spatial_expansions"])
    c3 = lambda t, H, W, k, ci, co: 2 * B * t * H * W * k ** 3 * ci * co
    res = lambda t, H, W, c: 2 * c3(t, H, W, 3, c, c)
    top = chans[-1]
    f = c3(T, h, w, 1, vcfg["latent_channels"], top) + layers[-1] * res(T, h, w, top)
    t, H, W, cin = T, h, w, top
    for i in reversed(range(len(chans) - 1)):  # the up blocks, innermost first
        te, se, cout = tex[i], sex[i], chans[i]
        f += layers[i + 1] * res(t, H, W, cin)
        f += 2 * B * t * H * W * cin * cout * te * se * se
        t, H, W, cin = te * t - (te - 1), se * H, se * W, cout
    f += layers[0] * res(t, H, W, cin)
    return f + c3(t, H, W, 1, cin, vcfg["out_channels"])

"""Operations and bytes counted from shapes: the least work that each call
or model step needs, for the roofline shares and the model FLOP utilisation.

Model FLOPs count each matrix product once, as 2 * m * n * k, and each
attention as its two products (scores and values) over the real tokens,
with no padding.  They leave out what an implementation adds: recomputation
for memory (remat), and under LoRA the frozen base's weight gradients.

The attention bounds follow the kernel's call: the larger of its products
at the bf16 peak and its bytes (each input read once, each output written
once) at the HBM rate.  ``attention_call`` copies the arithmetic of
``chip_smoke.py``'s ``attention_bound_ms`` and ``train_bound_ms``.
"""

from __future__ import annotations

# products of S x kv_len x D in one call of each attention kernel: the
# forward's scores and values; the fused backward recomputes the scores and
# forms dP, dV, dQ and dK; dkv does all but dQ; dq all but dK and dV
ATTN_PRODUCTS = {"flash_attn_fwd": 2, "flash_attn_fwd_lse": 2, "flash_attn_bwd_fused": 5,
                 "flash_attn_bwd_dkv": 4, "flash_attn_bwd_dq": 3}


def attention_call(kernel: str, B: int, H: int, S: int, Sk: int, kv_len: int, D: int,
                   bias: bool = False):
    """(FLOP, bytes) of one call of ``kernel`` on bf16 (B, H, S, D) queries
    and (B, H, Sk, D) keys and values of which the first ``kv_len`` are
    valid, with an f32 (B, Sk) key bias when ``bias``.  Keys past kv_len are
    never visited, so they count no work."""
    flop = ATTN_PRODUCTS[kernel] * 2 * B * H * S * kv_len * D
    row_q, row_k = 2 * B * H * S * D, 2 * B * H * Sk * D  # one bf16 tensor
    lse, kb = 4 * B * H * S, (4 * B * Sk if bias else 0)
    nbytes = {"flash_attn_fwd": 2 * row_q + 2 * row_k + kb,
              "flash_attn_fwd_lse": row_q + 2 * row_k + kb + row_q + lse,
              "flash_attn_bwd_fused": 3 * row_q + 2 * row_k + lse + kb + row_q + 2 * row_k,
              "flash_attn_bwd_dkv": 3 * row_q + 2 * row_k + lse + kb + 2 * row_k,
              "flash_attn_bwd_dq": 3 * row_q + 2 * row_k + lse + kb + row_q}[kernel]
    return flop, nbytes


def bound_s(flop: float, nbytes: float, peaks: dict) -> float:
    """Least seconds for ``flop`` bf16 operations and ``nbytes`` of HBM
    traffic on a card with ``peaks`` (``peaks.PEAKS``)."""
    return max(flop / peaks["bf16_flops"], nbytes / peaks["hbm_bytes_per_s"])


def _gemm(tokens, din, dout):
    return 2 * tokens * din * dout


def _attn(B, H, Sq, Sk, D):
    return 4 * B * H * Sq * Sk * D


def mmdit_flops(cfg: dict, B: int, L_img: int, L_txt: int, *, refiner_tokens: int = 0) -> dict:
    """Forward FLOPs of a FLUX-block MMDiT (FLUX.1 and HunyuanVideo) on B
    samples of ``L_img`` image and ``L_txt`` text tokens: {"gemm", "attention"}.
    ``cfg`` holds hidden_size, num_heads, mlp_ratio, depth_double,
    depth_single, in_channels, context_dim, pooled_dim, time_freq_dim and
    guidance_embeds; ``refiner_tokens`` adds HunyuanVideo's token refiner
    (``refiner_depth`` blocks on the text tokens)."""
    h, H = cfg["hidden_size"], cfg["num_heads"]
    D, mh = h // H, int(h * cfg["mlp_ratio"])
    S = L_img + L_txt
    tfd = cfg["time_freq_dim"]
    gemm = _gemm(B * L_img, cfg["in_channels"], h) + _gemm(B * L_txt, cfg["context_dim"], h)
    embedders = 2 if cfg.get("guidance_embeds") else 1
    gemm += embedders * (_gemm(B, tfd, h) + _gemm(B, h, h))
    gemm += _gemm(B, cfg["pooled_dim"], h) + _gemm(B, h, h)
    per_stream = lambda n: _gemm(B * n, h, 3 * h) + _gemm(B * n, h, h) \
        + _gemm(B * n, h, mh) + _gemm(B * n, mh, h)
    dd, ds = cfg["depth_double"], cfg["depth_single"]
    gemm += dd * (2 * _gemm(B, h, 6 * h) + per_stream(L_img) + per_stream(L_txt))
    gemm += ds * (_gemm(B, h, 3 * h) + _gemm(B * S, h, 3 * h + mh) + _gemm(B * S, h + mh, h))
    gemm += _gemm(B, h, 2 * h) + _gemm(B * L_img, h, cfg["in_channels"])
    attention = (dd + ds) * _attn(B, H, S, S, D)
    if refiner_tokens:
        n, rd = refiner_tokens, cfg["refiner_depth"]
        gemm += rd * (_gemm(B, h, 2 * h) + per_stream(n))
        attention += rd * _attn(B, H, n, n, D)
    return {"gemm": gemm, "attention": attention}


def lora_flops(cfg: dict, B: int, L_img: int, L_txt: int, rank: int) -> int:
    """Forward FLOPs of the unmerged low-rank paths on the FLUX blocks'
    targeted leaves (qkv, attention out, MLP in and out; linear1 and
    linear2): 2 * tokens * rank * (in + out) each."""
    h = cfg["hidden_size"]
    mh = int(h * cfg["mlp_ratio"])
    S = L_img + L_txt
    io = (h + 3 * h) + (h + h) + (h + mh) + (mh + h)
    double = 2 * rank * B * (L_img + L_txt) * io
    single = 2 * rank * B * S * ((h + 3 * h + mh) + (h + mh + h))
    return cfg["depth_double"] * double + cfg["depth_single"] * single


def conv_flops(B, H, W, k, cin, cout):
    return 2 * B * H * W * k * k * cin * cout


def vae_decoder_flops(vcfg: dict, B: int, h: int, w: int) -> int:
    """FLOPs of the FLUX AutoencoderKL decoder on B latents of h x w: every
    convolution and the mid block's single-head attention."""
    chans = list(vcfg["block_out_channels"])
    top, lpb = chans[-1], vcfg["layers_per_block"]
    f = conv_flops(B, h, w, 3, vcfg["latent_channels"], top)
    res = lambda H, W, ci, co: conv_flops(B, H, W, 3, ci, co) + conv_flops(B, H, W, 3, co, co) \
        + (conv_flops(B, H, W, 1, ci, co) if ci != co else 0)
    f += 2 * res(h, w, top, top)
    n = h * w
    f += 4 * _gemm(B * n, top, top) + _attn(B, 1, n, n, top)
    cin, H, W = top, h, w
    rev = list(reversed(chans))
    for bi, cout in enumerate(rev):
        for _ in range(lpb + 1):
            f += res(H, W, cin, cout)
            cin = cout
        if bi < len(rev) - 1:
            H, W = 2 * H, 2 * W
            f += conv_flops(B, H, W, 3, cout, cout)
    return f + conv_flops(B, H, W, 3, chans[0], vcfg["out_channels"])


def clip_tower_flops(B: int, tokens: int, width: int, layers: int) -> int:
    """A pre-LN transformer tower of ``layers`` blocks (qkv, out, 4x MLP)."""
    per = _gemm(B * tokens, width, 3 * width) + _gemm(B * tokens, width, width) \
        + _gemm(B * tokens, width, 4 * width) + _gemm(B * tokens, 4 * width, width) \
        + 4 * B * tokens * tokens * width
    return layers * per


def clip_score_flops(ccfg: dict, B: int) -> int:
    """A CLIP reward on B images and B captions: the patch embedding, both
    towers and both projections."""
    v, t, e = ccfg["vision"], ccfg["text"], ccfg["embed_dim"]
    n_patch = (v["image_size"] // v["patch"]) ** 2
    f = 2 * B * n_patch * v["patch"] ** 2 * 3 * v["width"]
    f += clip_tower_flops(B, n_patch + 1, v["width"], v["layers"]) + _gemm(B, v["width"], e)
    f += clip_tower_flops(B, t["context"], t["width"], t["layers"]) + _gemm(B, t["width"], e)
    return f


def causal_vae_decoder_flops(vcfg: dict, B: int, T: int, h: int, w: int) -> int:
    """FLOPs of HunyuanVideo's causal 3D VAE decoder on B latents of T
    frames of h x w: every 3D convolution (3x3x3, the shortcuts 1x1x1) at
    its output size, and the mid block's per-frame attention; time doubles
    (all but the first frame) in up blocks 1 and 2, space in blocks 0-2."""
    chans = list(vcfg["block_out_channels"])
    top, lpb = chans[-1], vcfg["layers_per_block"]
    c3 = lambda t, H, W, k, ci, co: 2 * B * t * H * W * k ** 3 * ci * co
    res = lambda t, H, W, ci, co: c3(t, H, W, 3, ci, co) + c3(t, H, W, 3, co, co) \
        + (c3(t, H, W, 1, ci, co) if ci != co else 0)
    f = c3(T, h, w, 3, vcfg["latent_channels"], top) + 2 * res(T, h, w, top, top)
    n = h * w
    f += 4 * _gemm(B * T * n, top, top) + _attn(B * T, 1, n, n, top)
    cin, t, H, W = top, T, h, w
    rev = list(reversed(chans))
    for bi, cout in enumerate(rev):
        for _ in range(lpb + 1):
            f += res(t, H, W, cin, cout)
            cin = cout
        if bi < 3:
            H, W = 2 * H, 2 * W
            if 1 <= bi < len(rev) - 1:
                t = 1 + 2 * (t - 1)
            f += c3(t, H, W, 3, cout, cout)
    return f + c3(t, H, W, 3, chans[0], vcfg["out_channels"])

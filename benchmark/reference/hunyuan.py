"""HunyuanVideo's MMDiT forward in plain PyTorch.

From the published HunyuanVideo (tencent/HunyuanVideo, ``hyvideo/modules/
models.py``, ``token_refiner.py``, ``posemb_layers.py``): latents patched
1 x 2 x 2 into tokens of (dy, dx, channel) entries; the LLM text states
through the token refiner (a linear input embedding; a conditioning of the
timestep and the mask-weighted mean of the text states, each through a SiLU
MLP; self-attention blocks with affine LayerNorms, SiLU MLPs and gates
from the conditioning, every query keeping the first key); a conditioning
vector of timestep, pooled CLIP and embedded guidance; the FLUX double and
single blocks (``reference/flux.py``) over [text | video] with the text
mask on the keys and 3-axis RoPE of (frame, row, col) at theta 256 (text
unrotated); a final layer modulated by (shift, scale).  The flow time
enters unquantised, times 1000.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference import flux as R


def rope_tables(T, h, w, text_len, axes, theta, device):
    f = torch.arange(T, dtype=torch.float32, device=device)
    r = torch.arange(h, dtype=torch.float32, device=device)
    c = torch.arange(w, dtype=torch.float32, device=device)
    grid = torch.stack(torch.meshgrid(f, r, c, indexing="ij"), -1).reshape(-1, 3)
    pos = torch.cat([torch.zeros(text_len, 3, device=device), grid])
    cos, sin = [], []
    for a, d in enumerate(axes):
        freq = theta ** (-torch.arange(0, d, 2, dtype=torch.float32, device=device) / d)
        ang = pos[:, a:a + 1] * freq
        cos.append(torch.cos(ang).repeat_interleave(2, -1))
        sin.append(torch.sin(ang).repeat_interleave(2, -1))
    return torch.cat(cos, -1), torch.cat(sin, -1)


def _ln_affine(p, x, eps=1e-6):
    return F.layer_norm(x.float(), x.shape[-1:], p["scale"].float(), p["bias"].float(),
                        eps).to(x.dtype)


def _attention_p_rounded(q, k, v, mask):
    """Softmax attention with scores and softmax in f32 and the
    probabilities rounded to v's dtype before the product (as the
    program's eager attention in the token refiner)."""
    s = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    s.masked_fill_(~mask[:, None, None, :], float("-inf"))
    return (torch.softmax(s, -1).to(v.dtype).float() @ v.float()).to(v.dtype)


def refine(p, txt, t1000, mask, heads, tfd, dt):
    """The token refiner over LLM states ``txt`` (B, L, D_text) f32."""
    c = R.mlp_embed(p["t_embedder"], R.sinusoid(t1000, tfd).to(dt))
    m = mask.float()[..., None]
    ctx = (txt.float() * m).sum(1) / m.sum(1).clamp_min(1e-6)
    c = c + R.mlp_embed(p["c_embedder"], ctx.to(dt))
    x = R.linear(txt.to(dt), p["input_embedder"])
    keys = mask.bool().clone()
    keys[:, 0] = True
    for b in p["blocks"]:
        g_msa, g_mlp = R.linear(F.silu(c), b["mod"]["lin"]).chunk(2, -1)
        q, k, v = (R._heads(z, heads) for z in R.linear(_ln_affine(b["norm1"], x),
                                                         b["qkv"]).chunk(3, -1))
        x = x + g_msa[:, None] * R.linear(R._merge(_attention_p_rounded(q, k, v, keys)),
                                          b["proj"])
        h = R.linear(F.silu(R.linear(_ln_affine(b["norm2"], x), b["mlp_in"])), b["mlp_out"])
        x = x + g_mlp[:, None] * h
    return x


PAD = 128  # the joint sequence's padding, as the program's


def embed(p, cfg, latents, txt, pooled, t, guidance, mask, dt=torch.bfloat16):
    """The DiT's inputs to its first block, of latents (B, T, H, W, C) at
    flow time ``t`` (B,), f32 text states ``txt`` (B, L, D) with ``mask``
    (B, L) 1 for text tokens, ``pooled`` (B, D2): a dict of the video
    tokens ``x``, the refined text tokens ``c``, the conditioning ``vec``,
    the RoPE tables and the key mask.  As the program does, the video
    tokens are padded with zero tokens (identity RoPE, masked keys) to a
    multiple of ``PAD`` joint tokens when there are at least 8 x ``PAD``."""
    B, T, H, W, C = latents.shape
    heads = cfg["num_heads"]
    x = latents.reshape(B, T, H // 2, 2, W // 2, 2, C).permute(0, 1, 2, 4, 3, 5, 6)
    x = R.linear(x.reshape(B, T * (H // 2) * (W // 2), 4 * C).to(dt), p["img_in"])
    t1000 = t * 1000.0
    tfd = cfg["time_freq_dim"]
    c = refine(p["txt_in"], txt, t1000, mask, heads, tfd, dt)
    vec = R.mlp_embed(p["time_in"], R.sinusoid(t1000, tfd).to(dt))
    vec = vec + R.mlp_embed(p["vector_in"], pooled.to(dt))
    vec = vec + R.mlp_embed(p["guidance_in"], R.sinusoid(guidance * 1000.0, tfd).to(dt))
    cos, sin = rope_tables(T, H // 2, W // 2, txt.shape[1], tuple(cfg["rope_dim_list"]),
                           cfg["rope_theta"], latents.device)
    L_img = x.shape[1]
    S = txt.shape[1] + L_img
    npad = (-S) % PAD if S >= 8 * PAD else 0
    if npad:
        x = F.pad(x, (0, 0, 0, npad))
        cos = torch.cat([cos, cos.new_ones((npad, cos.shape[1]))])
        sin = torch.cat([sin, sin.new_zeros((npad, sin.shape[1]))])
    keys = torch.cat([mask.bool(), torch.ones(B, L_img, dtype=torch.bool, device=x.device),
                      torch.zeros(B, npad, dtype=torch.bool, device=x.device)], 1)
    return {"x": x, "c": c, "vec": vec, "cos": cos, "sin": sin, "keys": keys,
            "heads": heads, "L_txt": txt.shape[1], "L_img": L_img, "shape": (B, T, H, W, C)}


def double(p, e, i, x, c):
    """Double block ``i`` on video tokens ``x`` and text tokens ``c``, q
    scaled in bf16 before the scores as the program's kernel takes it."""
    return R.double_block(p["double"], i, x, c, e["vec"], e["cos"], e["sin"], e["heads"],
                          mask=e["keys"], prescale=True)


def single(p, e, i, j):
    """Single block ``i`` on the joint tokens [text | video | pad] ``j``,
    q scaled in bf16 before the scores."""
    return R.single_block(p["single"], i, j, e["vec"], e["cos"], e["sin"], e["heads"],
                          mask=e["keys"], prescale=True)


def final(p, e, j):
    """Velocity (B, T, H, W, C) f32 from the last block's joint tokens ``j``."""
    B, T, H, W, C = e["shape"]
    x = j[:, e["L_txt"]:e["L_txt"] + e["L_img"]]
    shift, scale = R.linear(F.silu(e["vec"]), p["final_mod"]["lin"]).chunk(2, -1)
    x = R.linear(R.layer_norm(x) * (1 + scale[:, None]) + shift[:, None], p["final_proj"])
    x = x.float().reshape(B, T, H // 2, W // 2, 2, 2, C).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(B, T, H, W, C)

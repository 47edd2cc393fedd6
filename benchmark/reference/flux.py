"""FLUX.1 MMDiT forward in plain PyTorch, with an optional unmerged LoRA.

From the published FLUX.1 architecture (black-forest-labs/flux,
``model.py`` and ``modules/layers.py``): patch-embedded 64-channel image
tokens and T5 text tokens, a conditioning vector (timestep, guidance and
pooled CLIP embeddings, each through a SiLU MLP), double-stream blocks
(separate adaLN modulation, projections and MLPs per stream, one joint
attention over [text | image] with QK RMS-norm and 3-axis RoPE), then
single-stream blocks (fused qkv+MLP input and attention+MLP output), and a
modulated final projection.  Weights are (in, out) matrices in the
program's tree layout, block stacks with a leading depth axis.

Precision follows the configuration (bf16): products in bf16 with f32
accumulation, layer norms, RMS norms, RoPE, scores and softmax in f32.  The
joint sequence is not padded; softmax runs over the real keys.  A LoRA
pair (a, b, scale) adds ``scale * (x @ a) @ b`` beside ``x @ w``: the
same function as the merged weight, computed another way.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

def rope_tables(grid_h: int, grid_w: int, text_len: int, axes=(16, 56, 56),
                theta: float = 10000.0, device="cpu"):
    """cos and sin, (text_len + grid_h * grid_w, sum(axes)) f32: text
    positions (0, 0, 0); image token (r, c) at (0, r, c); each axis rotates
    adjacent feature pairs at frequencies theta^(-2j/d)."""
    r = torch.arange(grid_h, dtype=torch.float32, device=device)
    c = torch.arange(grid_w, dtype=torch.float32, device=device)
    img = torch.stack([torch.zeros(grid_h, grid_w, device=device),
                       r[:, None].expand(grid_h, grid_w),
                       c[None, :].expand(grid_h, grid_w)], dim=-1).reshape(-1, 3)
    pos = torch.cat([torch.zeros(text_len, 3, device=device), img])
    cos, sin = [], []
    for a, d in enumerate(axes):
        freq = theta ** (-torch.arange(0, d, 2, dtype=torch.float32, device=device) / d)
        ang = pos[:, a:a + 1] * freq
        cos.append(torch.cos(ang).repeat_interleave(2, -1))
        sin.append(torch.sin(ang).repeat_interleave(2, -1))
    return torch.cat(cos, -1), torch.cat(sin, -1)


def rope(x, cos, sin):
    """Rotate adjacent pairs (x0, x1) -> (x0 cos - x1 sin, x1 cos + x0 sin), in f32."""
    xf = x.float()
    x0, x1 = xf[..., 0::2], xf[..., 1::2]
    rot = torch.stack([-x1, x0], dim=-1).flatten(-2)
    return (xf * cos + rot * sin).to(x.dtype)


def layer_norm(x, eps=1e-6):
    return F.layer_norm(x.float(), x.shape[-1:], eps=eps).to(x.dtype)


def rms_norm(x, scale, eps=1e-6):
    xf = x.float()
    return (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)).to(x.dtype) * scale


def linear(x, p, lora=None):
    y = x @ p["w"] + p["b"]
    if lora is not None:
        a, b, s = lora
        y = y + (((x.float() @ a) @ b) * s).to(y.dtype)
    return y


def sinusoid(t, dim=256, max_period=10000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    ang = t.float()[:, None] * freqs
    return torch.cat([torch.cos(ang), torch.sin(ang)], -1)


def mlp_embed(p, x):
    return linear(F.silu(linear(x, p["in"])), p["out"])


def attention(q, k, v, mask=None, prescale=False):
    """Softmax attention over (B, H, S, D), scores and softmax in f32;
    ``mask`` (B, Sk) bool keeps the True keys.  ``prescale``: q is scaled
    by 1/sqrt(D), the scale rounded to q's dtype, in q's dtype before the
    scores (where the FLUX attention kernels round)."""
    if prescale:
        q = q * torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype).item()
        s = q.float() @ k.float().transpose(-1, -2)
    else:
        s = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if mask is not None:
        s.masked_fill_(~mask[:, None, None, :], float("-inf"))
    return (torch.softmax(s, -1) @ v.float()).to(v.dtype)


def _heads(x, H):
    B, S, _ = x.shape
    return x.reshape(B, S, H, -1).transpose(1, 2)


def _merge(x):
    B, H, S, D = x.shape
    return x.transpose(1, 2).reshape(B, S, H * D)


def _at(tree, i):
    """Block ``i`` of a stacked tree."""
    return {k: _at(v, i) for k, v in tree.items()} if isinstance(tree, dict) else tree[i]


def _lora_at(lora, stack, name, i):
    if lora is None:
        return None
    f = lora["factors"].get(f"{stack}/{name}/w")
    return None if f is None else (f["a"][i], f["b"][i], lora["scale"])


def double_block(p, i, img, txt, vec, cos, sin, H, lora=None, mask=None, prescale=False):
    w = _at(p, i)
    sv = F.silu(vec)
    im = linear(sv, w["img_mod"]["lin"]).chunk(6, -1)
    tm = linear(sv, w["txt_mod"]["lin"]).chunk(6, -1)
    mod = lambda x, sh, sc: x * (1 + sc[:, None]) + sh[:, None]
    L = lambda n: _lora_at(lora, "double", n, i)
    iq, ik, iv = linear(mod(layer_norm(img), im[0], im[1]), w["img_qkv"],
                        L("img_qkv")).chunk(3, -1)
    tq, tk, tv = linear(mod(layer_norm(txt), tm[0], tm[1]), w["txt_qkv"],
                        L("txt_qkv")).chunk(3, -1)
    iq, ik, iv, tq, tk, tv = (_heads(x, H) for x in (iq, ik, iv, tq, tk, tv))
    iq, ik = rms_norm(iq, w["img_qnorm"]), rms_norm(ik, w["img_knorm"])
    tq, tk = rms_norm(tq, w["txt_qnorm"]), rms_norm(tk, w["txt_knorm"])
    q = rope(torch.cat([tq, iq], 2), cos, sin)
    k = rope(torch.cat([tk, ik], 2), cos, sin)
    o = _merge(attention(q, k, torch.cat([tv, iv], 2), mask, prescale))
    Lt = txt.shape[1]
    img = img + im[2][:, None] * linear(o[:, Lt:], w["img_attn_out"], L("img_attn_out"))
    txt = txt + tm[2][:, None] * linear(o[:, :Lt], w["txt_attn_out"], L("txt_attn_out"))
    h = linear(mod(layer_norm(img), im[3], im[4]), w["img_mlp_in"], L("img_mlp_in"))
    img = img + im[5][:, None] * linear(F.gelu(h, approximate="tanh"), w["img_mlp_out"],
                                        L("img_mlp_out"))
    h = linear(mod(layer_norm(txt), tm[3], tm[4]), w["txt_mlp_in"], L("txt_mlp_in"))
    txt = txt + tm[5][:, None] * linear(F.gelu(h, approximate="tanh"), w["txt_mlp_out"],
                                        L("txt_mlp_out"))
    return img, txt


def single_block(p, i, x, vec, cos, sin, H, lora=None, mask=None, prescale=False):
    w = _at(p, i)
    shift, scale, gate = linear(F.silu(vec), w["mod"]["lin"]).chunk(3, -1)
    h = x.shape[-1]
    xm = layer_norm(x) * (1 + scale[:, None]) + shift[:, None]
    proj = linear(xm, w["linear1"], _lora_at(lora, "single", "linear1", i))
    q, k, v = (_heads(t, H) for t in proj[..., :3 * h].chunk(3, -1))
    q, k = rms_norm(q, w["qnorm"]), rms_norm(k, w["knorm"])
    o = _merge(attention(rope(q, cos, sin), rope(k, cos, sin), v, mask, prescale))
    mlp = F.gelu(proj[..., 3 * h:], approximate="tanh")
    out = linear(torch.cat([o, mlp], -1), w["linear2"], _lora_at(lora, "single", "linear2", i))
    return x + gate[:, None] * out


def flux_forward(p: Dict, cfg: Dict, img, txt, pooled, t, guidance, grid, *,
                 lora: Optional[Dict] = None, checkpoint_blocks: bool = False):
    """Velocity (B, L_img, in_channels) f32 of packed latents ``img`` at
    flow time ``t`` (B,) in [0, 1] with ``guidance`` (B,); ``txt`` (B, L_txt,
    context_dim) and ``pooled`` (B, pooled_dim) in the compute dtype;
    ``grid`` = (rows, cols) of the packed image tokens.  ``lora`` =
    {"factors": {"<stack>/<leaf>/w": {"a", "b"}}, "scale"}.
    ``checkpoint_blocks`` recomputes each block in the backward."""
    dt = txt.dtype
    H = cfg["num_heads"]
    cos, sin = rope_tables(grid[0], grid[1], txt.shape[1], tuple(cfg["axes_dims"]),
                           cfg["theta"], img.device)
    x = linear(img.to(dt), p["x_embedder"])
    c = linear(txt, p["context_embedder"])
    vec = mlp_embed(p["time_in"], sinusoid(t * 1000.0, cfg["time_freq_dim"]).to(dt))
    if cfg["guidance_embeds"]:
        vec = vec + mlp_embed(p["guidance_in"],
                              sinusoid(guidance * 1000.0, cfg["time_freq_dim"]).to(dt))
    vec = vec + mlp_embed(p["vector_in"], pooled)
    run = (lambda f, *a: checkpoint(f, *a, use_reentrant=False)) if checkpoint_blocks \
        else (lambda f, *a: f(*a))
    for i in range(p["double"]["img_qkv"]["w"].shape[0]):
        x, c = run(lambda x, c, i=i: double_block(p["double"], i, x, c, vec, cos, sin, H, lora),
                   x, c)
    j = torch.cat([c, x], 1)
    for i in range(p["single"]["linear1"]["w"].shape[0]):
        j = run(lambda j, i=i: single_block(p["single"], i, j, vec, cos, sin, H, lora), j)
    x = j[:, c.shape[1]:]
    scale, shift = linear(F.silu(vec), p["final_mod"]["lin"]).chunk(2, -1)
    x = layer_norm(x) * (1 + scale[:, None]) + shift[:, None]
    return linear(x, p["proj_out"]).float()

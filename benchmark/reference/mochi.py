"""Mochi-1 preview's asymmetric joint DiT and its guided Euler sampling, in
plain PyTorch.

From the published model (genmo/mochi-1-preview ``transformer/config.json``;
genmo's ``asymm_models_joint.py``; diffusers' ``transformer_mochi.py`` and
``MochiAttentionPool``):

- video tokens: latents (B, T, H, W, 12) cut into 2 x 2 patches, each a
  linear map to the 3072-wide visual stream; text: T5-XXL features
  (B, n, 4096), a linear map to the 1536-wide text stream;
- conditioning: the flow time times 1000 as a 256-wide sinusoid [cos | sin]
  through a SiLU MLP, plus the attention-pooled text (the mean of the text
  tokens prepended as the one query over [mean | tokens], 8 heads, to 3072);
- RoPE: learned frequencies W (3, heads, 64); a video token at (t, h, w)
  sits at (t, centre of row h, centre of column w), rows and columns
  scaled so that the grid's area is 192 x 192; its angles are pos . W, and
  adjacent channel pairs of the visual q and k rotate by them;
- each block: from SiLU(conditioning) a scale and a gate for attention and
  for the feed-forward of each stream; the stream RMS-normed and scaled by
  (1 + scale); q, k, v of the visual stream, k and v (and q, but in the
  final block) of the text stream, all 24 heads x 128; RMS QK-norm with
  learned scales, RoPE on the visual q and k; one attention over [visual |
  text]; each output projected back to its stream, RMS-normed, times
  tanh(gate) and added; then the same sandwich around a SwiGLU
  feed-forward (8192 inner for video, 4096 for text).  The final block
  takes visual queries only and leaves the text stream as it was;
- the output: a LayerNorm without affine, scaled by (1 + scale) and shifted
  by the conditioning, a linear map to the 2 x 2 x 12 patch, unpatched;
- sampling: classifier-free guidance, v = v_u + g (v_c - v_u), over the
  linear-quadratic sigma schedule.

Text is each sample's valid tokens only, as genmo packs them and diffusers
selects each row's: the caller gives a row's n valid tokens, and rows of
different lengths run one at a time.  Weights are (in, out) matrices in the
program's tree layout (``blocks`` stacked on a leading depth axis, the
final block apart).

Precision follows the configuration: products in the compute dtype with f32
accumulation; the modulated RMS norms, their (1 + scale), the tanh gates,
LayerNorm, RoPE, scores and softmax in f32, each cast once.  In bf16, q is
scaled by 1/sqrt(128) in bf16 before the scores, where the program's
attention kernel rounds.  The attention runs over blocks of ``QBLOCK``
queries so that its f32 scores fit at 11.2k keys.

Departures and keys this file could not confirm (no released file was read;
listed under ``assumed`` in the configuration):

- the final block's text stream is modulated by (scale, shift) from a
  2 x 1536 projection, the program's tree layout; genmo's ``mod_y`` and
  diffusers' ``MochiLayerNormContinuous`` scale it and do not shift it;
- the order of chunks is the program's: a patch vector is (dy, dx, c)
  (diffusers' Conv2d flattens (c, dy, dx)); the SwiGLU projection is
  [gate | up] with SiLU on the first half (genmo's; diffusers' converter
  swaps the halves); the output modulation is (scale, shift);
- every RMS norm and the LayerNorm take eps 1e-6 (genmo's QK-norm may use
  1e-5);
- the Euler step adds (sigma_{i+1} - sigma_i) v with sigma from 1 to 0 and
  the network's time sigma, as the program integrates (genmo's loop adds
  (sigma_i - sigma_{i+1}) v: only the sign of the learned velocity, which
  random weights do not fix).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

QBLOCK = 2048


def linear(x, p):
    y = x @ p["w"].to(x.dtype)
    return y + p["b"].to(x.dtype) if "b" in p else y


def sinusoid(t, dim, max_period=10000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    ang = t.float()[:, None] * freqs
    return torch.cat([torch.cos(ang), torch.sin(ang)], -1)


def rms(x, eps=1e-6):
    """RMS-normalised x in f32."""
    xf = x.float()
    return xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)


def positions(T, h, w, base=192 * 192):
    """(T h w, 3) f32 positions of a grid of T x h x w video tokens."""
    s = math.sqrt(base / (h * w))
    centres = lambda n: (torch.arange(n, dtype=torch.float64) + 0.5 - n / 2) * s
    g = torch.meshgrid(torch.arange(T, dtype=torch.float64), centres(h), centres(w),
                       indexing="ij")
    return torch.stack(g, -1).reshape(-1, 3).float()


def rope(x, cos, sin):
    """x (B, H, S, D) rotated in adjacent pairs by angles (S, H, D/2), in f32."""
    xf = x.float()
    c, s = cos.transpose(0, 1)[None], sin.transpose(0, 1)[None]
    x0, x1 = xf[..., 0::2], xf[..., 1::2]
    return torch.stack([x0 * c - x1 * s, x1 * c + x0 * s], -1).flatten(-2).to(x.dtype)


def attention(q, k, v):
    """Softmax attention of (B, H, Sq, D) queries over (B, H, Sk, D) keys, in
    blocks of ``QBLOCK`` queries; f32 scores and softmax."""
    d = q.shape[-1]
    if q.dtype == torch.float32:
        scale, qs = d ** -0.5, q
    else:  # the scale rounded to q's dtype, q scaled in it, as the kernel takes q
        scale, qs = 1.0, q * torch.tensor(d ** -0.5, dtype=q.dtype).item()
    kf, vf = k.float().transpose(-1, -2), v.float()
    out = []
    for i in range(0, q.shape[2], QBLOCK):
        s = (qs[:, :, i:i + QBLOCK].float() @ kf) * scale
        out.append((torch.softmax(s, -1) @ vf).to(v.dtype))
    return torch.cat(out, 2)


def _heads(x, H):
    B, S, _ = x.shape
    return x.reshape(B, S, H, -1).transpose(1, 2)


def _merge(x):
    B, H, S, D = x.shape
    return x.transpose(1, 2).reshape(B, S, H * D)


def _at(tree, i):
    return {k: _at(v, i) for k, v in tree.items()} if isinstance(tree, dict) else tree[i]


def pool(p, txt, heads, dt):
    """The attention pool over a row's valid T5 tokens ``txt`` (B, n, 4096)."""
    B, n, D = txt.shape
    x = torch.cat([txt.float().mean(1, keepdim=True), txt.float()], 1).to(dt)
    k, v = linear(x, p["to_kv"]).chunk(2, -1)
    q = linear(x[:, 0], p["to_q"])
    hd = D // heads
    k, v = (z.reshape(B, n + 1, heads, hd).transpose(1, 2).float() for z in (k, v))
    s = (q.reshape(B, heads, 1, hd).float() @ k.transpose(-1, -2)) / math.sqrt(hd)
    o = (torch.softmax(s, -1) @ v).reshape(B, D)
    return linear(o.to(dt), p["to_out"])


def embed(p, cfg, z, txt, t, dt):
    """The first block's inputs for latents ``z`` (B, T, H, W, C) at flow
    time ``t`` (B,) and a row's valid T5 tokens ``txt`` (B, n, 4096): a dict
    of the visual stream ``x``, the text stream ``c``, the conditioning
    ``temb`` and the RoPE angles."""
    B, T, H, W, C = z.shape
    ps = cfg["patch_size"]
    x = z.reshape(B, T, H // ps, ps, W // ps, ps, C).permute(0, 1, 2, 4, 3, 5, 6)
    x = linear(x.reshape(B, -1, ps * ps * C).to(dt), p["patch_embed"])
    te = sinusoid(t * 1000.0, cfg["time_embed_dim"]).to(dt)
    temb = linear(F.silu(linear(te, p["time_in"]["in"])), p["time_in"]["out"])
    temb = temb + pool(p["pooler"], txt, cfg["pool_heads"], dt)
    c = linear(txt.to(dt), p["caption_proj"])
    ang = torch.einsum("nd,dhf->nhf", positions(T, H // ps, W // ps).to(z.device),
                       p["pos_frequencies"].float())
    return {"x": x, "c": c, "temb": temb, "cos": torch.cos(ang), "sin": torch.sin(ang),
            "heads": cfg["num_attention_heads"], "shape": (B, T, H, W, C), "ps": ps}


def _mod_rms(x, scale, shift=None):
    y = rms(x) * (1 + scale.float()[:, None])
    return (y if shift is None else y + shift.float()[:, None]).to(x.dtype)


def _gated(x, y, gate):
    return x + (rms(y) * torch.tanh(gate.float())[:, None]).to(x.dtype)


def _swiglu(p_in, p_out, x):
    g, u = linear(x, p_in).chunk(2, -1)
    return linear(F.silu(g.float()).to(x.dtype) * u, p_out)


def block(w, e, x, c, final=False):
    """One joint block (``final``: visual queries only, the text stream
    returned as it came) on the visual stream ``x`` and text stream ``c``."""
    H = e["heads"]
    sv = F.silu(e["temb"])
    sx_a, gx_a, sx_m, gx_m = linear(sv, w["mod_x"]["lin"]).chunk(4, -1)
    if final:
        sc_a, sh_c = linear(sv, w["mod_c"]["lin"]).chunk(2, -1)
        cn = _mod_rms(c, sc_a, sh_c)
    else:
        sc_a, gc_a, sc_m, gc_m = linear(sv, w["mod_c"]["lin"]).chunk(4, -1)
        cn = _mod_rms(c, sc_a)
    q, k, v = (_heads(z, H) for z in linear(_mod_rms(x, sx_a), w["qkv"]).chunk(3, -1))
    qn = lambda z, s: (rms(z) * s.float()).to(z.dtype)
    q = rope(qn(q, w["qnorm"]), e["cos"], e["sin"])
    k = rope(qn(k, w["knorm"]), e["cos"], e["sin"])
    ck, cv = (_heads(z, H) for z in linear(cn, w["add_kv"]).chunk(2, -1))
    k, v = torch.cat([k, qn(ck, w["add_knorm"])], 2), torch.cat([v, cv], 2)
    if not final:
        q = torch.cat([q, qn(_heads(linear(cn, w["add_q"]), H), w["add_qnorm"])], 2)
    o = _merge(attention(q, k, v))
    Lx = x.shape[1]
    x = _gated(x, linear(o[:, :Lx], w["attn_out"]), gx_a)
    x = _gated(x, _swiglu(w["ff_in"], w["ff_out"], _mod_rms(x, sx_m)), gx_m)
    if final:
        return x, c
    c = _gated(c, linear(o[:, Lx:], w["attn_out_c"]), gc_a)
    c = _gated(c, _swiglu(w["ff_c_in"], w["ff_c_out"], _mod_rms(c, sc_m)), gc_m)
    return x, c


def body(p, e, i, x, c):
    """Block ``i`` of the stacked body."""
    return block(_at(p["blocks"], i), e, x, c)


def final_block(p, e, x, c):
    return block(p["final_block"], e, x, c, final=True)


def final(p, e, x):
    """The velocity (B, T, H, W, C) f32 from the final block's visual stream."""
    B, T, H, W, C = e["shape"]
    ps = e["ps"]
    scale, shift = linear(F.silu(e["temb"]), p["final_mod"]["lin"]).chunk(2, -1)
    xf = F.layer_norm(x.float(), x.shape[-1:], eps=1e-6)
    x = (xf * (1 + scale.float()[:, None]) + shift.float()[:, None]).to(x.dtype)
    y = linear(x, p["proj_out"]).float()
    y = y.reshape(B, T, H // ps, W // ps, ps, ps, C).permute(0, 1, 2, 4, 3, 5, 6)
    return y.reshape(B, T, H, W, C)


def forward(p, cfg, z, txt, t, dt):
    """The velocity of latents ``z`` for a row's valid T5 tokens ``txt``."""
    e = embed(p, cfg, z, txt, t, dt)
    x, c = e["x"], e["c"]
    for i in range(p["blocks"]["qkv"]["w"].shape[0]):
        x, c = body(p, e, i, x, c)
    x, _ = final_block(p, e, x, c)
    return final(p, e, x)


def linear_quadratic(steps, threshold=0.025):
    """genmo's linear-quadratic schedule: ``steps`` + 1 sigmas from 1 to 0,
    the first half of the steps falling linearly to 1 - threshold, then a
    quadratic to 0."""
    n = steps // 2
    lin = [i * threshold / n for i in range(n)]
    diff = n - threshold * steps
    m = steps - n
    qa = diff / (n * m ** 2)
    qb = threshold / n - 2 * diff / m ** 2
    qc = qa * n ** 2
    quad = [qa * i ** 2 + qb * i + qc for i in range(n, steps)]
    return np.asarray([1.0 - s for s in lin + quad + [1.0]], np.float64)


def guided(v_cond, v_uncond, scale):
    """Classifier-free guidance of two velocities."""
    return v_uncond + scale * (v_cond - v_uncond)


def sample(p, cfg, z0, txt, neg, steps, scale, dt):
    """The guided Euler loop from ``z0`` (f32) for one row: ``txt`` and
    ``neg`` its valid T5 tokens and the negative prompt's; returns every
    latent of the loop, (steps + 1, *z0.shape) f32."""
    sig = linear_quadratic(steps)
    zs = [z0.float()]
    for i in range(steps):
        z = zs[-1]
        t = torch.full((z.shape[0],), float(sig[i]), device=z.device)
        v = guided(forward(p, cfg, z.to(dt), txt, t, dt),
                   forward(p, cfg, z.to(dt), neg, t, dt), scale)
        zs.append(z + float(sig[i + 1] - sig[i]) * v)
    return torch.stack(zs)

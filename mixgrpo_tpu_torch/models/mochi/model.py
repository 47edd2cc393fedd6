"""Mochi-1 asymmetric video DiT, plain PyTorch functions on a parameter dict.

Port of mixgrpo_tpu/models/mochi/model.py (``MochiTransformer3DModel``: 48
asymmetric joint blocks over a 3072-wide visual stream and a 1536-wide text
stream, 24 heads x 128, 12 latent channels, patch 2).  Kept from JAX: the
parameter layout (dicts of tensors, (in, out) weights, the 47 structurally
equal blocks stacked on a leading depth axis, the final block apart), and
every order a copy can get wrong quietly:

  - ``_rms`` casts back to x's dtype before the ``(1 + scale)`` multiply;
  - RoPE: learned frequencies that differ per head, cos/sin of shape
    (S, H, D/2) over area-normalized (t, h, w) centers (``mochi_positions``,
    host numpy), rotating adjacent channel pairs of the visual q and k only;
  - joint attention over [visual | text] for q, k and v; the final block
    (context_pre_only) takes q from the visual tokens alone, so there
    Sq = L_visual and Sk = L_visual + L_text, and its text stream gets
    (scale, shift) and no update;
  - the caption pooler (``_attention_pool``) takes the masked mean as the
    single query over [mean | tokens], 8 heads, padded keys filled with
    finfo(f32).min;
  - the timestep enters as ``timestep * 1000`` with no floor; the final
    layer is layer_norm then modulate(shift, scale) with the modulation
    split as (scale, shift);
  - patchify and unpatchify in the order (B, T, H/2, W/2, 2, 2, C).
The text mask, unlike JAX's (which applies it in the pooler only), also
keeps padded text tokens out of the joint attention for every query, as the
published model does (genmo packs the valid tokens, diffusers selects each
row's): where every row's mask is a prefix of ones, the text is cut to the
batch's longest valid length before ``caption_proj``, the pooler and the
blocks, and a row's remaining padding, or a mask that is no prefix, enters
the attention as a key mask (the forward kernel's key-bias branch).  Under
``"ulysses"`` and ``"ring"`` nothing is cut, so that the joint sequence
keeps its length.  ``text_mask=None`` attends every text token.
The SwiGLU feed-forwards stay torch ops (the reference's liger kernel is no
TPU kernel, and JAX uses plain ops).  Attention goes through
``ops/attention.py``: the CUDA forward kernel on CUDA tensors with
``attn_impl="auto"``, at any S and Sk with no padding (the kernel's TMA
loads zero-fill rows past S and Sk).  ``remat`` recomputes each block in
the backward (``torch.utils.checkpoint``), as JAX's ``jax.checkpoint``.
q, k and v are (B, H, S, D), as in JAX.
Each forward is a ``dit`` span (``utils/profiling.py``); in its sampled
calls a block records the stages ``norm_mod`` (the pre-norms with their
``1 + scale``), ``qk_rope`` (the q, k, text-q and text-k RMSNorms, the
learned RoPE and the joint concatenation), ``gate_res`` (the post-norm,
the tanh gate and the residual add) and ``act`` (SiLU times up), beside the
``gemm`` and ``attn`` spans of ``layers.py`` and ``ops/attention.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from mixgrpo_tpu_torch.models.flux import layers as L
from mixgrpo_tpu_torch.models.flux.model import _merge_heads, _unstack
from mixgrpo_tpu_torch.ops.attention import attention
from mixgrpo_tpu_torch.ops.qk_rope import split_heads
from mixgrpo_tpu_torch.utils.profiling import span, spanned


@dataclasses.dataclass(frozen=True)
class MochiConfig:
    patch_size: int = 2
    num_heads: int = 24
    head_dim: int = 128
    num_layers: int = 48
    in_channels: int = 12
    text_dim: int = 1536  # pooled_projection_dim (text stream width)
    text_embed_dim: int = 4096  # T5 features in
    time_freq_dim: int = 256
    pool_heads: int = 8  # MochiAttentionPool num_attention_heads
    max_text_len: int = 256
    base_height: int = 192
    base_width: int = 192
    eps: float = 1e-6

    @property
    def dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def ff_inner(self) -> int:
        return (4 * self.dim * 2) // 3

    @property
    def ff_context_inner(self) -> int:
        return (4 * self.text_dim * 2) // 3

    @classmethod
    def mochi_preview(cls) -> "MochiConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "MochiConfig":
        return cls(num_heads=2, head_dim=16, num_layers=2, in_channels=4,
                   text_dim=24, text_embed_dim=48, time_freq_dim=32,
                   max_text_len=8)


def _rms(x, eps):
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)).to(x.dtype)


def _swiglu(p_in, p_out, x, dtype):
    """SwiGLU FF: (silu(x W_g) * (x W_u)) W_o, the projection fused as [gate | up]."""
    gate, up = L.linear(p_in, x, dtype).chunk(2, dim=-1)
    with span("act"):
        h = F.silu(gate) * up
    return L.linear(p_out, h, dtype)


def mochi_positions(t: int, h: int, w: int, base_area: int) -> np.ndarray:
    """Area-normalized (t, h, w) center coordinates (modeling_mochi.py:457-482)."""
    scale = (base_area / (h * w)) ** 0.5

    def centers(start, stop, num):
        e = np.linspace(start, stop, num + 1, dtype=np.float32)
        return (e[:-1] + e[1:]) / 2

    tt = np.arange(t, dtype=np.float32)
    hh = centers(-h * scale / 2, h * scale / 2, h)
    ww = centers(-w * scale / 2, w * scale / 2, w)
    gt, gh, gw = np.meshgrid(tt, hh, ww, indexing="ij")
    return np.stack([gt, gh, gw], axis=-1).reshape(-1, 3)


def mochi_rope(pos_frequencies: torch.Tensor, pos):
    """Learned continuous RoPE: freqs[n, h, f] = pos[n, :] . W[:, h, f];
    returns f32 (cos, sin) of shape (S, H, D/2)."""
    pos = torch.as_tensor(pos, dtype=torch.float32, device=pos_frequencies.device)
    freqs = torch.einsum("nd,dhf->nhf", pos, pos_frequencies.float())
    return torch.cos(freqs), torch.sin(freqs)


def _apply_mochi_rope(x, cos, sin):
    """x: (B, H, S, D); cos/sin: (S, H, D/2); rotates adjacent channel
    pairs in f32."""
    xf = x.float()
    xp = xf.reshape(*xf.shape[:-1], -1, 2)
    x_even, x_odd = xp[..., 0], xp[..., 1]
    c, s = cos.transpose(0, 1)[None], sin.transpose(0, 1)[None]  # (1, H, S, D/2)
    out_even = x_even * c - x_odd * s
    out_odd = x_odd * c + x_even * s
    return torch.stack([out_even, out_odd], dim=-1).reshape(xf.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _normal_lin(gen, i, o, lead, kw):
    """A bias-free (in, out) weight drawn N(0, 1/in), as JAX's blocks are."""
    return {"w": torch.empty((*lead, i, o), **kw).normal_(0.0, i**-0.5, generator=gen)}


def _block_init(gen, cfg: MochiConfig, context_pre_only: bool, kw, lead=()):
    d, td, hd = cfg.dim, cfg.text_dim, cfg.head_dim
    ones = lambda: torch.ones((*lead, hd), **kw)
    nb = lambda i, o: _normal_lin(gen, i, o, lead, kw)
    p = {
        "mod_x": {"lin": L.linear_init(gen, d, 4 * d, lead=lead, **kw)},
        "qkv": nb(d, 3 * d),
        "add_kv": nb(td, 2 * d),
        "qnorm": ones(),
        "knorm": ones(),
        "add_knorm": ones(),
        "attn_out": nb(d, d),
        "ff_in": nb(d, 2 * cfg.ff_inner),
        "ff_out": nb(cfg.ff_inner, d),
    }
    if context_pre_only:  # LayerNormContinuous: scale + shift only
        p["mod_c"] = {"lin": L.linear_init(gen, d, 2 * td, lead=lead, **kw)}
    else:
        p["mod_c"] = {"lin": L.linear_init(gen, d, 4 * td, lead=lead, **kw)}
        p["add_q"] = nb(td, d)
        p["add_qnorm"] = ones()
        p["attn_out_c"] = nb(d, td)
        p["ff_c_in"] = nb(td, 2 * cfg.ff_context_inner)
        p["ff_c_out"] = nb(cfg.ff_context_inner, td)
    return p


def init_mochi(cfg: MochiConfig, *, generator: Optional[torch.Generator] = None,
               device="cuda", dtype=torch.float32) -> Dict[str, Any]:
    """Random weights in the JAX layout, drawn tensor by tensor at ``dtype``
    on ``device`` (the 47 body blocks as one stack each leaf).  The values
    differ from JAX's ``init_mochi``; tests carry JAX weights over with
    ``convert.from_jax_params``."""
    d, te, g = cfg.dim, cfg.text_embed_dim, generator
    kw = dict(device=device, dtype=dtype)
    pe = cfg.patch_size * cfg.patch_size * cfg.in_channels
    return {
        "patch_embed": L.linear_init(g, pe, d, **kw),
        "time_in": L.mlp_embedder_init(g, cfg.time_freq_dim, d, **kw),
        "pooler": {
            "to_kv": L.linear_init(g, te, 2 * te, **kw),
            "to_q": L.linear_init(g, te, te, **kw),
            "to_out": L.linear_init(g, te, d, **kw),
        },
        "caption_proj": L.linear_init(g, te, cfg.text_dim, **kw),
        "pos_frequencies": torch.empty((3, cfg.num_heads, cfg.head_dim // 2), **kw)
        .normal_(0.0, 0.02, generator=g),
        "final_mod": L.modulation_init(g, d, 2, **kw),
        "proj_out": L.linear_init(g, d, pe, **kw),
        "blocks": _block_init(g, cfg, False, kw, lead=(cfg.num_layers - 1,)),
        "final_block": _block_init(g, cfg, True, kw),
    }


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _gate_res(x, y, gate, eps):
    """The sandwich norm's second half: x + rms(y) * tanh(gate)."""
    with span("gate_res"):
        return x + _rms(y, eps) * torch.tanh(gate)[:, None, :]


def _joint_qkv(p, H, eps, qkv, ckv, cq, rope_cos, rope_sin):
    """QK-norm and learned RoPE on the visual heads, QK-norm on the text
    heads, joined as [visual | text]; ``cq`` None: visual queries only."""
    split = lambda t: split_heads(t, H, "bhsd")
    q, k, v = (split(t) for t in qkv.chunk(3, dim=-1))
    q = _apply_mochi_rope(L.rms_norm(q, p["qnorm"], eps), rope_cos, rope_sin)
    k = _apply_mochi_rope(L.rms_norm(k, p["knorm"], eps), rope_cos, rope_sin)
    ck, cv = (split(t) for t in ckv.chunk(2, dim=-1))
    ck = L.rms_norm(ck, p["add_knorm"], eps)
    if cq is not None:
        q = torch.cat([q, L.rms_norm(split(cq), p["add_qnorm"], eps)], dim=2)
    return q, torch.cat([k, ck], dim=2), torch.cat([v, cv], dim=2)


def _mochi_block(p, cfg: MochiConfig, x, c, temb, rope_cos, rope_sin, context_pre_only,
                 attn_impl, dtype, attn_mask=None):
    """One asymmetric joint block; ``attn_mask`` a key mask over [visual |
    text] (True = attend) or None."""
    H, eps = cfg.num_heads, cfg.eps
    sx_msa, gx_msa, sx_mlp, gx_mlp = L.modulation(p["mod_x"], temb, 4, dtype)
    if context_pre_only:  # LayerNormContinuous-style: (scale, shift), no gates
        sc_msa, sh = L.modulation(p["mod_c"], temb, 2, dtype)
    else:
        sc_msa, gc_msa, sc_mlp, gc_mlp = L.modulation(p["mod_c"], temb, 4, dtype)
    with span("norm_mod"):
        xn = _rms(x, eps) * (1.0 + sx_msa[:, None, :])
        cn = _rms(c, eps) * (1.0 + sc_msa[:, None, :])
        if context_pre_only:
            cn = cn + sh[:, None, :]

    qkv = L.linear(p["qkv"], xn, dtype)
    ckv = L.linear(p["add_kv"], cn, dtype)
    cq = None if context_pre_only else L.linear(p["add_q"], cn, dtype)
    with span("qk_rope"):
        q, k, v = _joint_qkv(p, H, eps, qkv, ckv, cq, rope_cos, rope_sin)

    o = _merge_heads(attention(q, k, v, mask=attn_mask, impl=attn_impl), "bhsd")
    Lx = x.shape[1]
    x = _gate_res(x, L.linear(p["attn_out"], o[:, :Lx], dtype), gx_msa, eps)
    with span("norm_mod"):
        xn2 = _rms(x, eps) * (1.0 + sx_mlp[:, None, :])
    x = _gate_res(x, _swiglu(p["ff_in"], p["ff_out"], xn2, dtype), gx_mlp, eps)

    if not context_pre_only:
        c = _gate_res(c, L.linear(p["attn_out_c"], o[:, Lx:], dtype), gc_msa, eps)
        with span("norm_mod"):
            cn2 = _rms(c, eps) * (1.0 + sc_mlp[:, None, :])
        c = _gate_res(c, _swiglu(p["ff_c_in"], p["ff_c_out"], cn2, dtype), gc_mlp, eps)
    return x, c


def _text_keys(txt, text_mask, attn_impl):
    """(text, mask, key mask) as the blocks take them: with every row's mask
    a prefix of ones (T5 pads at the end) and the attention on one rank,
    the text and its mask cut to the batch's longest valid length (at least
    one token); the key mask (bool, True = a text token) where a kept
    position is still padding, else None."""
    if text_mask is None:
        return txt, None, None
    mask = torch.as_tensor(text_mask, device=txt.device)
    valid = mask.cpu() != 0
    n = valid.sum(dim=1)
    prefix = bool((valid == (torch.arange(valid.shape[1]) < n[:, None])).all())
    if prefix and attn_impl not in ("ulysses", "ring"):
        keep = max(int(n.max()), 1)
        txt, mask, valid = txt[:, :keep], mask[:, :keep], valid[:, :keep]
    return txt, mask, None if bool(valid.all()) else mask != 0


def _attention_pool(p, txt, text_mask, num_heads: int, dtype):
    """MochiAttentionPool (time_embed.pooler.*): prepend the masked-mean
    token, use it as the single query of a multi-head attention over the
    1 + L keys (padded keys at finfo(f32).min), project to the conditioning
    width.  Eager, as in JAX."""
    B, Lt, D = txt.shape
    x = txt.float()
    if text_mask is not None:
        m = torch.as_tensor(text_mask, device=txt.device).float()
    else:
        m = torch.ones((B, Lt), dtype=torch.float32, device=txt.device)
    mean = torch.einsum("bl,bld->bd", m, x) / torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
    x = torch.cat([mean[:, None], x], dim=1)  # (B, 1 + L, D)
    k, v = L.linear(p["to_kv"], x.to(dtype), dtype).chunk(2, dim=-1)
    q = L.linear(p["to_q"], x[:, 0].to(dtype), dtype)  # (B, D)
    hd = D // num_heads
    k = k.reshape(B, 1 + Lt, num_heads, hd).transpose(1, 2)
    v = v.reshape(B, 1 + Lt, num_heads, hd).transpose(1, 2)
    q = q.reshape(B, num_heads, 1, hd)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (hd**-0.5)
    key_valid = torch.cat([torch.ones((B, 1), dtype=torch.float32, device=m.device), m], dim=1)
    logits = torch.where(key_valid[:, None, None, :] > 0, logits,
                         torch.full_like(logits, torch.finfo(torch.float32).min))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.einsum("bhqk,bhkd->bhqd", probs.float(), v.float())
    return L.linear(p["to_out"], o.reshape(B, D).to(dtype), dtype)


def _patchify(x, ps: int):
    B, T, H, W, C = x.shape
    x = x.reshape(B, T, H // ps, ps, W // ps, ps, C).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(B, T * (H // ps) * (W // ps), ps * ps * C)


def _unpatchify(x, ps: int, shape):
    B, T, H, W, C = shape
    x = x.reshape(B, T, H // ps, W // ps, ps, ps, C).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(B, T, H, W, C)


@spanned("dit")
def mochi_forward(
    params: Dict[str, Any],
    cfg: MochiConfig,
    video_latents: torch.Tensor,  # (B, T, H, W, C)
    txt: torch.Tensor,  # (B, L, text_embed_dim) T5 features
    timestep: torch.Tensor,  # (B,) in [0, 1]
    text_mask: Optional[torch.Tensor] = None,  # (B, L), 1 = a text token
    *,
    dtype=torch.bfloat16,
    attn_impl: str = "auto",
    remat: bool = True,
) -> torch.Tensor:
    """Velocity for video latents, (B, T, H, W, C) f32.  Padded text tokens
    (``text_mask`` 0) reach neither the pooler nor the joint attention."""
    shape = tuple(video_latents.shape)
    B, T, Hh, Ww, _ = shape
    ps = cfg.patch_size
    txt, text_mask, text_keys = _text_keys(txt, text_mask, attn_impl)
    x = L.linear(params["patch_embed"], _patchify(video_latents, ps).to(dtype), dtype)

    temb = L.mlp_embedder(params["time_in"],
                          L.timestep_embedding(timestep * 1000.0, cfg.time_freq_dim), dtype)
    temb = temb + _attention_pool(params["pooler"], txt, text_mask, cfg.pool_heads, dtype)
    c = L.linear(params["caption_proj"], txt.to(dtype), dtype)

    pos = mochi_positions(T, Hh // ps, Ww // ps, cfg.base_height * cfg.base_width)
    rope_cos, rope_sin = mochi_rope(params["pos_frequencies"], pos)
    attn_mask = None
    if text_keys is not None:  # over [visual | text]
        visual = torch.ones((B, x.shape[1]), dtype=torch.bool, device=x.device)
        attn_mask = torch.cat([visual, text_keys], dim=1)[:, None, None, :]

    def block(p, final):
        return lambda xh, ch: _mochi_block(p, cfg, xh, ch, temb, rope_cos, rope_sin, final,
                                           attn_impl, dtype, attn_mask)

    def run(body, *args):
        if remat and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(body, *args, use_reentrant=False)
        return body(*args)

    for p in _unstack(params["blocks"]):
        x, c = run(block(p, False), x, c)
    x, c = run(block(params["final_block"], True), x, c)

    scale, shift = L.modulation(params["final_mod"], temb, 2, dtype)
    x = L.modulate(L.layer_norm(x, cfg.eps), shift, scale)
    x = L.linear(params["proj_out"], x, dtype).float()
    return _unpatchify(x, ps, shape)

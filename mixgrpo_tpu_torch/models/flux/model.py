"""FLUX.1 MMDiT policy model, plain PyTorch functions on a parameter dict.

Port of mixgrpo_tpu/models/flux/model.py (FLUX.1-dev: hidden 3072, 24 heads x
128, 19 double + 38 single blocks, 64 input channels, axes dims (16, 56, 56),
guidance-distilled).  Kept from JAX: the parameter layout (dicts of tensors,
(in, out) weights, double/single block stacks with a leading depth axis), the
joint [text | image] sequence order, RoPE tables computed once per
resolution, the fused single-block projections, and the ``pad_seq_multiple``
lane alignment with its static ``attn_valid`` key prefix.  JAX's ``lax.scan``
over the stacks is a Python loop over the depth axis here, over per-block
views made once by ``torch.unbind`` (so a block stack's gradient is gathered
in one tensor, not one full-size zero-padded tensor per block).

``remat`` recomputes each block in the backward
(``torch.utils.checkpoint``, non-reentrant): JAX's ``"dots"`` policy, which
let XLA keep some matmul results, maps to the same full per-block recompute.
``virtual_depth=(DD, DS)`` applies DD double and DS single blocks, cycling
the resident stacks (block i runs weights i % depth): a full-depth forward's
and backward's compute on a stack cut to fit one card.  JAX's
``utils/cycle_scan.py`` exists only for JAX's autodiff of that scan and has
no counterpart here: autograd accumulates the reused blocks' gradients.

``MIXGRPO_ATTN_LAYOUT=bshd`` keeps q/k/v as (B, S, H, D) (the head split is a
free reshape and the attention kernel reads per-head strides); the default
is bhsd, as in JAX.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from mixgrpo_tpu_torch.models.flux import layers as L
from mixgrpo_tpu_torch.models.flux.rope import apply_rope
from mixgrpo_tpu_torch.ops.attention import attention


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    in_channels: int = 64
    hidden_size: int = 3072
    num_heads: int = 24
    depth_double: int = 19
    depth_single: int = 38
    mlp_ratio: float = 4.0
    axes_dims: tuple = (16, 56, 56)
    pooled_dim: int = 768
    context_dim: int = 4096
    guidance_embeds: bool = True
    time_freq_dim: int = 256
    theta: float = 10000.0
    eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def mlp_hidden(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)

    @classmethod
    def flux_dev(cls) -> "FluxConfig":
        return cls()

    @classmethod
    def tiny(cls, **kw) -> "FluxConfig":
        """Small config for tests (structure-identical)."""
        d = dict(
            in_channels=16, hidden_size=128, num_heads=4, depth_double=2,
            depth_single=4, pooled_dim=32, context_dim=64,
            axes_dims=(8, 12, 12), time_freq_dim=32,
        )
        d.update(kw)
        return cls(**d)


# ----------------------------------------------------------------------------
# init
# ----------------------------------------------------------------------------


def _double_blocks_init(gen, cfg: FluxConfig, kw) -> Dict[str, Any]:
    h, hd, mh = cfg.hidden_size, cfg.head_dim, cfg.mlp_hidden
    kw = dict(kw, lead=(cfg.depth_double,))
    ones = lambda: torch.ones((cfg.depth_double, hd), device=kw["device"],
                              dtype=kw["dtype"])
    return {
        "img_mod": L.modulation_init(gen, h, 6, **kw),
        "txt_mod": L.modulation_init(gen, h, 6, **kw),
        "img_qkv": L.linear_init(gen, h, 3 * h, **kw),
        "txt_qkv": L.linear_init(gen, h, 3 * h, **kw),
        "img_qnorm": ones(),
        "img_knorm": ones(),
        "txt_qnorm": ones(),
        "txt_knorm": ones(),
        "img_attn_out": L.linear_init(gen, h, h, **kw),
        "txt_attn_out": L.linear_init(gen, h, h, **kw),
        "img_mlp_in": L.linear_init(gen, h, mh, **kw),
        "img_mlp_out": L.linear_init(gen, mh, h, **kw),
        "txt_mlp_in": L.linear_init(gen, h, mh, **kw),
        "txt_mlp_out": L.linear_init(gen, mh, h, **kw),
    }


def _single_blocks_init(gen, cfg: FluxConfig, kw) -> Dict[str, Any]:
    h, hd, mh = cfg.hidden_size, cfg.head_dim, cfg.mlp_hidden
    kw = dict(kw, lead=(cfg.depth_single,))
    ones = lambda: torch.ones((cfg.depth_single, hd), device=kw["device"],
                              dtype=kw["dtype"])
    return {
        "mod": L.modulation_init(gen, h, 3, **kw),
        # fused [qkv | mlp_in] and [attn_out | mlp_out]
        "linear1": L.linear_init(gen, h, 3 * h + mh, **kw),
        "linear2": L.linear_init(gen, h + mh, h, **kw),
        "qnorm": ones(),
        "knorm": ones(),
    }


def init_flux(cfg: FluxConfig, *, generator: Optional[torch.Generator] = None,
              device="cuda", dtype=torch.float32) -> Dict[str, Any]:
    """Random FLUX weights in the JAX layout, drawn tensor by tensor directly
    at ``dtype`` on ``device`` (a full-size bf16 model needs no fp32 copy).
    The values differ from JAX's ``init_flux``; tests carry JAX weights over
    with ``convert.from_jax_params``."""
    h = cfg.hidden_size
    kw = dict(device=device, dtype=dtype)
    g = generator
    params = {
        "x_embedder": L.linear_init(g, cfg.in_channels, h, **kw),
        "context_embedder": L.linear_init(g, cfg.context_dim, h, **kw),
        "time_in": L.mlp_embedder_init(g, cfg.time_freq_dim, h, **kw),
        "vector_in": L.mlp_embedder_init(g, cfg.pooled_dim, h, **kw),
        "final_mod": L.modulation_init(g, h, 2, **kw),
        "proj_out": L.linear_init(g, h, cfg.in_channels, **kw),
    }
    if cfg.guidance_embeds:
        params["guidance_in"] = L.mlp_embedder_init(g, cfg.time_freq_dim, h, **kw)
    params["double"] = _double_blocks_init(g, cfg, kw)
    params["single"] = _single_blocks_init(g, cfg, kw)
    return params


def _unstack(stack):
    """Every block of a stacked parameter tree, as views from one
    ``torch.unbind`` per leaf."""
    if isinstance(stack, dict):
        per = {k: _unstack(v) for k, v in stack.items()}
        n = len(next(iter(per.values())))
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    return stack.unbind(0)


def param_leaves(params):
    """The tensors of a parameter tree, dict keys in sorted order (the order
    of ``jax.tree.leaves``), so that optimizer state and checkpoints do not
    depend on the order in which a tree was built."""
    if isinstance(params, dict):
        return [t for k in sorted(params) for t in param_leaves(params[k])]
    if isinstance(params, (list, tuple)):
        return [t for v in params for t in param_leaves(v)]
    return [params]


# ----------------------------------------------------------------------------
# blocks
# ----------------------------------------------------------------------------


def _split_heads(x, num_heads, layout):
    b, s, _ = x.shape
    x = x.reshape(b, s, num_heads, -1)
    return x if layout == "bshd" else x.transpose(1, 2)


def _merge_heads(x, layout):
    if layout == "bshd":
        b, s, h, d = x.shape
        return x.reshape(b, s, h * d)
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _qk_norm(q, k, qscale, kscale, eps):
    return L.rms_norm(q, qscale, eps), L.rms_norm(k, kscale, eps)


def _double_block(p, cfg: FluxConfig, img, txt, vec, rope_cos, rope_sin,
                  attn_impl, dtype, layout, attn_valid=None, attn_mask=None):
    """Double-stream MMDiT block."""
    H, eps = cfg.num_heads, cfg.eps
    i_shift1, i_scale1, i_gate1, i_shift2, i_scale2, i_gate2 = L.modulation(
        p["img_mod"], vec, 6, dtype
    )
    t_shift1, t_scale1, t_gate1, t_shift2, t_scale2, t_gate2 = L.modulation(
        p["txt_mod"], vec, 6, dtype
    )

    img_mod = L.modulate(L.layer_norm(img, eps), i_shift1, i_scale1)
    txt_mod = L.modulate(L.layer_norm(txt, eps), t_shift1, t_scale1)

    iq, ik, iv = L.linear(p["img_qkv"], img_mod, dtype).chunk(3, dim=-1)
    tq, tk, tv = L.linear(p["txt_qkv"], txt_mod, dtype).chunk(3, dim=-1)
    iq, ik, iv = (_split_heads(x, H, layout) for x in (iq, ik, iv))
    tq, tk, tv = (_split_heads(x, H, layout) for x in (tq, tk, tv))
    iq, ik = _qk_norm(iq, ik, p["img_qnorm"], p["img_knorm"], eps)
    tq, tk = _qk_norm(tq, tk, p["txt_qnorm"], p["txt_knorm"], eps)

    # joint sequence: [text | image] (diffusers FLUX ordering)
    seq = 1 if layout == "bshd" else 2
    q = apply_rope(torch.cat([tq, iq], dim=seq), rope_cos, rope_sin)
    k = apply_rope(torch.cat([tk, ik], dim=seq), rope_cos, rope_sin)
    v = torch.cat([tv, iv], dim=seq)

    out = attention(q, k, v, mask=attn_mask, kv_valid=attn_valid,
                    impl=attn_impl, layout=layout)
    out = _merge_heads(out, layout)
    Lt = txt.shape[1]
    txt_attn, img_attn = out[:, :Lt], out[:, Lt:]

    img = img + i_gate1[:, None, :] * L.linear(p["img_attn_out"], img_attn, dtype)
    txt = txt + t_gate1[:, None, :] * L.linear(p["txt_attn_out"], txt_attn, dtype)

    img_mlp = L.modulate(L.layer_norm(img, eps), i_shift2, i_scale2)
    img = img + i_gate2[:, None, :] * L.linear(
        p["img_mlp_out"], L.gelu_tanh(L.linear(p["img_mlp_in"], img_mlp, dtype)), dtype
    )
    txt_mlp = L.modulate(L.layer_norm(txt, eps), t_shift2, t_scale2)
    txt = txt + t_gate2[:, None, :] * L.linear(
        p["txt_mlp_out"], L.gelu_tanh(L.linear(p["txt_mlp_in"], txt_mlp, dtype)), dtype
    )
    return img, txt


def _single_block(p, cfg: FluxConfig, x, vec, rope_cos, rope_sin, attn_impl,
                  dtype, layout, attn_valid=None, attn_mask=None):
    """Single-stream block with fused projections."""
    H, h, eps = cfg.num_heads, cfg.hidden_size, cfg.eps
    shift, scale, gate = L.modulation(p["mod"], vec, 3, dtype)
    x_mod = L.modulate(L.layer_norm(x, eps), shift, scale)

    proj = L.linear(p["linear1"], x_mod, dtype)
    qkv, mlp = proj[..., : 3 * h], proj[..., 3 * h :]
    q, k, v = (_split_heads(t, H, layout) for t in qkv.chunk(3, dim=-1))
    q, k = _qk_norm(q, k, p["qnorm"], p["knorm"], eps)
    q = apply_rope(q, rope_cos, rope_sin)
    k = apply_rope(k, rope_cos, rope_sin)

    attn_out = attention(q, k, v, mask=attn_mask, kv_valid=attn_valid,
                         impl=attn_impl, layout=layout)
    attn_out = _merge_heads(attn_out, layout)
    out = L.linear(
        p["linear2"], torch.cat([attn_out, L.gelu_tanh(mlp)], dim=-1), dtype
    )
    return x + gate[:, None, :] * out


# ----------------------------------------------------------------------------
# forward
# ----------------------------------------------------------------------------


def flux_forward(
    params: Dict[str, Any],
    cfg: FluxConfig,
    img: torch.Tensor,  # (B, L_img, in_channels) packed latents
    txt: torch.Tensor,  # (B, L_txt, context_dim) T5 embeddings
    pooled: torch.Tensor,  # (B, pooled_dim) CLIP pooled embedding
    timestep: torch.Tensor,  # (B,) in [0, 1]
    guidance: Optional[torch.Tensor],  # (B,) guidance scale (e.g. 3.5)
    rope_cos: torch.Tensor,  # (L_txt + L_img, head_dim)
    rope_sin: torch.Tensor,
    *,
    dtype=torch.bfloat16,
    attn_impl: str = "auto",
    remat=False,
    virtual_depth: Optional[tuple] = None,
    pad_seq_multiple: int = 128,
) -> torch.Tensor:
    """Predict rectified-flow velocity for packed image tokens (f32).

    timestep/guidance are scaled by 1000 before the sinusoidal embedding;
    the conditioning vector is time + guidance + pooled projections.

    ``remat``: recompute each block in the backward (any true value; JAX's
    ``"dots"`` included).  ``virtual_depth=(DD, DS)``: DD double and DS
    single block applications cycling the resident stacks.

    ``pad_seq_multiple``: pad the image-token tail so the joint sequence is a
    multiple (identity-RoPE pad positions, key-masked in attention through
    the static ``kv_valid`` prefix, sliced off before the final layer).
    Applied only when S >= 8 x multiple, so tiny test shapes keep their exact
    layout; 0 disables.  At 720px S = 2537 runs as 2560 with kv_valid 2537.
    """
    layout = os.environ.get("MIXGRPO_ATTN_LAYOUT", "bhsd")
    if layout not in ("bhsd", "bshd"):
        raise ValueError(f"MIXGRPO_ATTN_LAYOUT must be bhsd or bshd, got {layout!r}")
    L_txt, L_img = txt.shape[1], img.shape[1]
    S_total = L_txt + L_img
    npad = (-S_total) % pad_seq_multiple if pad_seq_multiple else 0
    attn_valid = None
    if npad and S_total >= 8 * pad_seq_multiple:
        img = F.pad(img, (0, 0, 0, npad))
        D = rope_cos.shape[-1]
        rope_cos = torch.cat([rope_cos, rope_cos.new_ones((npad, D))])
        rope_sin = torch.cat([rope_sin, rope_sin.new_zeros((npad, D))])
        attn_valid = S_total

    x = L.linear(params["x_embedder"], img, dtype)
    c = L.linear(params["context_embedder"], txt, dtype)

    vec = L.mlp_embedder(
        params["time_in"],
        L.timestep_embedding(timestep * 1000.0, cfg.time_freq_dim),
        dtype,
    )
    if cfg.guidance_embeds:
        if guidance is None:
            raise ValueError("guidance-distilled model needs guidance")
        vec = vec + L.mlp_embedder(
            params["guidance_in"],
            L.timestep_embedding(guidance * 1000.0, cfg.time_freq_dim),
            dtype,
        )
    vec = vec + L.mlp_embedder(params["vector_in"], pooled, dtype)

    rope_cos, rope_sin = rope_cos.float(), rope_sin.float()
    if layout == "bshd":  # (S, 1, D): S lines up with the token axis
        rope_cos, rope_sin = rope_cos[:, None, :], rope_sin[:, None, :]

    def double(x, c, p):
        return _double_block(p, cfg, x, c, vec, rope_cos, rope_sin, attn_impl, dtype,
                             layout, attn_valid=attn_valid)

    def single(joint, p):
        return _single_block(p, cfg, joint, vec, rope_cos, rope_sin, attn_impl, dtype,
                             layout, attn_valid=attn_valid)

    def run(body, *args):
        if remat and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(body, *args, use_reentrant=False)
        return body(*args)

    doubles, singles = _unstack(params["double"]), _unstack(params["single"])
    n_double, n_single = virtual_depth or (len(doubles), len(singles))
    for i in range(n_double):
        x, c = run(double, x, c, doubles[i % len(doubles)])
    joint = torch.cat([c, x], dim=1)
    for i in range(n_single):
        joint = run(single, joint, singles[i % len(singles)])
    x = joint[:, L_txt : L_txt + L_img]

    scale, shift = L.modulation(params["final_mod"], vec, 2, dtype)
    x = L.modulate(L.layer_norm(x, cfg.eps), shift, scale)
    return L.linear(params["proj_out"], x, dtype).float()


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(param_count(v) for v in params)
    return params.numel()

"""HunyuanVideo MMDiT, plain PyTorch functions on a parameter dict.

Port of mixgrpo_tpu/models/hunyuan/model.py (hidden 3072, 24 heads x 128,
20 double + 40 single blocks, 16 latent channels, patch (1, 2, 2), RoPE axes
(16, 56, 56) with theta 256, guidance-distilled).  The double and single
blocks are the port's FLUX blocks (``models/flux/model.py``), as JAX reuses
FLUX's; the video pieces are:

  - the 3D patchify of (B, T, H, W, C) latents into tokens flattened in
    (ph, pw, C) order, and the (t, h, w) RoPE ids of the packed grid; text
    tokens get zero ids, which leave them unrotated;
  - the token refiner: the LLM hidden states (4096) refined by
    self-attention blocks gated on (timestep + masked-mean text)
    conditioning.  Its attention is ``impl="eager"`` with query row 0's key
    forced valid, as JAX calls ``attention(..., impl="xla")`` there;
  - the conditioning vector time + pooled CLIP + guidance;
  - the final layer, whose modulation is (shift, scale), not FLUX's
    (scale, shift).

The joint [text | image] attention takes the text mask as a key mask on
every block.  ``pad_seq_multiple`` pads the image tail so the joint sequence
is a multiple of it, as ``flux_forward`` does; the pad keys enter that same
key mask as False (``mask`` and ``kv_valid`` are exclusive), get identity
RoPE, and are sliced off before the final layer, so the padded forward
equals JAX's unpadded one.  At 192x336 and 129 frames S = 256 + 8316 = 8572
runs as 8576.

Sequence parallelism (JAX's ``attn_impl="ulysses"``, the reference's one
live SP path; also ``"ring"``): the joint attention goes through
``ops/attention.py``'s dispatcher, which splits q, k, v and the key mask
(text and pad keys) over the mesh axis that
``parallel.ulysses.set_sp_context`` installed and gathers the output back,
so the residual stream stays whole on every rank, as JAX's
``constrain_residual`` keeps it.  The refiner's attention stays eager and
local.  S must divide by the axis' size (the 128-multiple padding gives
that for 2, 4 and 8 ranks).  ``remat`` recomputes each block in the backward
under autograd (``torch.utils.checkpoint``), as JAX's ``jax.checkpoint``.
Each forward is a ``dit`` span (``utils/profiling.py``), holding the FLUX
blocks' spans.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mixgrpo_tpu_torch.models.flux import layers as L
from mixgrpo_tpu_torch.models.flux.model import (
    FluxConfig, _attn_layout, _double_block, _double_blocks_init, _merge_heads,
    _pad_joint, _single_block, _single_blocks_init, _unstack,
)
from mixgrpo_tpu_torch.models.flux.rope import rope_tables
from mixgrpo_tpu_torch.ops.attention import attention
from mixgrpo_tpu_torch.ops.qk_rope import split_heads
from mixgrpo_tpu_torch.utils.profiling import spanned


@dataclasses.dataclass(frozen=True)
class HunyuanVideoConfig:
    patch_size: tuple = (1, 2, 2)
    in_channels: int = 16
    hidden_size: int = 3072
    num_heads: int = 24
    mlp_ratio: float = 4.0
    depth_double: int = 20
    depth_single: int = 40
    rope_dim_list: tuple = (16, 56, 56)
    rope_theta: float = 256.0
    text_states_dim: int = 4096  # LLM hidden states
    text_states_dim_2: int = 768  # CLIP pooled
    refiner_depth: int = 2
    guidance_embed: bool = True
    time_freq_dim: int = 256
    eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def mlp_hidden(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)

    @property
    def patch_elems(self) -> int:
        pt, ph, pw = self.patch_size
        return pt * ph * pw * self.in_channels

    def block_cfg(self) -> FluxConfig:
        """FLUX-block view (the blocks are structurally identical)."""
        return FluxConfig(
            in_channels=self.patch_elems, hidden_size=self.hidden_size,
            num_heads=self.num_heads, mlp_ratio=self.mlp_ratio,
            depth_double=self.depth_double, depth_single=self.depth_single,
            axes_dims=self.rope_dim_list, pooled_dim=self.text_states_dim_2,
            context_dim=self.text_states_dim, guidance_embeds=self.guidance_embed,
            time_freq_dim=self.time_freq_dim, theta=self.rope_theta, eps=self.eps,
        )

    @classmethod
    def hunyuan_video(cls) -> "HunyuanVideoConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "HunyuanVideoConfig":
        return cls(
            in_channels=4, hidden_size=96, num_heads=4, depth_double=1,
            depth_single=2, rope_dim_list=(8, 8, 8), text_states_dim=32,
            text_states_dim_2=16, refiner_depth=1, time_freq_dim=32,
        )


def make_video_ids(t: int, latent_h: int, latent_w: int, sp_size: int = 1) -> np.ndarray:
    """(t * sp_size * h/2 * w/2, 3) position ids [frame, row, col] on the
    packed grid; ``sp_size``: the temporal axis counts ``t * sp_size`` frames,
    as JAX's does for a sequence sharded over time."""
    h, w = latent_h // 2, latent_w // 2
    tt = t * sp_size
    ids = np.zeros((tt, h, w, 3), np.float32)
    ids[..., 0] += np.arange(tt, dtype=np.float32)[:, None, None]
    ids[..., 1] += np.arange(h, dtype=np.float32)[None, :, None]
    ids[..., 2] += np.arange(w, dtype=np.float32)[None, None, :]
    return ids.reshape(tt * h * w, 3)


# ---------------------------------------------------------------------------
# token refiner
# ---------------------------------------------------------------------------


def _refiner_block_init(gen, cfg: HunyuanVideoConfig, kw):
    h = cfg.hidden_size
    ln = lambda: {"scale": torch.ones((h,), **kw), "bias": torch.zeros((h,), **kw)}
    return {
        "norm1": ln(),
        "qkv": L.linear_init(gen, h, 3 * h, **kw),
        "proj": L.linear_init(gen, h, h, **kw),
        "norm2": ln(),
        "mlp_in": L.linear_init(gen, h, cfg.mlp_hidden, **kw),
        "mlp_out": L.linear_init(gen, cfg.mlp_hidden, h, **kw),
        # zero-initialised gates, as in JAX
        "mod": {"lin": {"w": torch.zeros((h, 2 * h), **kw),
                        "b": torch.zeros((2 * h,), **kw)}},
    }


def _ln_affine(p, x, eps):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def _refiner_block(p, cfg, x, c, mask, dtype, layout):
    gate_msa, gate_mlp = L.modulation(p["mod"], c, 2, dtype)
    h = _ln_affine(p["norm1"], x, cfg.eps)
    q, k, v = (split_heads(t, cfg.num_heads, layout)
               for t in L.linear(p["qkv"], h, dtype).chunk(3, dim=-1))
    attn_mask = None
    if mask is not None:
        m = mask.bool().clone()
        m[:, 0] = True  # every query keeps key 0
        attn_mask = m[:, None, None, :]
    o = _merge_heads(attention(q, k, v, mask=attn_mask, impl="eager", layout=layout), layout)
    x = x + gate_msa[:, None, :] * L.linear(p["proj"], o, dtype)
    h = _ln_affine(p["norm2"], x, cfg.eps)
    mlp = L.linear(p["mlp_out"], F.silu(L.linear(p["mlp_in"], h, dtype)), dtype)
    return x + gate_mlp[:, None, :] * mlp


def _refiner_init(gen, cfg: HunyuanVideoConfig, kw):
    h = cfg.hidden_size
    return {
        "input_embedder": L.linear_init(gen, cfg.text_states_dim, h, **kw),
        "t_embedder": L.mlp_embedder_init(gen, cfg.time_freq_dim, h, **kw),
        "c_embedder": L.mlp_embedder_init(gen, cfg.text_states_dim, h, **kw),
        "blocks": [_refiner_block_init(gen, cfg, kw) for _ in range(cfg.refiner_depth)],
    }


def _refine_text(p, cfg, txt, t, mask, dtype, layout):
    """The single token refiner: masked-mean context + timestep gate the
    refiner blocks over the projected LLM states."""
    t_repr = L.mlp_embedder(p["t_embedder"], L.timestep_embedding(t, cfg.time_freq_dim), dtype)
    if mask is None:
        ctx = txt.float().mean(dim=1)
    else:
        mf = mask.float()[..., None]
        ctx = (txt.float() * mf).sum(dim=1) / mf.sum(dim=1).clamp_min(1e-6)
    c = t_repr + L.mlp_embedder(p["c_embedder"], ctx.to(dtype), dtype)
    x = L.linear(p["input_embedder"], txt.to(dtype), dtype)
    for bp in p["blocks"]:
        x = _refiner_block(bp, cfg, x, c, mask, dtype, layout)
    return x


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


def init_hunyuan_video(cfg: HunyuanVideoConfig, *, generator: Optional[torch.Generator] = None,
                       device="cuda", dtype=torch.float32) -> Dict[str, Any]:
    """Random weights in the JAX layout, drawn tensor by tensor at ``dtype``
    on ``device``.  The values differ from JAX's ``init_hunyuan_video``;
    tests carry JAX weights over with ``convert.from_jax_params``."""
    bcfg = cfg.block_cfg()
    h = cfg.hidden_size
    kw = dict(device=device, dtype=dtype)
    g = generator
    params = {
        "img_in": L.linear_init(g, cfg.patch_elems, h, **kw),
        "txt_in": _refiner_init(g, cfg, kw),
        "time_in": L.mlp_embedder_init(g, cfg.time_freq_dim, h, **kw),
        "vector_in": L.mlp_embedder_init(g, cfg.text_states_dim_2, h, **kw),
        "final_mod": L.modulation_init(g, h, 2, **kw),
        "final_proj": L.linear_init(g, h, cfg.patch_elems, **kw),
    }
    if cfg.guidance_embed:
        params["guidance_in"] = L.mlp_embedder_init(g, cfg.time_freq_dim, h, **kw)
    params["double"] = _double_blocks_init(g, bcfg, kw)
    params["single"] = _single_blocks_init(g, bcfg, kw)
    return params


def _patchify(x, cfg: HunyuanVideoConfig):
    B, T, H, W, C = x.shape
    _, ph, pw = cfg.patch_size
    x = x.reshape(B, T, H // ph, ph, W // pw, pw, C).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(B, T * (H // ph) * (W // pw), ph * pw * C)


def _unpatchify(x, cfg: HunyuanVideoConfig, shape):
    B, T, H, W, C = shape
    _, ph, pw = cfg.patch_size
    x = x.reshape(B, T, H // ph, W // pw, ph, pw, C).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(B, T, H, W, C)


@spanned("dit")
def hunyuan_video_forward(
    params: Dict[str, Any],
    cfg: HunyuanVideoConfig,
    video_latents: torch.Tensor,  # (B, T, H, W, C)
    txt: torch.Tensor,  # (B, L, text_states_dim) LLM hidden states
    pooled: torch.Tensor,  # (B, text_states_dim_2) CLIP pooled
    timestep: torch.Tensor,  # (B,) in [0, 1]
    guidance: Optional[torch.Tensor] = None,
    text_mask: Optional[torch.Tensor] = None,  # (B, L), 1 = a text token
    *,
    dtype=torch.bfloat16,
    attn_impl: str = "auto",
    remat: bool = True,
    pad_seq_multiple: int = 128,
) -> torch.Tensor:
    """Velocity for video latents, (B, T, H, W, C) f32.

    ``attn_impl``: the joint attention's (``"ulysses"`` and ``"ring"`` need
    ``parallel.ulysses.set_sp_context``).  ``remat``: recompute each block
    in the backward (only when autograd records).  ``pad_seq_multiple``: pad
    the image tail as ``flux_forward`` does (``_pad_joint``); the pad keys
    join the key mask and are sliced off again."""
    if cfg.patch_size[0] != 1:
        raise ValueError("temporal patching > 1 is not needed for HunyuanVideo")
    layout = _attn_layout()
    bcfg = cfg.block_cfg()
    shape = tuple(video_latents.shape)
    B, T, H, W, _ = shape
    dev = video_latents.device
    x = L.linear(params["img_in"], _patchify(video_latents, cfg).to(dtype), dtype)
    L_txt, L_img = txt.shape[1], x.shape[1]

    t_scaled = timestep * 1000.0
    if text_mask is not None:
        text_mask = torch.as_tensor(text_mask, device=dev)
    c = _refine_text(params["txt_in"], cfg, txt, t_scaled, text_mask, dtype, layout)

    vec = L.mlp_embedder(params["time_in"],
                         L.timestep_embedding(t_scaled, cfg.time_freq_dim), dtype)
    vec = vec + L.mlp_embedder(params["vector_in"], pooled.to(dtype), dtype)
    if cfg.guidance_embed:
        if guidance is None:
            raise ValueError("guidance-distilled model needs guidance")
        vec = vec + L.mlp_embedder(
            params["guidance_in"],
            L.timestep_embedding(guidance * 1000.0, cfg.time_freq_dim), dtype)

    ids = np.concatenate([np.zeros((L_txt, 3), np.float32), make_video_ids(T, H, W)])
    rope_cos, rope_sin = rope_tables(ids, cfg.rope_dim_list, cfg.rope_theta, device=dev)

    # the key mask over [txt | img | pad]; None when nothing is masked
    S_total = L_txt + L_img
    x, rope_cos, rope_sin, npad = _pad_joint(x, rope_cos, rope_sin, S_total,
                                             pad_seq_multiple)
    valid = attn_valid = None
    if text_mask is not None:
        valid = torch.cat([text_mask.bool(), torch.ones((B, L_img), dtype=torch.bool,
                                                        device=dev)], dim=1)
        valid = F.pad(valid, (0, npad), value=False)
    elif npad:
        attn_valid = S_total
    attn_mask = None if valid is None else valid[:, None, None, :]
    if layout == "bshd":  # (S, 1, D): S lines up with the token axis
        rope_cos, rope_sin = rope_cos[:, None, :], rope_sin[:, None, :]

    doubles, singles = _unstack(params["double"]), _unstack(params["single"])

    def double(x, c, p):
        return _double_block(p, bcfg, x, c, vec, rope_cos, rope_sin, attn_impl, dtype,
                             layout, attn_valid=attn_valid, attn_mask=attn_mask)

    def single(joint, p):
        return _single_block(p, bcfg, joint, vec, rope_cos, rope_sin, attn_impl, dtype,
                             layout, attn_valid=attn_valid, attn_mask=attn_mask)

    def run(body, *args):
        if remat and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(body, *args, use_reentrant=False)
        return body(*args)

    for p in doubles:
        x, c = run(double, x, c, p)
    joint = torch.cat([c, x], dim=1)
    for p in singles:
        joint = run(single, joint, p)
    x = joint[:, L_txt:L_txt + L_img]

    # the final layer: shift first (FLUX's is scale first)
    shift, scale = L.modulation(params["final_mod"], vec, 2, dtype)
    x = L.modulate(L.layer_norm(x, cfg.eps), shift, scale)
    x = L.linear(params["final_proj"], x, dtype).float()
    return _unpatchify(x, cfg, shape)

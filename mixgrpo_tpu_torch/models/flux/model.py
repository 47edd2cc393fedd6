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

Tensor parallelism (``tp=`` a mesh whose ``tp`` axis has more than one
rank): the blocks' leaves are this rank's Megatron slices
(``parallel/sharding.py``), and each block reads its head count and split
points from them, not from ``cfg``.  The residual stream, the modulation and
the norms stay whole on every ``tp`` rank; each whole value that enters a
column-parallel product or scales this rank's heads goes through
``collectives.tp_enter`` (whose backward sums the ranks' gradients), and
each row-parallel product (``*_attn_out``, ``*_mlp_out``, ``linear2``) is
summed over ``tp`` before its bias is added (``layers.row_linear``): four
all-reduces per double block and one per single block.  Attention runs on
the rank's heads, so Ulysses (``sp``) splits those again.

Spans (``utils/profiling.py``, recorded only while a profiler runs): each
forward is a ``dit`` span; inside the blocks the disjoint stages ``gemm``
(``layers.linear``), ``attn`` (``ops/attention.py``), ``norm_mod`` (the
LayerNorm and its modulation), ``qk_rope`` (QK-norm, RoPE and the joint
concatenation: ``ops/qk_rope.py``, one kernel launch a block on the card),
``gate_res`` (gate and residual) and ``act`` (GELU), recorded
in one call of every ``profiling.SAMPLE_EVERY``.  What a ``dit`` span holds
outside ``gemm`` and ``attn`` is the call's pointwise time.

``MIXGRPO_ATTN_LAYOUT=bshd`` keeps q/k/v as (B, S, H, D) (the head split is a
free reshape and the attention kernel reads per-head strides); the default
is bhsd, as in JAX.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from mixgrpo_tpu_torch.models.flux import layers as L
from mixgrpo_tpu_torch.ops.attention import attention
from mixgrpo_tpu_torch.ops.qk_rope import qk_rope
from mixgrpo_tpu_torch.parallel.collectives import tp_enter, tp_split
from mixgrpo_tpu_torch.utils.profiling import span, spanned


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


def _merge_heads(x, layout):
    if layout == "bshd":
        b, s, h, d = x.shape
        return x.reshape(b, s, h * d)
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _out_width(p) -> int:
    """A linear leaf's output width (float or int8 weights)."""
    return (p["w"] if "w" in p else p["w_q"]).shape[-1]


def _local_heads(cfg: FluxConfig, width: int, tp) -> int:
    """The heads of ``width`` attention channels, checked against ``cfg``
    split over ``tp`` (the leaves must be the ones ``tp`` says)."""
    H = width // cfg.head_dim
    n = tp.size("tp") if tp_split(tp) else 1
    if H * n != cfg.num_heads:
        raise ValueError(f"a block with {H} heads on {n} tp ranks: the model has "
                         f"{cfg.num_heads} (whole leaves run with tp=None)")
    return H


def _double_block(p, cfg: FluxConfig, img, txt, vec, rope_cos, rope_sin,
                  attn_impl, dtype, layout, attn_valid=None, attn_mask=None, tp=None):
    """Double-stream MMDiT block (on this rank's heads and MLP units when
    ``tp`` splits it)."""
    H, eps = _local_heads(cfg, _out_width(p["img_qkv"]) // 3, tp), cfg.eps
    enter = lambda x: tp_enter(x, tp)
    i_shift1, i_scale1, i_gate1, i_shift2, i_scale2, i_gate2 = L.modulation(
        p["img_mod"], vec, 6, dtype
    )
    t_shift1, t_scale1, t_gate1, t_shift2, t_scale2, t_gate2 = L.modulation(
        p["txt_mod"], vec, 6, dtype
    )

    with span("norm_mod"):
        img_mod = L.modulate(L.layer_norm(img, eps), i_shift1, i_scale1)
        txt_mod = L.modulate(L.layer_norm(txt, eps), t_shift1, t_scale1)

    iqkv = L.linear(p["img_qkv"], enter(img_mod), dtype)
    tqkv = L.linear(p["txt_qkv"], enter(txt_mod), dtype)
    with span("qk_rope"):
        # joint sequence: [text | image] (diffusers FLUX ordering)
        q, k, v = qk_rope([tqkv, iqkv], [enter(p["txt_qnorm"]), enter(p["img_qnorm"])],
                          [enter(p["txt_knorm"]), enter(p["img_knorm"])], rope_cos, rope_sin,
                          eps, H, layout)

    out = attention(q, k, v, mask=attn_mask, kv_valid=attn_valid,
                    impl=attn_impl, layout=layout)
    out = _merge_heads(out, layout)
    Lt = txt.shape[1]
    txt_attn, img_attn = out[:, :Lt], out[:, Lt:]

    y = L.row_linear(p["img_attn_out"], img_attn, dtype, tp)
    with span("gate_res"):
        img = img + i_gate1[:, None, :] * y
    y = L.row_linear(p["txt_attn_out"], txt_attn, dtype, tp)
    with span("gate_res"):
        txt = txt + t_gate1[:, None, :] * y

    img = _mlp(p["img_mlp_in"], p["img_mlp_out"], img, i_shift2, i_scale2, i_gate2, eps, dtype,
               tp)
    txt = _mlp(p["txt_mlp_in"], p["txt_mlp_out"], txt, t_shift2, t_scale2, t_gate2, eps, dtype,
               tp)
    return img, txt


def _mlp(p_in, p_out, x, shift, scale, gate, eps, dtype, tp):
    """A double block's modulated, gated GELU MLP on one stream, with its
    residual."""
    with span("norm_mod"):
        h = L.modulate(L.layer_norm(x, eps), shift, scale)
    h = L.linear(p_in, tp_enter(h, tp), dtype)
    with span("act"):
        h = L.gelu_tanh(h)
    h = L.row_linear(p_out, h, dtype, tp)
    with span("gate_res"):
        return x + gate[:, None, :] * h


def _single_block(p, cfg: FluxConfig, x, vec, rope_cos, rope_sin, attn_impl,
                  dtype, layout, attn_valid=None, attn_mask=None, tp=None):
    """Single-stream block with fused projections (on this rank's heads and
    MLP units when ``tp`` splits it: ``linear1``'s outputs are [q|k|v|mlp]
    and ``linear2``'s inputs [attn|mlp], each part this rank's share)."""
    eps = cfg.eps
    l2_in = (p["linear2"]["w"] if "w" in p["linear2"] else p["linear2"]["w_q"]).shape[-2]
    h = (_out_width(p["linear1"]) - l2_in) // 2  # this rank's attention channels
    H = _local_heads(cfg, h, tp)
    shift, scale, gate = L.modulation(p["mod"], vec, 3, dtype)
    with span("norm_mod"):
        x_mod = L.modulate(L.layer_norm(x, eps), shift, scale)

    proj = L.linear(p["linear1"], tp_enter(x_mod, tp), dtype)
    qkv, mlp = proj[..., : 3 * h], proj[..., 3 * h :]
    with span("qk_rope"):
        q, k, v = qk_rope([qkv], [tp_enter(p["qnorm"], tp)], [tp_enter(p["knorm"], tp)],
                          rope_cos, rope_sin, eps, H, layout)

    attn_out = attention(q, k, v, mask=attn_mask, kv_valid=attn_valid,
                         impl=attn_impl, layout=layout)
    attn_out = _merge_heads(attn_out, layout)
    with span("act"):
        mlp = L.gelu_tanh(mlp)
    out = L.row_linear(p["linear2"], torch.cat([attn_out, mlp], dim=-1), dtype, tp)
    with span("gate_res"):
        return x + gate[:, None, :] * out


# ----------------------------------------------------------------------------
# forward
# ----------------------------------------------------------------------------


def _attn_layout() -> str:
    layout = os.environ.get("MIXGRPO_ATTN_LAYOUT", "bhsd")
    if layout not in ("bhsd", "bshd"):
        raise ValueError(f"MIXGRPO_ATTN_LAYOUT must be bhsd or bshd, got {layout!r}")
    return layout


def _pad_joint(x, rope_cos, rope_sin, S_total: int, multiple: int):
    """Pad the token tail of ``x`` (B, L, C) so a joint sequence of
    ``S_total`` tokens becomes a multiple of ``multiple``; the pad positions
    get identity RoPE.  Applied only when S_total >= 8 x multiple, so tiny
    test shapes keep their exact layout; 0 disables.  Returns (x, rope_cos,
    rope_sin, npad); the caller masks the npad keys and slices them off."""
    npad = (-S_total) % multiple if multiple else 0
    if not npad or S_total < 8 * multiple:
        return x, rope_cos, rope_sin, 0
    D = rope_cos.shape[-1]
    return (F.pad(x, (0, 0, 0, npad)),
            torch.cat([rope_cos, rope_cos.new_ones((npad, D))]),
            torch.cat([rope_sin, rope_sin.new_zeros((npad, D))]), npad)


@spanned("dit")
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
    block_params: Optional[Callable] = None,
    tp=None,
) -> torch.Tensor:
    """Predict rectified-flow velocity for packed image tokens (f32).

    timestep/guidance are scaled by 1000 before the sinusoidal embedding;
    the conditioning vector is time + guidance + pooled projections.

    ``remat``: recompute each block in the backward (any true value; JAX's
    ``"dots"`` included).  ``virtual_depth=(DD, DS)``: DD double and DS
    single block applications cycling the resident stacks.

    ``block_params(stack, i, p)``: the parameters that block ``i`` of
    ``stack`` (``"double"`` or ``"single"``), whose own are ``p``, runs with;
    called inside the block's (recomputed) body, so ``lora.lora_blocks``
    merges an adapter there one block at a time.

    ``tp``: the mesh whose ``tp`` axis splits the blocks' leaves (this
    rank's Megatron slices, ``parallel/sharding.py``); None runs whole
    leaves, as a LoRA base on any mesh is.

    ``pad_seq_multiple``: pad the image-token tail so the joint sequence is a
    multiple (identity-RoPE pad positions, key-masked in attention through
    the static ``kv_valid`` prefix, sliced off before the final layer).
    Applied only when S >= 8 x multiple, so tiny test shapes keep their exact
    layout; 0 disables.  At 720px S = 2537 runs as 2560 with kv_valid 2537.
    """
    layout = _attn_layout()
    L_txt, L_img = txt.shape[1], img.shape[1]
    S_total = L_txt + L_img
    img, rope_cos, rope_sin, npad = _pad_joint(img, rope_cos, rope_sin, S_total,
                                               pad_seq_multiple)
    attn_valid = S_total if npad else None

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

    doubles, singles = _unstack(params["double"]), _unstack(params["single"])
    block = block_params or (lambda stack, i, p: p)

    def double(x, c, i):
        return _double_block(block("double", i, doubles[i]), cfg, x, c, vec, rope_cos,
                             rope_sin, attn_impl, dtype, layout, attn_valid=attn_valid, tp=tp)

    def single(joint, i):
        return _single_block(block("single", i, singles[i]), cfg, joint, vec, rope_cos,
                             rope_sin, attn_impl, dtype, layout, attn_valid=attn_valid, tp=tp)

    def run(body, *args):
        if remat and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(body, *args, use_reentrant=False)
        return body(*args)

    n_double, n_single = virtual_depth or (len(doubles), len(singles))
    for i in range(n_double):
        x, c = run(double, x, c, i % len(doubles))
    joint = torch.cat([c, x], dim=1)
    for i in range(n_single):
        joint = run(single, joint, i % len(singles))
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

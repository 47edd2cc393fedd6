"""Primitive layers for the FLUX MMDiT (plain functions on tensor dicts).

Port of mixgrpo_tpu/models/flux/layers.py.  Conventions kept from JAX so that
converting weights is a tree map:
  - weight matrices are (in, out), forward is ``x @ w``;
  - ``apply`` casts to a compute dtype at the matmul inputs;
  - LayerNorms inside blocks have no affine (eps 1e-6); RMS QK-norm has a
    per-head-dim scale; statistics in fp32.
``linear`` dispatches on ``w_q`` to the int8 product of ``ops/quant.py``.
Each matrix product runs inside a ``gemm`` span (``utils/profiling.py``);
the input casts and the bias add lie outside it.
``row_linear`` is the row-parallel product of a block split over ``tp``
(``parallel/sharding.py``): this rank's partial product, summed over ``tp``,
then the bias, once.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from mixgrpo_tpu_torch.utils import profiling


def linear_init(generator, in_dim: int, out_dim: int, bias: bool = True, *,
                lead: tuple = (), device="cuda", dtype=torch.float32):
    """Uniform(-1/sqrt(in), 1/sqrt(in)) weights, zero bias.  ``lead`` prepends
    stacking axes (a block stack's depth), drawn in one call so a full-size
    stack is made in place at ``dtype`` with no fp32 transient."""
    scale = 1.0 / math.sqrt(in_dim)
    w = torch.empty((*lead, in_dim, out_dim), device=device, dtype=dtype)
    p = {"w": w.uniform_(-scale, scale, generator=generator)}
    if bias:
        p["b"] = torch.zeros((*lead, out_dim), device=device, dtype=dtype)
    return p


def linear(p, x, dtype=None):
    dtype = dtype or x.dtype
    if "w_q" in p:  # int8-quantised weights (ops/quant.py)
        from mixgrpo_tpu_torch.ops.quant import qlinear

        return qlinear(p, x, dtype)
    x, w = x.to(dtype), p["w"].to(dtype)
    with profiling.span("gemm"):
        y = x @ w
    if "b" in p:
        y = y + p["b"].to(dtype)
    return y


def row_linear(p, x, dtype=None, tp=None):
    """``linear`` where ``x``'s last axis and the weight's input rows are this
    rank's share over the ``tp`` axis of the mesh ``tp`` (None, or a mesh of
    one ``tp`` rank: ``linear``): the partial products are summed over
    ``tp`` (Megatron's ``g``), and the bias is added after the sum."""
    from mixgrpo_tpu_torch.parallel.collectives import tp_reduce, tp_split

    if not tp_split(tp):
        return linear(p, x, dtype)
    dtype = dtype or x.dtype
    if "w_q" in p:
        from mixgrpo_tpu_torch.ops.quant import qlinear

        return qlinear(p, x, dtype, tp=tp)
    x, w = x.to(dtype), p["w"].to(dtype)
    with profiling.span("gemm"):
        y = x @ w
    y = tp_reduce(y, tp)
    return y + p["b"].to(dtype) if "b" in p else y


def layer_norm(x, eps: float = 1e-6):
    """Non-affine LayerNorm computed in fp32."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm with learnable scale, fp32 accumulation (QK-norm)."""
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)).to(x.dtype) * scale.to(x.dtype)


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    """Sinusoidal embedding, flip_sin_to_cos=True, freq shift 0: [cos | sin].
    FLUX scales (t, guidance) by 1000 before embedding."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    angle = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(angle), torch.sin(angle)], dim=-1)


def mlp_embedder_init(generator, in_dim: int, hidden: int, **kw):
    return {
        "in": linear_init(generator, in_dim, hidden, **kw),
        "out": linear_init(generator, hidden, hidden, **kw),
    }


def mlp_embedder(p, x, dtype):
    return linear(p["out"], F.silu(linear(p["in"], x, dtype)), dtype)


def modulation_init(generator, hidden: int, factor: int, **kw):
    """adaLN modulation head: vec -> SiLU -> Linear(hidden -> factor*hidden)."""
    return {"lin": linear_init(generator, hidden, factor * hidden, **kw)}


def modulation(p, vec, factor: int, dtype):
    out = linear(p["lin"], F.silu(vec.to(dtype)), dtype)
    return out.chunk(factor, dim=-1)


def modulate(x, shift, scale):
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]

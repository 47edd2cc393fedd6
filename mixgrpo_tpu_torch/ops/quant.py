"""Int8 weights with dynamic per-token activation quantisation, for rollouts
and serving.

Port of mixgrpo_tpu/ops/quant.py.  The GRPO rollout and serving take no
gradient, so the block matmuls that carry nearly all of a FLUX forward's
FLOPs can run as int8 x int8 -> int32 products (``torch._int_mm``: a
cuBLASLt int8 GEMM on the card, at twice the bf16 tensor-core rate on paper).

Scheme (as in JAX):
  - weights: symmetric per output channel, scale = max|w| / 127 over the
    contraction axis (-2); a stacked block weight (L, in, out) becomes an
    (L, in, out) int8 tensor and an (L, 1, out) f32 scale, so
    ``models/flux/model.py::_unstack`` slices both unchanged.  The int8
    tensor is stored column-major (its memory is (L, out, in)), the layout
    in which cuBLASLt's int8 GEMM takes its second operand without a copy
    per call; its logical shape and values are JAX's.  A leaf is quantised
    one (in, out) slice at a time, so a full-depth FLUX.1-dev
    ``single.linear1`` (38, 3072, 21504) needs 0.26 GB of f32 temporaries,
    not the 10 GB of the whole stack;
  - activations: per token (max|x| over the last axis), rounded half to
    even, an int32 product, then ``y.float() * x_scale * w_scale``, the bias
    in f32, and a cast to the compute dtype.

The per-token quantisation and the dequantisation are torch ops; a fused pass
waits for a measurement (ROADMAP Queue 2).  ``_int_mm``'s constraints on the
card (more than 16 rows, K and N multiples of 8) are met by FLUX's block
matmuls; a shape it refuses raises, and no float product takes its place.

On a block split over ``tp`` (``parallel/sharding.py``) the scales stay
JAX's global ones: a row-parallel weight's rows are split over ``tp``, so its
max|w| is the max over ``tp`` of each rank's (``quantize_flux_params(...,
tp=mesh)``), and so is the per-token max|x| of a row-parallel product's
input (``qlinear(..., tp=mesh)``); the ranks' int32 products are summed over
``tp`` as integers before the dequantisation, so each rank's output equals
one rank's.

The quantised network is the behaviour policy of an int8 rollout: its
log-probs are the PPO "old" log-probs, so the importance ratio stays a
correct off-policy correction; watch ``clip_frac`` (JAX's docstring).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from mixgrpo_tpu_torch.utils import profiling

# Per-token matmuls that carry nearly all of the forward FLOPs (model.py blocks).
DOUBLE_QUANT_KEYS = (
    "img_qkv", "txt_qkv", "img_attn_out", "txt_attn_out",
    "img_mlp_in", "img_mlp_out", "txt_mlp_in", "txt_mlp_out",
)
SINGLE_QUANT_KEYS = ("linear1", "linear2")


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """max|v| / 127 (1/127 where max|v| is 0).  The divisor is a tensor on
    amax's device: CUDA divides by a Python number as a product with its
    reciprocal, which can differ in the last bit from the CPU's and JAX's
    division."""
    return torch.where(amax > 0, amax, torch.ones_like(amax)) / amax.new_full((), 127.0)


def _tp_max_(amax: torch.Tensor, tp) -> torch.Tensor:
    """``amax`` in place as its max over ``tp``'s ranks (a rows-split
    operand), or as it is."""
    from mixgrpo_tpu_torch.parallel.collectives import all_reduce_, tp_split

    return all_reduce_(amax, tp, "tp", op="max") if tp_split(tp) else amax


@torch.no_grad()
def quantize_weight(w: torch.Tensor, tp=None):
    """(..., in, out) weights -> (int8 weights (..., in, out), column-major;
    f32 scales (..., 1, out)), one (in, out) slice at a time.  ``tp``: the
    input rows are this rank's share over the mesh's ``tp`` axis, and the
    scales are taken over every rank's rows."""
    *lead, k, n = w.shape
    w_q = torch.empty((*lead, n, k), dtype=torch.int8, device=w.device).transpose(-1, -2)
    amax = torch.empty((*lead, 1, n), dtype=torch.float32, device=w.device)
    flat_w, flat_q, flat_a = w.reshape(-1, k, n), w_q.view(-1, k, n), amax.view(-1, 1, n)
    for i in range(flat_w.shape[0]):
        flat_a[i] = flat_w[i].float().abs().amax(dim=-2, keepdim=True)
    scale = _scale(_tp_max_(amax, tp))
    flat_s = scale.view(-1, 1, n)
    for i in range(flat_w.shape[0]):
        flat_q[i] = torch.round(flat_w[i].float() / flat_s[i]).to(torch.int8)
    return w_q, scale


def quantize_linear_params(p: Dict[str, Any], tp=None) -> Dict[str, Any]:
    """{"w", "b"?} -> {"w_q", "w_s", "b"?} (``layers.linear`` dispatches on
    ``w_q``); the bias is the input's tensor.  ``tp``: as
    ``quantize_weight``'s (a row-parallel weight)."""
    w_q, w_s = quantize_weight(p["w"], tp)
    out = {"w_q": w_q, "w_s": w_s}
    if "b" in p:
        out["b"] = p["b"]
    return out


def qlinear(p: Dict[str, Any], x: torch.Tensor, dtype=None, tp=None) -> torch.Tensor:
    """Int8 matmul with dynamic per-token activation quantisation.  ``tp``: a
    row-parallel product (``x``'s last axis and the weight's rows are this
    rank's share over the mesh's ``tp`` axis): the per-token scale is the
    max over ``tp``, and the int32 products are summed over ``tp``."""
    from mixgrpo_tpu_torch.parallel.collectives import tp_reduce

    dtype = dtype or x.dtype
    xf = x.float()
    xs = _scale(_tp_max_(xf.abs().amax(dim=-1, keepdim=True), tp))
    xq = torch.round(xf / xs).to(torch.int8)
    xq = xq.reshape(-1, xq.shape[-1])
    with profiling.span("gemm"):
        y = torch._int_mm(xq, p["w_q"])
    y = tp_reduce(y, tp)
    y = y.reshape(*x.shape[:-1], y.shape[-1]).float() * xs * p["w_s"]
    if "b" in p:
        y = y + p["b"].float()
    return y.to(dtype)


ROW_PARALLEL_KEYS = ("img_attn_out", "txt_attn_out", "img_mlp_out", "txt_mlp_out", "linear2")


def quantize_flux_params(params: Dict[str, Any], tp=None) -> Dict[str, Any]:
    """Quantise the stacked double/single block matmuls of a FLUX parameter
    tree; embedders, modulation heads and norms (few per-token FLOPs) stay
    the input's tensors.  The result drops into ``flux_forward`` unchanged.
    ``tp``: the blocks are this rank's slices over the mesh's ``tp`` axis
    (the row-parallel weights' scales are then taken over ``tp``)."""
    row = lambda k: tp if k in ROW_PARALLEL_KEYS else None
    out = dict(params)
    d = dict(params["double"])
    for k in DOUBLE_QUANT_KEYS:
        d[k] = quantize_linear_params(d[k], row(k))
    s = dict(params["single"])
    for k in SINGLE_QUANT_KEYS:
        s[k] = quantize_linear_params(s[k], row(k))
    out["double"], out["single"] = d, s
    return out

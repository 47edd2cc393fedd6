"""T5 v1.1 encoder in plain PyTorch (the FLUX T5-XXL text encoder).

Port of mixgrpo_tpu/models/text/t5.py (google/t5-v1_1-xxl encoder): RMSNorm
pre-norm blocks with the f32 statistics cast back before the scale, one
(1, H, S, S) relative-position-bucket bias computed from block 0's table and
shared by every block, no 1/sqrt(d) q-scaling, f32 logits and softmax with
the probabilities cast to the compute dtype before P.V, a gated-GELU
feed-forward with the tanh approximation, and no biases anywhere.  The
parameters keep the JAX layout: (in, out) weights and the blocks stacked
along a leading depth axis.

The attention is plain torch: its bias is a per-head (S, S) matrix, which the
port's flash kernel (key-side masks only) does not take, as JAX too leaves it
to XLA.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from mixgrpo_tpu_torch.utils.safetensors_io import read_tensor, stack_blocks


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab: int = 32128
    d_model: int = 4096
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    head_dim: int = 64
    rel_buckets: int = 32
    rel_max_distance: int = 128
    eps: float = 1e-6

    @classmethod
    def xxl(cls) -> "T5Config":
        return cls()

    @classmethod
    def tiny(cls) -> "T5Config":
        return cls(vocab=128, d_model=32, d_ff=64, num_layers=2, num_heads=2,
                   head_dim=16, rel_buckets=8, rel_max_distance=16)


def _rms(scale, x, eps):
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)).to(x.dtype) * scale.to(x.dtype)


def init_t5(cfg: T5Config, *, generator: Optional[torch.Generator] = None, device="cuda",
            dtype=torch.float32) -> Dict[str, Any]:
    """Random T5 weights in the JAX layout (values differ from JAX's)."""
    inner, L = cfg.num_heads * cfg.head_dim, cfg.num_layers
    kw = dict(device=device, dtype=dtype)

    def dense(i, o):
        return torch.empty((L, i, o), **kw).normal_(0.0, i ** -0.5, generator=generator)

    ones = lambda: torch.ones((L, cfg.d_model), **kw)
    return {
        "token_emb": torch.empty((cfg.vocab, cfg.d_model), **kw).normal_(generator=generator),
        "rel_bias": torch.empty((cfg.rel_buckets, cfg.num_heads), **kw).normal_(
            0.0, 0.02, generator=generator),
        "blocks": {
            "ln_attn": ones(), "q": dense(cfg.d_model, inner), "k": dense(cfg.d_model, inner),
            "v": dense(cfg.d_model, inner), "o": dense(inner, cfg.d_model), "ln_ff": ones(),
            "wi_0": dense(cfg.d_model, cfg.d_ff), "wi_1": dense(cfg.d_model, cfg.d_ff),
            "wo": dense(cfg.d_ff, cfg.d_model),
        },
        "final_ln": torch.ones((cfg.d_model,), **kw),
    }


def _relative_buckets(relative_position, num_buckets, max_distance):
    """T5 bidirectional relative-position bucketing (HF parity)."""
    num_buckets //= 2
    ret = (relative_position > 0).to(torch.int64) * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-9)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.int64)
    val_large = torch.clamp(val_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_large)


def relative_position_bias(params, cfg: T5Config, seq_len: int) -> torch.Tensor:
    """(1, heads, S, S) additive attention bias."""
    dev = params["rel_bias"].device
    ctx = torch.arange(seq_len, device=dev)[:, None]
    mem = torch.arange(seq_len, device=dev)[None, :]
    buckets = _relative_buckets(mem - ctx, cfg.rel_buckets, cfg.rel_max_distance)
    return params["rel_bias"][buckets].permute(2, 0, 1)[None]  # (S, S, H) -> (1, H, S, S)


@torch.no_grad()
def t5_encode(params, cfg: T5Config, token_ids: torch.Tensor,
              attention_mask: Optional[torch.Tensor] = None, *, dtype=torch.bfloat16
              ) -> torch.Tensor:
    """Encoder forward: (B, S) ids (and an optional (B, S) mask, 1 = keep)
    -> (B, S, d_model) f32."""
    B, S = token_ids.shape
    H, hd = cfg.num_heads, cfg.head_dim
    dev = params["token_emb"].device
    token_ids = torch.as_tensor(token_ids, device=dev).long()
    x = params["token_emb"].to(dtype)[token_ids]
    bias = relative_position_bias(params, cfg, S).float()
    if attention_mask is not None:
        keep = torch.as_tensor(attention_mask, device=dev).bool()
        neg = torch.finfo(torch.float32).min
        bias = bias + torch.where(keep, 0.0, neg)[:, None, None, :]
    heads = lambda t: t.reshape(B, S, H, hd).transpose(1, 2)
    blocks = params["blocks"]
    for i in range(blocks["q"].shape[0]):
        p = {k: v[i] for k, v in blocks.items()}
        h = _rms(p["ln_attn"], x, cfg.eps)
        q, k, v = (heads(h @ p[n].to(dtype)) for n in ("q", "k", "v"))
        # no 1/sqrt(d) scaling; the relative bias is added to f32 logits
        logits = q.float() @ k.float().transpose(-1, -2) + bias
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        o = (probs.float() @ v.float()).to(dtype)
        x = x + o.transpose(1, 2).reshape(B, S, H * hd) @ p["o"].to(dtype)
        h = _rms(p["ln_ff"], x, cfg.eps)
        # T5 v1.1 "gated-gelu" uses the tanh approximation (HF gelu_new)
        gate = F.gelu(h @ p["wi_0"].to(dtype), approximate="tanh")
        x = x + (gate * (h @ p["wi_1"].to(dtype))) @ p["wo"].to(dtype)
    return _rms(params["final_ln"], x, cfg.eps).float()


def load_t5_hf(state: Mapping, cfg: T5Config, *, device="cuda", dtype=torch.float32
               ) -> Dict[str, Any]:
    """Map HF ``T5EncoderModel`` names onto the JAX layout; ``state`` is a
    ``SafetensorsDir`` (read lazily to ``device``) or a ``state_dict``."""
    pre = "encoder." if any(k.startswith("encoder.") for k in state) else ""
    get = lambda n: read_tensor(state, pre + n, device, dtype)
    lin = lambda n: get(n).t().contiguous()

    def block(i):
        b = f"block.{i}.layer"
        return {
            "ln_attn": get(f"{b}.0.layer_norm.weight"),
            "q": lin(f"{b}.0.SelfAttention.q.weight"),
            "k": lin(f"{b}.0.SelfAttention.k.weight"),
            "v": lin(f"{b}.0.SelfAttention.v.weight"),
            "o": lin(f"{b}.0.SelfAttention.o.weight"),
            "ln_ff": get(f"{b}.1.layer_norm.weight"),
            "wi_0": lin(f"{b}.1.DenseReluDense.wi_0.weight"),
            "wi_1": lin(f"{b}.1.DenseReluDense.wi_1.weight"),
            "wo": lin(f"{b}.1.DenseReluDense.wo.weight"),
        }

    emb = "shared.weight" if "shared.weight" in state else pre + "embed_tokens.weight"
    return {
        "token_emb": read_tensor(state, emb, device, dtype),
        "rel_bias": get("block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
        "blocks": stack_blocks(cfg.num_layers, block),
        "final_ln": get("final_layer_norm.weight"),
    }

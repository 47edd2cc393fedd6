"""Llama-3 decoder as a hidden-state text encoder (HunyuanVideo's LLM).

Port of mixgrpo_tpu/models/text/llama.py: the text tower of
llava-llama-3-8b (HF ``LlamaModel``: RMSNorm pre-norm, rotary embeddings,
grouped-query attention with 8 kv heads repeated to 32, SwiGLU MLP, final
RMSNorm), read at HF ``hidden_states[-(skip + 1)]``.  HunyuanVideo reads
``hidden_state_skip_layer=2``: 30 of the 32 layers run and no final norm is
applied.

Kept from JAX: the parameter layout ((in, out) weights, blocks stacked along
a leading depth axis), RoPE in HF's half-split rotation with tables built in
f64 (theta 500,000) and applied in the compute dtype, and the additive bias
of the causal mask plus the key padding, each ``finfo(f32).min`` (their sum
overflows to -inf in both frameworks; every row keeps key 0, so no row is
all -inf).  Attention is eager (f32 scores and softmax, the probabilities
rounded to the compute dtype before P.V), as JAX computes it outside any
Pallas kernel.

``load_llama_hf`` reads HF names (bare, ``model.``- or
``language_model.model.``-prefixed) tensor by tensor to ``device`` at
``dtype`` (bf16 by default), so the 8B tower needs no f32 host copy.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mixgrpo_tpu_torch.utils.safetensors_io import read_tensor, stack_blocks


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab: int = 128320
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    rope_theta: float = 500000.0
    eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @classmethod
    def llava_llama3_8b(cls) -> "LlamaConfig":
        """Text tower of xtuner/llava-llama-3-8b-v1_1 (HunyuanVideo's LLM)."""
        return cls()

    @classmethod
    def tiny(cls) -> "LlamaConfig":
        return cls(vocab=128, d_model=32, n_layers=4, n_heads=4, n_kv_heads=2,
                   d_ff=64, rope_theta=10000.0)


def _rms(scale, x, eps):
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)).to(x.dtype) * scale.to(x.dtype)


def init_llama(cfg: LlamaConfig, *, generator: Optional[torch.Generator] = None,
               device="cuda", dtype=torch.float32) -> Dict[str, Any]:
    """Random weights in the JAX layout (normal, std in^-0.5; embeddings std
    0.02), drawn at ``dtype`` on ``device``."""
    kw = dict(device=device, dtype=dtype)
    n, hd = cfg.n_layers, cfg.head_dim

    def dense(i, o):
        return torch.empty((n, i, o), **kw).normal_(0.0, i**-0.5, generator=generator)

    blocks = {
        "ln_attn": torch.ones((n, cfg.d_model), **kw),
        "q": dense(cfg.d_model, cfg.n_heads * hd),
        "k": dense(cfg.d_model, cfg.n_kv_heads * hd),
        "v": dense(cfg.d_model, cfg.n_kv_heads * hd),
        "o": dense(cfg.n_heads * hd, cfg.d_model),
        "ln_mlp": torch.ones((n, cfg.d_model), **kw),
        "gate": dense(cfg.d_model, cfg.d_ff),
        "up": dense(cfg.d_model, cfg.d_ff),
        "down": dense(cfg.d_ff, cfg.d_model),
    }
    emb = torch.empty((cfg.vocab, cfg.d_model), **kw).normal_(0.0, 0.02, generator=generator)
    return {"token_emb": emb, "blocks": blocks, "final_ln": torch.ones((cfg.d_model,), **kw)}


def _rope_tables(cfg: LlamaConfig, seq_len: int, device):
    """(S, hd/2) cos/sin tables (HF's half-split rotation), built in f64."""
    hd = cfg.head_dim
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd))
    freqs = np.outer(np.arange(seq_len, dtype=np.float64), inv)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    return f32(np.cos(freqs)), f32(np.sin(freqs))


def _apply_rope(x, cos, sin):
    """x: (B, H, S, hd); [x1|x2] -> [x1*c - x2*s | x2*c + x1*s] in x's dtype."""
    hd = x.shape[-1]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    c, s = cos.to(x.dtype), sin.to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _block(p, x, bias, cos, sin, cfg: LlamaConfig, dtype):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = _rms(p["ln_attn"], x, cfg.eps)
    heads = lambda w, n: (h @ w.to(dtype)).reshape(B, S, n, hd).transpose(1, 2)
    q = _apply_rope(heads(p["q"], H), cos, sin)
    k = _apply_rope(heads(p["k"], KV), cos, sin)
    v = heads(p["v"], KV)
    # GQA: each kv head serves H / KV query heads
    k, v = (t.repeat_interleave(H // KV, dim=1) for t in (k, v))
    logits = (q.float() @ k.float().transpose(-1, -2)) * (hd**-0.5) + bias
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    o = (probs.float() @ v.float()).to(dtype)
    x = x + o.transpose(1, 2).reshape(B, S, H * hd) @ p["o"].to(dtype)
    h = _rms(p["ln_mlp"], x, cfg.eps)
    gate = F.silu(h @ p["gate"].to(dtype))
    return x + (gate * (h @ p["up"].to(dtype))) @ p["down"].to(dtype)


@torch.no_grad()
def llama_hidden_states(
    params,
    cfg: LlamaConfig,
    token_ids,  # (B, S) int
    attention_mask=None,  # (B, S), 1 = keep
    *,
    hidden_state_skip_layer: int = 0,
    apply_final_norm: bool = False,
    dtype=torch.bfloat16,
) -> torch.Tensor:
    """Decoder forward -> (B, S, d_model) f32 hidden states.

    ``hidden_state_skip_layer=k`` returns HF ``hidden_states[-(k+1)]``: k = 0
    is the final-norm output (``last_hidden_state``); k > 0 the raw output of
    layer ``n_layers - k`` (normed only with ``apply_final_norm``)."""
    dev = params["token_emb"].device
    ids = torch.as_tensor(token_ids, device=dev).long()
    S = ids.shape[1]
    x = params["token_emb"][ids].to(dtype)
    cos, sin = _rope_tables(cfg, S, dev)

    neg = torch.finfo(torch.float32).min
    causal = torch.ones((S, S), dtype=torch.bool, device=dev).tril()
    zero = torch.zeros((), device=dev)
    bias = torch.where(causal, zero, neg)[None, None]  # (1, 1, S, S)
    if attention_mask is not None:
        m = torch.as_tensor(attention_mask, device=dev).bool()
        bias = bias + torch.where(m, zero, neg)[:, None, None, :]

    skip = int(hidden_state_skip_layer)
    if not 0 <= skip <= cfg.n_layers:
        raise ValueError(f"hidden_state_skip_layer={skip} outside [0, {cfg.n_layers}]")
    blocks = params["blocks"]
    for i in range(cfg.n_layers - skip):
        x = _block({k: v[i] for k, v in blocks.items()}, x, bias, cos, sin, cfg, dtype)
    if skip == 0 or apply_final_norm:
        x = _rms(params["final_ln"], x, cfg.eps)
    return x.float()


def load_llama_hf(state: Mapping, cfg: LlamaConfig, *, device="cuda",
                  dtype=torch.bfloat16) -> Dict[str, Any]:
    """HF ``LlamaModel`` names -> the JAX layout, each tensor read to
    ``device`` at ``dtype`` (bare, ``model.``- or
    ``language_model.model.``-prefixed names)."""
    names = {k.removeprefix("language_model.").removeprefix("model."): k for k in state}
    get = lambda n: read_tensor(state, names[n], device, dtype)
    t = lambda n: get(n).t().contiguous()

    def block(i):
        b = f"layers.{i}"
        return {
            "ln_attn": get(f"{b}.input_layernorm.weight"),
            "q": t(f"{b}.self_attn.q_proj.weight"),
            "k": t(f"{b}.self_attn.k_proj.weight"),
            "v": t(f"{b}.self_attn.v_proj.weight"),
            "o": t(f"{b}.self_attn.o_proj.weight"),
            "ln_mlp": get(f"{b}.post_attention_layernorm.weight"),
            "gate": t(f"{b}.mlp.gate_proj.weight"),
            "up": t(f"{b}.mlp.up_proj.weight"),
            "down": t(f"{b}.mlp.down_proj.weight"),
        }

    return {"token_emb": get("embed_tokens.weight"), "blocks": stack_blocks(cfg.n_layers, block),
            "final_ln": get("norm.weight")}


def llama_layers_in(state: Mapping) -> int:
    """The number of decoder layers a (possibly depth-cut) state dict holds."""
    n = -1
    for k in state:
        parts = k.removeprefix("language_model.").removeprefix("model.").split(".")
        if parts[0] == "layers":
            n = max(n, int(parts[1]))
    return n + 1

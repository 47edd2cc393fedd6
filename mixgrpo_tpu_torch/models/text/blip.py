"""BLIP (ViT + BERT with cross-attention) for the ImageReward model.

Port of mixgrpo_tpu/models/text/blip.py in plain PyTorch, with the original
BLIP checkpoint naming.  The parameters keep the JAX layout ((in, out)
weights, the patch embedding as a linear over (dy, dx, c)-ordered patches,
blocks stacked along a leading depth axis).

Structure:
  - ViT: patch embedding (16), class token, learned positional embedding,
    pre-LN blocks (fused qkv with bias, exact GELU), final LN, eps 1e-6; all
    tokens are returned (the cross-attention keys and values).
  - BERT: word + position embeddings with post-LN; each layer is
    self-attention -> cross-attention (keys and values projected from the
    1024-wide image tokens) -> GELU MLP, all post-LN residual blocks, eps
    1e-12; the CLS row is pooled downstream.

Attention is JAX's own einsum (``blip.py:81-100``), computed eagerly here the
same way: logits in f32 scaled by 1/sqrt(head_dim), padded keys filled with
``finfo(f32).min``, an f32 softmax cast to the value dtype for the second
product.  No hand-written kernel is launched.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from mixgrpo_tpu_torch.models.text.clip_load import _Reader
from mixgrpo_tpu_torch.utils.safetensors_io import stack_blocks


@dataclasses.dataclass(frozen=True)
class BlipVisionConfig:
    width: int = 1024
    layers: int = 24
    heads: int = 16
    patch: int = 16
    image_size: int = 224
    mlp_ratio: float = 4.0
    eps: float = 1e-6

    @classmethod
    def vit_large(cls) -> "BlipVisionConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "BlipVisionConfig":
        return cls(width=32, layers=2, heads=2, patch=8, image_size=32)


@dataclasses.dataclass(frozen=True)
class BlipTextConfig:
    vocab: int = 30524
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    max_position: int = 512
    encoder_width: int = 1024  # cross-attention KV input dim
    eps: float = 1e-12

    @classmethod
    def base(cls) -> "BlipTextConfig":
        return cls()

    @classmethod
    def tiny(cls, encoder_width=32) -> "BlipTextConfig":
        return cls(vocab=64, hidden=32, layers=2, heads=2, intermediate=64,
                   max_position=32, encoder_width=encoder_width)

    @classmethod
    def from_med_config(cls, med: Mapping[str, Any]) -> "BlipTextConfig":
        """The BERT geometry of a BLIP ``med_config.json`` (HF BERT keys)."""
        d = cls()
        return cls(vocab=med.get("vocab_size", d.vocab), hidden=med.get("hidden_size", d.hidden),
                   layers=med.get("num_hidden_layers", d.layers),
                   heads=med.get("num_attention_heads", d.heads),
                   intermediate=med.get("intermediate_size", d.intermediate),
                   max_position=med.get("max_position_embeddings", d.max_position),
                   encoder_width=med.get("encoder_width", d.encoder_width),
                   eps=med.get("layer_norm_eps", d.eps))


def _ln(p, x, eps):
    y = F.layer_norm(x.float(), x.shape[-1:], eps=eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def _lin(p, x, dtype):
    y = x.to(dtype) @ p["w"].to(dtype)
    return y + p["b"].to(dtype) if "b" in p else y


def _attn(q, k, v, heads, mask=None):
    b, sq, _ = q.shape
    sk = k.shape[1]
    hd = q.shape[-1] // heads
    qh = q.reshape(b, sq, heads, hd).transpose(1, 2)
    kh = k.reshape(b, sk, heads, -1).transpose(1, 2)
    vh = v.reshape(b, sk, heads, -1).transpose(1, 2)
    logits = (qh.float() @ kh.float().transpose(-1, -2)) * (hd ** -0.5)
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None, None, :], torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(vh.dtype)
    o = probs @ vh
    return o.to(q.dtype).transpose(1, 2).reshape(b, sq, -1)


def _block(blocks, i):
    return {k: {n: t[i] for n, t in v.items()} for k, v in blocks.items()}


# ---------------------------------------------------------------------------
# ViT
# ---------------------------------------------------------------------------


def _lnp(d, lead, kw):
    return {"scale": torch.ones((*lead, d), **kw), "bias": torch.zeros((*lead, d), **kw)}


def init_blip_vision(cfg: BlipVisionConfig, *, generator: Optional[torch.Generator] = None,
                     device="cuda", dtype=torch.float32) -> Dict[str, Any]:
    """Random ViT weights in the JAX layout (values differ from JAX's)."""
    kw = dict(device=device, dtype=dtype)
    n, w, mh, L = (cfg.image_size // cfg.patch) ** 2, cfg.width, int(cfg.width * cfg.mlp_ratio), \
        cfg.layers
    randn = lambda shape, std: torch.empty(shape, **kw).normal_(0.0, std, generator=generator)
    lin = lambda i, o, lead=(): {"w": randn((*lead, i, o), i ** -0.5),
                                 "b": torch.zeros((*lead, o), **kw)}
    return {
        "patch_embed": lin(cfg.patch * cfg.patch * 3, w),
        "cls_token": randn((w,), 0.02),
        "pos_embed": randn((n + 1, w), 0.02),
        "blocks": {"norm1": _lnp(w, (L,), kw), "qkv": lin(w, 3 * w, (L,)),
                   "proj": lin(w, w, (L,)), "norm2": _lnp(w, (L,), kw),
                   "fc1": lin(w, mh, (L,)), "fc2": lin(mh, w, (L,))},
        "norm": _lnp(w, (), kw),
    }


@torch.no_grad()
def blip_vision_encode(params, cfg: BlipVisionConfig, images, *, dtype=torch.float32
                       ) -> torch.Tensor:
    """images: (B, H, W, 3) normalized -> (B, 1 + n, width) f32, all tokens."""
    b, H, W, _ = images.shape
    p = cfg.patch
    x = images.reshape(b, H // p, p, W // p, p, 3).permute(0, 1, 3, 2, 4, 5)
    x = _lin(params["patch_embed"], x.reshape(b, (H // p) * (W // p), p * p * 3), dtype)
    cls = params["cls_token"].to(dtype).expand(b, 1, cfg.width)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"].to(dtype)
    for i in range(params["blocks"]["qkv"]["w"].shape[0]):
        bp = _block(params["blocks"], i)
        h = _ln(bp["norm1"], x, cfg.eps)
        q, k, v = _lin(bp["qkv"], h, dtype).chunk(3, dim=-1)
        x = x + _lin(bp["proj"], _attn(q, k, v, cfg.heads), dtype)
        h = _ln(bp["norm2"], x, cfg.eps)
        x = x + _lin(bp["fc2"], F.gelu(_lin(bp["fc1"], h, dtype)), dtype)
    return _ln(params["norm"], x, cfg.eps).float()


# ---------------------------------------------------------------------------
# BERT with cross-attention (BLIP "med")
# ---------------------------------------------------------------------------


def init_blip_text(cfg: BlipTextConfig, *, generator: Optional[torch.Generator] = None,
                   device="cuda", dtype=torch.float32) -> Dict[str, Any]:
    """Random BERT weights in the JAX layout (values differ from JAX's)."""
    kw = dict(device=device, dtype=dtype)
    h, inter, ew, L = cfg.hidden, cfg.intermediate, cfg.encoder_width, cfg.layers
    randn = lambda shape: torch.empty(shape, **kw).normal_(0.0, 0.02, generator=generator)
    lin = lambda i, o: {"w": randn((L, i, o)), "b": torch.zeros((L, o), **kw)}
    return {
        "word_emb": randn((cfg.vocab, h)),
        "pos_emb": randn((cfg.max_position, h)),
        "emb_ln": _lnp(h, (), kw),
        "blocks": {"sa_q": lin(h, h), "sa_k": lin(h, h), "sa_v": lin(h, h),
                   "sa_out": lin(h, h), "sa_ln": _lnp(h, (L,), kw),
                   "ca_q": lin(h, h), "ca_k": lin(ew, h), "ca_v": lin(ew, h),
                   "ca_out": lin(h, h), "ca_ln": _lnp(h, (L,), kw),
                   "ff_in": lin(h, inter), "ff_out": lin(inter, h), "ff_ln": _lnp(h, (L,), kw)},
    }


@torch.no_grad()
def blip_text_encode(params, cfg: BlipTextConfig, token_ids, attention_mask, image_embeds,
                     *, dtype=torch.float32) -> torch.Tensor:
    """Multimodal forward -> (B, S, hidden) f32; the CLS row is pooled
    downstream."""
    dev = params["word_emb"].device
    ids = torch.as_tensor(token_ids, device=dev).long()
    mask = torch.as_tensor(attention_mask, device=dev).bool()
    S = ids.shape[1]
    x = params["word_emb"].to(dtype)[ids] + params["pos_emb"].to(dtype)[:S]
    x = _ln(params["emb_ln"], x, cfg.eps)
    img = image_embeds.to(dtype)
    for i in range(params["blocks"]["sa_q"]["w"].shape[0]):
        bp = _block(params["blocks"], i)
        # self-attention (post-LN residual)
        q, k, v = (_lin(bp[n], x, dtype) for n in ("sa_q", "sa_k", "sa_v"))
        x = _ln(bp["sa_ln"], x + _lin(bp["sa_out"], _attn(q, k, v, cfg.heads, mask), dtype),
                cfg.eps)
        # cross-attention to the image tokens
        q = _lin(bp["ca_q"], x, dtype)
        k, v = _lin(bp["ca_k"], img, dtype), _lin(bp["ca_v"], img, dtype)
        x = _ln(bp["ca_ln"], x + _lin(bp["ca_out"], _attn(q, k, v, cfg.heads), dtype), cfg.eps)
        # feed-forward
        f = _lin(bp["ff_out"], F.gelu(_lin(bp["ff_in"], x, dtype)), dtype)
        x = _ln(bp["ff_ln"], x + f, cfg.eps)
    return x.float()


# ---------------------------------------------------------------------------
# weight loading (original BLIP / ImageReward checkpoint naming)
# ---------------------------------------------------------------------------


def load_blip_vision(st: Mapping, cfg: BlipVisionConfig, prefix="", *, device="cuda",
                     dtype=torch.float32) -> Dict[str, Any]:
    """``visual_encoder.*`` (timm ViT names) onto the JAX layout."""
    r = _Reader(st, device, dtype)
    conv = r(prefix + "patch_embed.proj.weight")  # (w, 3, p, p) -> (p*p*3, w), (dy, dx, c)
    patch_w = conv.permute(2, 3, 1, 0).reshape(-1, conv.shape[0]).contiguous()

    def block(i):
        b = f"{prefix}blocks.{i}"
        return {"norm1": r.ln(f"{b}.norm1"), "qkv": r.lin(f"{b}.attn.qkv"),
                "proj": r.lin(f"{b}.attn.proj"), "norm2": r.ln(f"{b}.norm2"),
                "fc1": r.lin(f"{b}.mlp.fc1"), "fc2": r.lin(f"{b}.mlp.fc2")}

    return {
        "patch_embed": {"w": patch_w, "b": r(prefix + "patch_embed.proj.bias")},
        "cls_token": r(prefix + "cls_token").reshape(-1),
        "pos_embed": r(prefix + "pos_embed").reshape(-1, cfg.width),
        "blocks": stack_blocks(cfg.layers, block),
        "norm": r.ln(prefix + "norm"),
    }


def load_blip_text(st: Mapping, cfg: BlipTextConfig, prefix="", *, device="cuda",
                   dtype=torch.float32) -> Dict[str, Any]:
    """``text_encoder.*`` (BLIP med BERT names) onto the JAX layout."""
    r = _Reader(st, device, dtype)

    def block(i):
        b = f"{prefix}encoder.layer.{i}"
        return {
            "sa_q": r.lin(f"{b}.attention.self.query"),
            "sa_k": r.lin(f"{b}.attention.self.key"),
            "sa_v": r.lin(f"{b}.attention.self.value"),
            "sa_out": r.lin(f"{b}.attention.output.dense"),
            "sa_ln": r.ln(f"{b}.attention.output.LayerNorm"),
            "ca_q": r.lin(f"{b}.crossattention.self.query"),
            "ca_k": r.lin(f"{b}.crossattention.self.key"),
            "ca_v": r.lin(f"{b}.crossattention.self.value"),
            "ca_out": r.lin(f"{b}.crossattention.output.dense"),
            "ca_ln": r.ln(f"{b}.crossattention.output.LayerNorm"),
            "ff_in": r.lin(f"{b}.intermediate.dense"),
            "ff_out": r.lin(f"{b}.output.dense"),
            "ff_ln": r.ln(f"{b}.output.LayerNorm"),
        }

    return {
        "word_emb": r(prefix + "embeddings.word_embeddings.weight"),
        "pos_emb": r(prefix + "embeddings.position_embeddings.weight"),
        "emb_ln": r.ln(prefix + "embeddings.LayerNorm"),
        "blocks": stack_blocks(cfg.layers, block),
    }

"""Generic CLIP (vision and text towers) in plain PyTorch.

Port of mixgrpo_tpu/models/text/clip.py: one implementation for the reward
models' CLIP towers (HPSv2.1 / PickScore / CLIP-score ViT-H-14) and for the
CLIP-L text encoder that gives FLUX its pooled embedding.  A ViT with a class
token and learned positional embeddings, pre/post LayerNorm, GELU or
quick-GELU MLPs; a causal text transformer whose features are taken at the
argmax token id (the end-of-text token); both projected to a shared space.
LayerNorm statistics in f32; the parameters keep the JAX layout ((in, out)
weights, HWIO patch kernel, blocks stacked along a leading depth axis).

Attention is the port's ``"eager"`` path: the text tower is causal, which the
flash kernel (key-side masks only) does not take, and JAX too runs it with
``impl="xla"``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from mixgrpo_tpu_torch.models.flux import layers as L
from mixgrpo_tpu_torch.ops.attention import attention


@dataclasses.dataclass(frozen=True)
class CLIPTowerConfig:
    width: int
    layers: int
    heads: int
    # vision-only
    patch: int = 14
    image_size: int = 224
    # text-only
    vocab: int = 49408
    context: int = 77

    @property
    def head_dim(self) -> int:
        return self.width // self.heads


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int
    vision: CLIPTowerConfig
    text: CLIPTowerConfig
    quick_gelu: bool = False
    eps: float = 1e-5

    @classmethod
    def vit_h_14(cls, image_size: int = 224) -> "CLIPConfig":
        """laion/DFN/HPS ViT-H-14 geometry."""
        return cls(
            embed_dim=1024,
            vision=CLIPTowerConfig(width=1280, layers=32, heads=16, patch=14,
                                   image_size=image_size),
            text=CLIPTowerConfig(width=1024, layers=24, heads=16),
        )

    @classmethod
    def vit_l_14(cls) -> "CLIPConfig":
        """OpenAI CLIP-L (the FLUX pooled-text encoder geometry)."""
        return cls(
            embed_dim=768,
            vision=CLIPTowerConfig(width=1024, layers=24, heads=16, patch=14),
            text=CLIPTowerConfig(width=768, layers=12, heads=12),
            quick_gelu=True,
        )

    @classmethod
    def tiny(cls) -> "CLIPConfig":
        return cls(
            embed_dim=16,
            vision=CLIPTowerConfig(width=32, layers=2, heads=2, patch=8, image_size=32),
            text=CLIPTowerConfig(width=32, layers=2, heads=2, vocab=64, context=16),
        )


def _ln_init(d, lead, kw):
    return {"scale": torch.ones((*lead, d), **kw), "bias": torch.zeros((*lead, d), **kw)}


def _ln(p, x, eps):
    xf = x.float()
    y = F.layer_norm(xf, xf.shape[-1:], eps=eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def _blocks_init(gen, width, n, kw):
    lin = lambda i, o: L.linear_init(gen, i, o, lead=(n,), **kw)
    return {
        "ln1": _ln_init(width, (n,), kw),
        "qkv": lin(width, 3 * width),
        "out": lin(width, width),
        "ln2": _ln_init(width, (n,), kw),
        "fc1": lin(width, 4 * width),
        "fc2": lin(4 * width, width),
    }


def _act(x, quick: bool):
    if quick:
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x)


def _block(p, x, heads, causal, cfg: CLIPConfig, dtype):
    b, s, w = x.shape
    h = _ln(p["ln1"], x, cfg.eps)
    q, k, v = L.linear(p["qkv"], h, dtype).chunk(3, dim=-1)
    sh = lambda t: t.reshape(b, s, heads, -1).transpose(1, 2)
    mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril() if causal else None
    o = attention(sh(q), sh(k), sh(v), mask=mask, impl="eager")
    x = x + L.linear(p["out"], o.transpose(1, 2).reshape(b, s, w), dtype)
    h = _ln(p["ln2"], x, cfg.eps)
    return x + L.linear(p["fc2"], _act(L.linear(p["fc1"], h, dtype), cfg.quick_gelu), dtype)


def _tower(blocks, x, heads, causal, cfg, dtype):
    for i in range(blocks["qkv"]["w"].shape[0]):
        bp = {k: {n: t[i] for n, t in v.items()} for k, v in blocks.items()}
        x = _block(bp, x, heads, causal, cfg, dtype)
    return x


def init_clip(cfg: CLIPConfig, *, generator: Optional[torch.Generator] = None, device="cuda",
              dtype=torch.float32) -> Dict[str, Any]:
    """Random CLIP weights in the JAX layout (values differ from JAX's)."""
    v, t = cfg.vision, cfg.text
    kw = dict(device=device, dtype=dtype)
    g = generator
    randn = lambda shape, std: torch.empty(shape, **kw).normal_(0.0, std, generator=g)
    n_patches = (v.image_size // v.patch) ** 2
    vision = {
        "patch_embed": {"w": randn((v.patch, v.patch, 3, v.width), 0.02)},
        "class_emb": randn((v.width,), 0.02),
        "pos_emb": randn((n_patches + 1, v.width), 0.02),
        "ln_pre": _ln_init(v.width, (), kw),
        "blocks": _blocks_init(g, v.width, v.layers, kw),
        "ln_post": _ln_init(v.width, (), kw),
        "proj": randn((v.width, cfg.embed_dim), v.width ** -0.5),
    }
    text = {
        "token_emb": randn((t.vocab, t.width), 0.02),
        "pos_emb": randn((t.context, t.width), 0.01),
        "blocks": _blocks_init(g, t.width, t.layers, kw),
        "ln_final": _ln_init(t.width, (), kw),
        "proj": randn((t.width, cfg.embed_dim), t.width ** -0.5),
    }
    return {"vision": vision, "text": text,
            "logit_scale": torch.tensor(2.6592, **kw)}  # ln(1/0.07)


@torch.no_grad()
def clip_image_features(params, cfg: CLIPConfig, images, *, dtype=torch.float32,
                        normalize=True) -> torch.Tensor:
    """images: (B, H, W, 3), already resized and CLIP-normalized -> (B, embed) f32."""
    v = cfg.vision
    p = params["vision"]
    w = p["patch_embed"]["w"].to(dtype).permute(3, 2, 0, 1)  # HWIO -> OIHW
    x = F.conv2d(images.to(dtype).permute(0, 3, 1, 2), w, stride=v.patch)
    b = x.shape[0]
    x = x.permute(0, 2, 3, 1).reshape(b, -1, v.width)
    cls = p["class_emb"].to(dtype).expand(b, 1, v.width)
    x = torch.cat([cls, x], dim=1) + p["pos_emb"].to(dtype)
    x = _ln(p["ln_pre"], x, cfg.eps)
    x = _tower(p["blocks"], x, v.heads, False, cfg, dtype)
    feats = _ln(p["ln_post"], x[:, 0], cfg.eps) @ p["proj"].to(dtype)
    if normalize:
        feats = feats / feats.norm(dim=-1, keepdim=True)
    return feats.float()


@torch.no_grad()
def clip_text_features(params, cfg: CLIPConfig, token_ids, *, dtype=torch.float32,
                       normalize=True, project=True) -> torch.Tensor:
    """token_ids: (B, context) int; the end-of-text position is the argmax id.

    ``project=False`` returns the final-LN hidden state there (the HF
    ``pooler_output`` that FLUX uses as its pooled conditioning) instead of
    the projected embedding."""
    t = cfg.text
    p = params["text"]
    token_ids = torch.as_tensor(token_ids, device=p["token_emb"].device).long()
    x = p["token_emb"].to(dtype)[token_ids] + p["pos_emb"].to(dtype)
    x = _tower(p["blocks"], x, t.heads, True, cfg, dtype)
    x = _ln(p["ln_final"], x, cfg.eps)
    pooled = x[torch.arange(x.shape[0], device=x.device), token_ids.argmax(dim=-1)]
    if not project:
        return pooled.float()
    feats = pooled @ p["proj"].to(dtype)
    if normalize:
        feats = feats / feats.norm(dim=-1, keepdim=True)
    return feats.float()

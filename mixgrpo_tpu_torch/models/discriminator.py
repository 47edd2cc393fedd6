"""Latent-feature GAN discriminator (the distillation stack).

Port of mixgrpo_tpu/models/discriminator.py (the reference's
fastvideo/distill/discriminator.py): one head per sampled DiT layer (every
``stride``-th of ``total_layers``), each head conv1x1 -> GroupNorm ->
LeakyReLU, a residual second conv, and conv_out to 1 channel.  Features
arrive as (B, T*H*W, C) token grids, so the 1x1 convs are per-token (in,
out) linears, and each location is scored.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
    stride: int = 8
    num_h_per_head: int = 1
    adapter_channels: tuple = (3072,)
    total_layers: int = 48
    inner_channels: int = 1024
    groups: int = 32

    @property
    def head_channels(self) -> tuple:
        return tuple(self.adapter_channels) * (self.total_layers // self.stride)


def _head_init(gen, cin, inner, kw, cout=1):
    lin = lambda i, o: {"w": torch.empty((i, o), **kw).normal_(0.0, i**-0.5, generator=gen),
                        "b": torch.zeros((o,), **kw)}
    gn = lambda: {"scale": torch.ones((inner,), **kw), "bias": torch.zeros((inner,), **kw)}
    return {"conv1": lin(cin, inner), "gn1": gn(), "conv2": lin(inner, inner), "gn2": gn(),
            "out": lin(inner, cout)}


def init_discriminator(cfg: DiscriminatorConfig, *, generator: Optional[torch.Generator] = None,
                       device="cuda", dtype=torch.float32) -> Dict[str, Any]:
    """Random heads in the JAX layout (a list of ``num_h_per_head`` heads per
    sampled layer), at ``dtype`` on ``device``."""
    kw = dict(device=device, dtype=dtype)
    return {"heads": [[_head_init(generator, c, cfg.inner_channels, kw)
                       for _ in range(cfg.num_h_per_head)] for c in cfg.head_channels]}


def _gn(p, x, groups):
    """GroupNorm over (tokens, C/g) in f32, eps 1e-5, cast back."""
    b, n, c = x.shape
    xf = x.float().reshape(b, n, groups, c // groups)
    mu = xf.mean(dim=(1, 3), keepdim=True)
    var = xf.var(dim=(1, 3), unbiased=False, keepdim=True)
    xf = ((xf - mu) * torch.rsqrt(var + 1e-5)).reshape(b, n, c)
    return (xf * p["scale"].float() + p["bias"].float()).to(x.dtype)


def _head(p, x, groups):
    """x: (B, N, C) token features -> (B, N, 1) logits."""
    lin = lambda pp, z: z @ pp["w"].to(z.dtype) + pp["b"].to(z.dtype)
    h = F.leaky_relu(_gn(p["gn1"], lin(p["conv1"], x), groups))
    h2 = F.leaky_relu(_gn(p["gn2"], lin(p["conv2"], h), groups))
    return lin(p["out"], h2 + h)


def discriminator_forward(params, cfg: DiscriminatorConfig,
                          features: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """features: one (B, N, C) tensor per sampled layer -> per-token logits,
    one tensor per head."""
    if len(features) != len(params["heads"]):
        raise ValueError(f"{len(features)} feature maps for {len(params['heads'])} heads")
    return [_head(hp, feats, cfg.groups)
            for feats, group in zip(features, params["heads"]) for hp in group]

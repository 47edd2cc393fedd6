"""FLUX latent packing helpers.

Port of mixgrpo_tpu/models/flux/latents.py: the 16-channel VAE latent grid
(channel-last, (B, H, W, C)) packs into 2x2 patches of 64-channel tokens with
features in (channel, dy, dx) order, and unpacks back for VAE decoding.
"""

from __future__ import annotations

import torch

VAE_SCALE_FACTOR = 8  # spatial downsample of the FLUX AutoencoderKL
VAE_SCALING = 0.3611
VAE_SHIFT = 0.1159


def pack_latents(latents: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) latent grid -> (B, H/2*W/2, 4C) packed tokens."""
    b, h, w, c = latents.shape
    x = latents.reshape(b, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 5, 2, 4)  # (B, h/2, w/2, C, 2, 2)
    return x.reshape(b, (h // 2) * (w // 2), c * 4)


def unpack_latents(tokens: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, L, 4C) packed tokens -> (B, H, W, C) latent grid; ``height`` and
    ``width`` are image pixel dims."""
    b, n, ch = tokens.shape
    h = 2 * (height // (VAE_SCALE_FACTOR * 2))
    w = 2 * (width // (VAE_SCALE_FACTOR * 2))
    c = ch // 4
    x = tokens.reshape(b, h // 2, w // 2, c, 2, 2)
    x = x.permute(0, 1, 4, 2, 5, 3)  # (B, h/2, 2, w/2, 2, C)
    return x.reshape(b, h, w, c)


def denormalize_latents(latents: torch.Tensor) -> torch.Tensor:
    """Undo the FLUX VAE latent normalization before decoding."""
    return latents / VAE_SCALING + VAE_SHIFT

"""Mochi latent normalization (per-channel statistics).

Port of mixgrpo_tpu/models/mochi/latents.py (the reference's
mochi_latents_utils.py ``normalize_dit_input``): Mochi's VAE latents are
standardized channel-wise with the published mean and std before they
enter the DiT.  The statistics are the port's own copy of JAX's.
"""

from __future__ import annotations

import numpy as np
import torch

MOCHI_LATENTS_MEAN = np.array([
    -0.06730895953510081, -0.038011381506090416, -0.07477820912866141,
    -0.05565264470995561, 0.012767231469026969, -0.04703542746246419,
    0.043896967884726704, -0.09346305707025976, -0.09918314763016893,
    -0.008729793427399178, -0.011931556316503654, -0.0321993391887285,
], dtype=np.float32)

MOCHI_LATENTS_STD = np.array([
    0.9263795028493863, 0.9248894543193766, 0.9393059390890617,
    0.959253732819592, 0.8244560132752793, 0.917259975397747,
    0.9294154431013696, 1.3720942357788521, 0.881393668867029,
    0.9168315692124348, 0.9185249279345552, 0.9274757570805041,
], dtype=np.float32)


def _stats(latents: torch.Tensor):
    kw = dict(dtype=latents.dtype, device=latents.device)
    return torch.as_tensor(MOCHI_LATENTS_MEAN, **kw), torch.as_tensor(MOCHI_LATENTS_STD, **kw)


def normalize_dit_input(latents: torch.Tensor) -> torch.Tensor:
    """(..., C=12) channel-last latents -> standardized."""
    mean, std = _stats(latents)
    return (latents - mean) / std


def denormalize_dit_output(latents: torch.Tensor) -> torch.Tensor:
    mean, std = _stats(latents)
    return latents * std + mean

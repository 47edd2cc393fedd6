"""Batched CLIP image preprocessing on the device the images are on.

Port of mixgrpo_tpu/rewards/preprocess.py: resize so the shorter side equals
``size`` (bicubic), centre crop, clip to [0, 1], normalize with the OpenAI
CLIP statistics.

JAX resizes with ``jax.image.resize(method="cubic")``, which antialiases
when it shrinks (a Keys cubic, a = -0.5, widened by the scale factor, with
the weights renormalized at the edges).  ``F.interpolate(mode="bicubic",
antialias=True, align_corners=False)`` computes the same weights; torch's
default ``antialias=False`` does not (a = -0.75 and no widening: 0.74 max
abs difference at 720 -> 224), so ``resize`` always passes
``antialias=True``.  The resize runs in f32 whatever the input dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def as_image_batch(images, device) -> torch.Tensor:
    """(B, H, W, 3) images in [0, 1] (a tensor on any device, or numpy) as an
    f32 tensor on ``device``; a tensor already there is not copied."""
    x = torch.as_tensor(images)
    return x.to(device=device, dtype=torch.float32)


def resize(images: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, h, w, C) f32, bicubic with antialiasing (the
    weights of ``jax.image.resize(method="cubic")``)."""
    x = images.float().permute(0, 3, 1, 2)
    if x.shape[-2:] != (h, w):
        x = F.interpolate(x, size=(h, w), mode="bicubic", antialias=True,
                          align_corners=False)
    return x.permute(0, 2, 3, 1)


def normalize(x: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(CLIP_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=x.dtype, device=x.device)
    return (x.clamp(0.0, 1.0) - mean) / std


def clip_preprocess(images: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W, 3) float in [0, 1] -> (B, size, size, 3) normalized f32."""
    b, h, w, c = images.shape
    if h <= w:
        nh, nw = size, max(int(round(w * size / h)), size)
    else:
        nh, nw = max(int(round(h * size / w)), size), size
    x = resize(images, nh, nw)
    top = (nh - size) // 2
    left = (nw - size) // 2
    return normalize(x[:, top:top + size, left:left + size])

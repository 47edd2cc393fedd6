"""Rollout driver: FLUX + mixed ODE-SDE sampler.

Port of mixgrpo_tpu/sampler.py.  The whole generation group is batched into
one rollout; the sigma schedule, the ODE/SDE mask and the step count are
arguments.  Timestep quantization is kept: the DiT is fed
``int(sigma*1000)/1000``, sigma floored to 1e-3.
``chunked_rollout`` belongs to training and waits for that slice.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from mixgrpo_tpu_torch.models.flux.model import FluxConfig, flux_forward
from mixgrpo_tpu_torch.models.flux.rope import make_image_ids, make_text_ids, rope_tables
from mixgrpo_tpu_torch.solvers.rollout import RolloutOutput, SamplerConfig, run_rollout


def quantized_timestep(sigma):
    """int(sigma * 1000) / 1000 — reference timestep quantization."""
    return torch.floor(sigma * 1000.0) / 1000.0


def make_model_fn(
    params,
    flux_cfg: FluxConfig,
    txt,
    pooled,
    guidance_scale: float,
    rope_cos,
    rope_sin,
    *,
    dtype=torch.bfloat16,
    attn_impl: str = "auto",
):
    """Close FLUX over conditioning -> ``(z, sigma) -> velocity``."""

    def model_fn(z, sigma):
        B = z.shape[0]
        sigma = torch.as_tensor(sigma, dtype=torch.float32, device=z.device)
        t = quantized_timestep(sigma).expand(B)
        g = torch.full((B,), guidance_scale, dtype=torch.float32, device=z.device)
        return flux_forward(
            params, flux_cfg, z.to(dtype), txt, pooled, t, g,
            rope_cos, rope_sin, dtype=dtype, attn_impl=attn_impl,
        )

    return model_fn


class FluxSampler:
    """Holds the RoPE tables of one resolution and runs group rollouts."""

    def __init__(
        self,
        flux_cfg: FluxConfig,
        sampler_cfg: SamplerConfig,
        *,
        height: int,
        width: int,
        text_len: int = 512,
        guidance_scale: float = 3.5,
        dtype=torch.bfloat16,
        attn_impl: str = "auto",
        device="cuda",
    ):
        self.flux_cfg = flux_cfg
        self.sampler_cfg = sampler_cfg
        self.height, self.width = height, width
        self.latent_h, self.latent_w = height // 8, width // 8
        self.guidance_scale = guidance_scale
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.device = torch.device(device)
        ids = np.concatenate(
            [make_text_ids(text_len), make_image_ids(self.latent_h, self.latent_w)]
        )
        self.rope_cos, self.rope_sin = rope_tables(
            ids, flux_cfg.axes_dims, flux_cfg.theta, device=self.device
        )

    @property
    def num_image_tokens(self) -> int:
        return (self.latent_h // 2) * (self.latent_w // 2)

    def init_noise(self, generator: Optional[torch.Generator], batch: int,
                   same_noise_groups: Optional[int] = None):
        """Packed-latent gaussian init, (batch, S_img, C) f32.  With
        ``same_noise_groups=G`` each group of G generations shares one draw
        (fresh across groups, as in JAX)."""
        c = self.flux_cfg.in_channels
        n = batch // same_noise_groups if same_noise_groups else batch
        z = torch.randn((n, 1, self.num_image_tokens, c), generator=generator,
                        device=self.device, dtype=torch.float32)
        if same_noise_groups:
            z = z.expand(n, same_noise_groups, self.num_image_tokens, c)
        return z.reshape(batch, self.num_image_tokens, c)

    def rollout(
        self, params, z0, txt, pooled, sigmas, deterministic, num_steps,
        generator: Optional[torch.Generator] = None,
        noise_fn: Optional[Callable] = None,
    ) -> RolloutOutput:
        """Run the group rollout (no grad)."""
        model_fn = make_model_fn(
            params, self.flux_cfg, txt, pooled, self.guidance_scale,
            self.rope_cos, self.rope_sin, dtype=self.dtype,
            attn_impl=self.attn_impl,
        )
        return run_rollout(
            self.sampler_cfg, model_fn, z0,
            sigmas=sigmas, deterministic=deterministic,
            num_steps=num_steps, generator=generator, noise_fn=noise_fn,
        )

"""Rollout driver: FLUX + mixed ODE-SDE sampler.

Port of mixgrpo_tpu/sampler.py.  The whole generation group is batched into
one rollout; the sigma schedule, the ODE/SDE mask and the step count are
arguments.  Timestep quantization is kept: the DiT is fed
``int(sigma*1000)/1000``, sigma floored to 1e-3.  ``chunked_rollout`` runs
the training group as several rollouts of ``chunk`` rows, in row order;
each chunk draws its SDE noise from its own generator (JAX folds the chunk
index into its key).  On a mesh the tensors are each rank's own rows, so
``chunk`` counts images per batch shard, as JAX's ``chunk`` does, and each
rank's generators are its own (``train.GRPOTrainer._generator``); ``tp``
(a mesh) runs the blocks on this rank's tensor-parallel slices
(``flux_forward``'s ``tp``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

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
    remat=True,
    virtual_depth=None,
    tp=None,
):
    """Close FLUX over conditioning -> ``(z, sigma) -> velocity``.
    ``remat``: recompute each block in the backward when the call is
    differentiated (``flux_forward``'s; no effect under ``torch.no_grad``)."""

    def model_fn(z, sigma):
        B = z.shape[0]
        sigma = torch.as_tensor(sigma, dtype=torch.float32, device=z.device)
        t = quantized_timestep(sigma).expand(B)
        g = torch.full((B,), guidance_scale, dtype=torch.float32, device=z.device)
        return flux_forward(
            params, flux_cfg, z.to(dtype), txt, pooled, t, g,
            rope_cos, rope_sin, dtype=dtype, attn_impl=attn_impl, remat=remat,
            virtual_depth=virtual_depth, tp=tp,
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
        virtual_depth=None,  # benchmark aid: see flux_forward's docstring
        device="cuda",
    ):
        self.flux_cfg = flux_cfg
        self.sampler_cfg = sampler_cfg
        self.virtual_depth = virtual_depth
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
        noise_fn: Optional[Callable] = None, tp=None,
    ) -> RolloutOutput:
        """Run the group rollout (no grad)."""
        model_fn = make_model_fn(
            params, self.flux_cfg, txt, pooled, self.guidance_scale,
            self.rope_cos, self.rope_sin, dtype=self.dtype,
            attn_impl=self.attn_impl, virtual_depth=self.virtual_depth, tp=tp,
        )
        return run_rollout(
            self.sampler_cfg, model_fn, z0,
            sigmas=sigmas, deterministic=deterministic,
            num_steps=num_steps, generator=generator, noise_fn=noise_fn,
        )

    def chunked_rollout(
        self, params, z0, txt, pooled, sigmas, deterministic, num_steps,
        generators: Optional[Sequence[torch.Generator]] = None,
        *, chunk: Optional[int] = None, noise_fn: Optional[Callable] = None, tp=None,
    ) -> RolloutOutput:
        """Group rollout in chunks of ``chunk`` images, rows [j*chunk,
        (j+1)*chunk) in call j; the merged output keeps the input's row
        order.  One call for the whole group when ``chunk`` is unset or does
        not split it.

        Chunk j draws its SDE noise from ``generators[j]`` (one per chunk;
        None draws from torch's default generator), or from
        ``noise_fn(j, i, shape)`` for step i; in the single-call case j is
        None."""
        B = z0.shape[0]
        if not chunk or chunk <= 0 or B <= chunk or B % chunk:
            fn = None if noise_fn is None else (lambda i, shape: noise_fn(None, i, shape))
            gen = generators[0] if generators else None
            return self.rollout(params, z0, txt, pooled, sigmas, deterministic, num_steps,
                                generator=gen, noise_fn=fn, tp=tp)
        nc = B // chunk
        if generators is not None and len(generators) != nc:
            raise ValueError(f"{len(generators)} generators for {nc} chunks")
        outs = []
        for j in range(nc):
            rows = slice(j * chunk, (j + 1) * chunk)
            fn = None if noise_fn is None else (lambda i, shape, j=j: noise_fn(j, i, shape))
            outs.append(self.rollout(
                params, z0[rows], txt[rows], pooled[rows], sigmas, deterministic, num_steps,
                generator=None if generators is None else generators[j], noise_fn=fn,
                tp=tp))
        return RolloutOutput(
            final_latents=torch.cat([o.final_latents for o in outs]),
            all_latents=torch.cat([o.all_latents for o in outs]),
            all_log_probs=torch.cat([o.all_log_probs for o in outs]),
            step_valid=outs[0].step_valid,
        )

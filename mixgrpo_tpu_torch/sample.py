"""Inference: mixed-model FLUX sampling (GRPO-tuned + base).

Port of mixgrpo_tpu/sample.py (``DualFluxPipeline``): the GRPO-tuned
transformer runs the first ``mix_sampling_steps`` of the trajectory and the
base transformer the rest, every step a deterministic ODE step (eta = 0);
the dynamic-shift schedule follows diffusers' FluxPipeline
(``calculate_shift``, then ``sigma' = e^mu / (e^mu + 1/sigma - 1)``).

Prompts enter as (txt, pooled) embeddings: ``main()``, the checkpoint
loaders and the T5/CLIP encoders wait for their slices, and ``quant="int8"``
waits for the port of ``ops/quant.py``.
"""

from __future__ import annotations

import json
import math
import os
from typing import Optional, Sequence

import numpy as np
import torch

from mixgrpo_tpu_torch.models.flux.latents import denormalize_latents, unpack_latents
from mixgrpo_tpu_torch.models.flux.model import FluxConfig
from mixgrpo_tpu_torch.models.flux.vae import (
    VAEConfig, postprocess_images, vae_decode, vae_decode_tiled,
)
from mixgrpo_tpu_torch.sampler import FluxSampler
from mixgrpo_tpu_torch.solvers.rollout import SamplerConfig


def calculate_shift(
    image_seq_len: int,
    base_seq_len: int = 256,
    max_seq_len: int = 4096,
    base_shift: float = 0.5,
    max_shift: float = 1.16,
) -> float:
    """FLUX dynamic schedule shift mu."""
    m = (max_shift - base_shift) / (max_seq_len - base_seq_len)
    b = base_shift - m * base_seq_len
    return image_seq_len * m + b


def dynamic_shift_sigmas(num_steps: int, mu: float) -> np.ndarray:
    """FlowMatchEuler dynamic shifting: sigma' = e^mu/(e^mu + 1/sigma - 1)."""
    sig = np.linspace(1.0, 1.0 / num_steps, num_steps, dtype=np.float64)
    shifted = math.exp(mu) / (math.exp(mu) + (1.0 / sig - 1.0))
    return np.concatenate([shifted, [0.0]]).astype(np.float32)


class DualFluxPipeline:
    """Base + fine-tuned FLUX with segment-wise model switching."""

    def __init__(
        self,
        flux_cfg: FluxConfig,
        base_params,
        tuned_params=None,
        *,
        vae_cfg: Optional[VAEConfig] = None,
        vae_params=None,
        height: int = 1024,
        width: int = 1024,
        num_steps: int = 50,
        mix_sampling_steps: int = 30,
        guidance_scale: float = 3.5,
        text_len: int = 512,
        dtype=torch.bfloat16,
        attn_impl: str = "auto",
        quant: str = "none",
        vae_tiling: str = "auto",  # auto | on | off
        max_steps_per_call: Optional[int] = None,
        device="cuda",
    ):
        if quant == "int8":
            raise NotImplementedError("quant='int8' waits for the port of ops/quant.py")
        if quant != "none":
            raise ValueError(f"unknown quant {quant!r}")
        if vae_tiling not in ("auto", "on", "off"):
            raise ValueError(f"unknown vae_tiling {vae_tiling!r}")
        self.flux_cfg = flux_cfg
        self.base_params = base_params
        self.tuned_params = tuned_params
        self.vae_cfg, self.vae_params = vae_cfg, vae_params
        self.num_steps = num_steps
        self.mix_k = min(mix_sampling_steps, num_steps) if tuned_params is not None else 0
        self.height, self.width = height, width
        self.dtype = dtype
        self.device = torch.device(device)

        image_seq_len = (height // 16) * (width // 16)
        self.sigmas = dynamic_shift_sigmas(num_steps, calculate_shift(image_seq_len))

        # max_steps_per_call splits a segment into chunks of at most that many
        # steps driven from the host (bounded duration of one device call);
        # None = one call per segment
        self._chunk = max_steps_per_call
        cap = lambda T: min(T, self._chunk) if self._chunk else T
        sampler = lambda T: FluxSampler(
            flux_cfg, SamplerConfig(num_steps_max=cap(T), eta=0.0),
            height=height, width=width, text_len=text_len,
            guidance_scale=guidance_scale, dtype=dtype, attn_impl=attn_impl,
            device=self.device,
        )
        self._seg1 = sampler(self.mix_k) if self.mix_k > 0 else None
        self._seg2 = sampler(num_steps - self.mix_k) if num_steps > self.mix_k else None
        # tiled decode above 768px, as the reference enables VAE tiling
        self._tile_decode = vae_tiling == "on" or (
            vae_tiling == "auto" and max(height, width) // 8 > 96
        )

    def _decode(self, latents_packed):
        lat = denormalize_latents(unpack_latents(latents_packed, self.height, self.width))
        decode = vae_decode_tiled if self._tile_decode else vae_decode
        return postprocess_images(decode(self.vae_params, self.vae_cfg, lat, dtype=self.dtype))

    @torch.no_grad()
    def __call__(self, txt, pooled, generator: Optional[torch.Generator] = None,
                 z0=None) -> torch.Tensor:
        """txt: (B, L, 4096), pooled: (B, 768) -> images in [0, 1] (B, H, W, 3),
        or the packed latents when the pipeline has no VAE.

        ``z0`` overrides the initial packed latent noise (B, S_img, C); the
        serving layer uses it to honour per-request seeds in a co-batch."""
        B = txt.shape[0]
        sampler = self._seg1 or self._seg2
        z = sampler.init_noise(generator, B) if z0 is None else z0
        k = self.mix_k
        if self._seg1 is not None:
            z = self._run_segment(self._seg1, self.tuned_params, z, txt, pooled,
                                  self.sigmas[: k + 1], generator)
        if self._seg2 is not None:
            z = self._run_segment(self._seg2, self.base_params, z, txt, pooled,
                                  self.sigmas[k:], generator)
        if self.vae_params is not None:
            return self._decode(z)
        return z

    def _run_segment(self, sampler, params, z, txt, pooled, sigmas_seg, generator):
        """Run a deterministic ODE segment as chunks of at most
        ``max_steps_per_call`` steps; a short final chunk pads its schedule
        to the fixed length and runs only its valid steps."""
        T = len(sigmas_seg) - 1
        C = sampler.sampler_cfg.num_steps_max
        for s0 in range(0, T, C):
            n = min(C, T - s0)
            sig = np.asarray(sigmas_seg[s0 : s0 + n + 1], np.float32)
            if len(sig) < C + 1:
                sig = np.concatenate([sig, np.full(C + 1 - len(sig), sig[-1], np.float32)])
            out = sampler.rollout(params, z, txt, pooled, sig, [True] * C, n, generator)
            z = out.final_latents
        return z


def save_outputs(
    images01, prompts: Sequence[str], output_dir: str, seeds: Sequence[int],
    process_index: int = 0,
):
    """PNG per prompt + metadata JSON."""
    from PIL import Image

    os.makedirs(output_dir, exist_ok=True)
    meta = []
    arr = images01.float().cpu().numpy() if torch.is_tensor(images01) else np.asarray(images01)
    for i, (img, prompt) in enumerate(zip(arr, prompts)):
        name = f"img_p{process_index}_{i:05d}.png"
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(output_dir, name)
        )
        meta.append({"image": name, "prompt": prompt, "seed": int(seeds[i])})
    with open(os.path.join(output_dir, f"metadata_{process_index}.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return meta

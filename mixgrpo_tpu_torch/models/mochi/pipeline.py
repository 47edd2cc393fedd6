"""Mochi text-to-video sampling pipeline (CFG over the linear-quadratic schedule).

Port of mixgrpo_tpu/models/mochi/pipeline.py (the reference's
pipeline_mochi.py): unlike guidance-distilled FLUX and HunyuanVideo, Mochi
applies real classifier-free guidance, two DiT calls per step and
``uncond + scale * (cond - uncond)`` (scale 4.5), over the linear-quadratic
sigma schedule (``solvers/distill.py``), with Euler flow-match steps on f32
latents.  The latents are de-standardized with the published per-channel
statistics (``latents.py``) and decoded, in tiles when the latent exceeds
17 frames or 32 pixels (``vae_tiling="auto"``, the reference's
``enable_vae_tiling``), then mapped from [-1, 1] to [0, 1].

Text enters as T5 features (B, L, 4096) with their mask, as in JAX; the
unconditional branch defaults to zero features with an all-ones mask.  The
initial noise is drawn from a ``torch.Generator`` (seed 0 unless given) on
the pipeline's device, or injected as ``z0`` (the parity tests pass JAX's
draw).  JAX traces the loop as one ``lax.fori_loop``; here it is a Python
loop over the steps.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mixgrpo_tpu_torch.models.mochi.latents import denormalize_dit_output
from mixgrpo_tpu_torch.models.mochi.model import MochiConfig, mochi_forward
from mixgrpo_tpu_torch.models.mochi.vae import (
    MochiVAEConfig, mochi_vae_decode, mochi_vae_decode_tiled,
)
from mixgrpo_tpu_torch.solvers.distill import linear_quadratic_schedule


class MochiPipeline:
    def __init__(
        self,
        cfg: MochiConfig,
        params,
        *,
        num_steps: int = 64,
        guidance_scale: float = 4.5,
        lq_threshold: float = 0.025,
        dtype=torch.bfloat16,
        attn_impl: str = "auto",
        vae_cfg: Optional[MochiVAEConfig] = None,
        vae_params=None,
        vae_tiling: str = "auto",  # auto | on | off
        device="cuda",
    ):
        if vae_tiling not in ("auto", "on", "off"):
            raise ValueError(f"unknown vae_tiling {vae_tiling!r}")
        self.vae_tiling = vae_tiling
        self.cfg, self.params = cfg, params
        self.vae_cfg, self.vae_params = vae_cfg, vae_params
        self.num_steps = num_steps
        self.guidance_scale = guidance_scale
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.device = torch.device(device)
        sig = linear_quadratic_schedule(num_steps, lq_threshold, num_steps // 2)
        self.sigmas = np.concatenate([sig, [0.0]]).astype(np.float32)

    @classmethod
    def from_checkpoint(cls, dit_path: str, vae_path: Optional[str] = None,
                        cfg: Optional[MochiConfig] = None,
                        vae_cfg: Optional[MochiVAEConfig] = None, *, device="cuda",
                        dtype=torch.bfloat16, **kw) -> "MochiPipeline":
        """A diffusers-layout transformer directory and, optionally, the VAE
        decoder (safetensors), read to ``device`` at ``dtype``; ``cfg``
        defaults to the one the transformer's tensors hold."""
        from mixgrpo_tpu_torch.models.mochi.load import infer_mochi_config, load_mochi_hf
        from mixgrpo_tpu_torch.models.mochi.vae import load_mochi_vae_decoder
        from mixgrpo_tpu_torch.utils.safetensors_io import SafetensorsDir

        st = SafetensorsDir(dit_path)
        cfg = cfg or infer_mochi_config(st)
        params = load_mochi_hf(st, cfg, device=device, dtype=dtype)
        vae_params = None
        if vae_path is not None:
            vae_cfg = vae_cfg or MochiVAEConfig.mochi_preview()
            vae_params = load_mochi_vae_decoder(vae_path, vae_cfg, device=device, dtype=dtype)
        return cls(cfg, params, vae_cfg=vae_cfg, vae_params=vae_params, dtype=dtype,
                   device=device, **kw)

    def _sample(self, z0, txt, txt_mask, neg_txt, neg_mask):
        """The CFG Euler loop from ``z0`` -> final latents (f32)."""
        B = z0.shape[0]
        use_cfg = self.guidance_scale > 1.0
        fwd = lambda z, t, feats, mask: mochi_forward(
            self.params, self.cfg, z.to(self.dtype), feats, t, mask, dtype=self.dtype,
            attn_impl=self.attn_impl, remat=False)
        z = z0
        for i in range(self.num_steps):
            sigma = self.sigmas[i]
            t = torch.full((B,), float(sigma), dtype=torch.float32, device=z.device)
            pred = fwd(z, t, txt, txt_mask)
            if use_cfg:
                uncond = fwd(z, t, neg_txt, neg_mask)
                pred = uncond + self.guidance_scale * (pred - uncond)
            z = z + float(self.sigmas[i + 1] - sigma) * pred.to(z.dtype)
        return z

    def tiles(self, latent_shape) -> bool:
        """Whether ``vae_tiling`` decodes latents of this shape in tiles: past
        one 256 px / 16-frame tile in any axis under ``"auto"``."""
        _, T, h, w, _ = latent_shape
        return self.vae_tiling == "on" or (self.vae_tiling == "auto"
                                           and (T > 17 or max(h, w) > 32))

    def _decode(self, lat):
        """Final latents -> video in [0, 1]."""
        if lat.shape[-1] == 12:  # the published per-channel statistics are 12-channel
            lat = denormalize_dit_output(lat)
        decode = mochi_vae_decode_tiled if self.tiles(lat.shape) else mochi_vae_decode
        video = decode(self.vae_params, self.vae_cfg, lat, dtype=self.dtype)
        return torch.clamp(video * 0.5 + 0.5, 0.0, 1.0)

    @torch.no_grad()
    def __call__(self, txt, *, num_frames: int, height: int, width: int, text_mask=None,
                 neg_txt=None, neg_mask=None, generator: Optional[torch.Generator] = None,
                 z0: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Decoded video (B, 1 + 6 * ((num_frames - 1) // 6), H, W, 3) in
        [0, 1] with a VAE, the raw DiT-space latents without one.  ``z0``
        replaces the noise draw."""
        dev = self.device
        txt = torch.as_tensor(txt, device=dev)
        B = txt.shape[0]
        if z0 is None:
            lt = (num_frames - 1) // 6 + 1  # Mochi VAE: 6x temporal compression
            shape = (B, lt, height // 8, width // 8, self.cfg.in_channels)
            gen = generator or torch.Generator(dev).manual_seed(0)
            z0 = torch.randn(shape, generator=gen, device=dev)
        z0 = torch.as_tensor(z0, dtype=torch.float32, device=dev)
        ones = torch.ones(txt.shape[:2], dtype=torch.int32, device=dev)
        text_mask = ones if text_mask is None else torch.as_tensor(text_mask, device=dev)
        if neg_txt is None:
            neg_txt, neg_mask = torch.zeros_like(txt), ones
        else:
            neg_txt = torch.as_tensor(neg_txt, device=dev)
            neg_mask = None if neg_mask is None else torch.as_tensor(neg_mask, device=dev)
        lat = self._sample(z0, txt, text_mask, neg_txt, neg_mask)
        if self.vae_params is None:
            return lat
        return self._decode(lat)

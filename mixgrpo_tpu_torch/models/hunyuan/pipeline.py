"""HunyuanVideo text-to-video sampling pipeline.

Port of mixgrpo_tpu/models/hunyuan/pipeline.py: flow-match Euler sampling on
the time-shifted discrete schedule (shift 7.0), the embedded (distilled)
guidance 6.0, and the causal 3D VAE decode.  Text enters as LLM hidden
states + CLIP pooled vectors, precomputed or from ``encode_prompt``.

The denoising loop is the port's ``solvers/rollout.run_rollout`` with every
step deterministic (eta 0): JAX traces it as one ``lax.scan``.  The initial
noise is drawn from a ``torch.Generator`` (seed 0 unless given) on the
pipeline's device, or injected as ``z0`` (the parity tests pass JAX's
draw).  Decoding tiles past 17 latent frames or 32 latent pixels
(``vae_tiling="auto"``), as the reference enables tiling for every real
video decode.

``attn_impl="ulysses"`` (or ``"ring"``) samples under sequence
parallelism: start every rank (``torchrun``; ``parallel.init_distributed``),
make the mesh (``parallel.make_mesh(MeshConfig(dp=1, sp=-1))``) and call
``parallel.ulysses.set_sp_context(mesh)`` first.  Every rank then draws the
same noise from the same seed, runs the DiT with the joint attention split
over the ranks, and decodes the same video.

Spans (``utils/profiling.py``): a call is a ``video`` unit holding
``denoise`` (the Euler loop) and ``decode`` (the VAE).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mixgrpo_tpu_torch.models.hunyuan.model import HunyuanVideoConfig, hunyuan_video_forward
from mixgrpo_tpu_torch.models.hunyuan.scheduler import FlowMatchDiscreteScheduler
from mixgrpo_tpu_torch.models.hunyuan.vae3d import (
    CausalVAEConfig, causal_vae_decode, causal_vae_decode_tiled,
)
from mixgrpo_tpu_torch.solvers.rollout import SamplerConfig, run_rollout
from mixgrpo_tpu_torch.utils.profiling import span, spanned


class HunyuanVideoPipeline:
    def __init__(
        self,
        cfg: HunyuanVideoConfig,
        params,
        *,
        vae_cfg: Optional[CausalVAEConfig] = None,
        vae_params=None,
        num_steps: int = 50,
        shift: float = 7.0,
        guidance_scale: float = 6.0,
        dtype=torch.bfloat16,
        attn_impl: str = "auto",
        text_encoder=None,  # text_encoder.LLMTextEncoder
        clip_pooler=None,  # text_encoder.CLIPTextPooler
        vae_tiling: str = "auto",  # auto | on | off
        device="cuda",
    ):
        if vae_tiling not in ("auto", "on", "off"):
            raise ValueError(f"unknown vae_tiling {vae_tiling!r}")
        self.cfg, self.params = cfg, params
        self.text_encoder, self.clip_pooler = text_encoder, clip_pooler
        self.vae_cfg, self.vae_params = vae_cfg, vae_params
        self.num_steps = num_steps
        self.guidance_scale = guidance_scale
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.vae_tiling = vae_tiling
        self.device = torch.device(device)
        sched = FlowMatchDiscreteScheduler(shift=shift)
        sched.set_timesteps(num_steps)
        self.sigmas = sched.sigmas

    @classmethod
    def from_checkpoint(cls, dit_path: str, vae_path: Optional[str] = None,
                        cfg: Optional[HunyuanVideoConfig] = None,
                        vae_cfg: Optional[CausalVAEConfig] = None, *, device="cuda",
                        dtype=torch.bfloat16, **kw) -> "HunyuanVideoPipeline":
        """The released transformer ``.pt`` and, optionally, the causal VAE
        (safetensors), read to ``device`` at ``dtype``."""
        from mixgrpo_tpu_torch.models.hunyuan.load import load_hunyuan_video
        from mixgrpo_tpu_torch.models.hunyuan.vae3d import load_causal_vae_decoder

        params, cfg = load_hunyuan_video(dit_path, cfg, device=device, dtype=dtype)
        vae_params = None
        if vae_path is not None:
            vae_cfg = vae_cfg or CausalVAEConfig.hunyuan_video()
            vae_params = load_causal_vae_decoder(vae_path, vae_cfg, device=device, dtype=dtype)
        return cls(cfg, params, vae_cfg=vae_cfg, vae_params=vae_params, dtype=dtype,
                   device=device, **kw)

    def _sample(self, z0, txt, pooled, text_mask):
        """The deterministic Euler loop from ``z0`` -> final latents (f32)."""
        B, T, H, W, C = z0.shape
        dev = self.device
        g = torch.full((B,), self.guidance_scale, dtype=torch.float32, device=dev)

        def model_fn(z, sigma):
            t = torch.broadcast_to(torch.as_tensor(sigma, dtype=torch.float32, device=dev), (B,))
            out = hunyuan_video_forward(
                self.params, self.cfg, z.reshape(B, T, H, W, C).to(self.dtype), txt, pooled,
                t, g, text_mask, dtype=self.dtype, attn_impl=self.attn_impl, remat=False)
            return out.reshape(B, -1)

        with span("denoise"):
            out = run_rollout(SamplerConfig(num_steps_max=self.num_steps, eta=0.0), model_fn,
                              z0.reshape(B, -1).float(), sigmas=self.sigmas,
                              deterministic=np.ones(self.num_steps, bool),
                              num_steps=self.num_steps)
        return out.final_latents.reshape(B, T, H, W, C)

    def encode_prompt(self, prompts, data_type: str = "video"):
        """Raw strings -> (LLM hidden states f32, text mask, CLIP pooled f32),
        through ``text_encoder`` (needed) and ``clip_pooler`` (zeros
        without one)."""
        if self.text_encoder is None:
            raise ValueError("the pipeline was built without a text_encoder: pass "
                             "precomputed hidden states instead")
        prompts = [prompts] if isinstance(prompts, str) else list(prompts)
        txt, mask = self.text_encoder(prompts, data_type=data_type)
        if self.clip_pooler is not None:
            pooled = self.clip_pooler(prompts)
        else:
            pooled = torch.zeros((len(prompts), self.cfg.text_states_dim_2), device=txt.device)
        return txt.float(), mask, pooled.float()

    def tiles(self, latent_shape) -> bool:
        """Whether ``vae_tiling`` decodes latents of this shape in tiles."""
        _, T, h, w, _ = latent_shape
        return self.vae_tiling == "on" or (self.vae_tiling == "auto"
                                           and (T > 17 or max(h, w) > 32))

    def _decode(self, lat):
        """Final latents -> video in [0, 1]."""
        lat = lat / self.vae_cfg.scaling_factor
        decode = causal_vae_decode_tiled if self.tiles(lat.shape) else causal_vae_decode
        with span("decode"):
            video = decode(self.vae_params, self.vae_cfg, lat, dtype=self.dtype)
        return torch.clamp(video * 0.5 + 0.5, 0.0, 1.0)

    @torch.no_grad()
    @spanned("video")
    def __call__(self, txt, pooled, *, video_length: int, height: int, width: int,
                 text_mask=None, generator: Optional[torch.Generator] = None,
                 z0: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Decoded video (B, T, H, W, 3) in [0, 1], or the raw latents
        without a VAE.  ``z0`` replaces the noise draw."""
        dev = self.device
        txt = torch.as_tensor(txt, device=dev)
        pooled = torch.as_tensor(pooled, device=dev)
        B = txt.shape[0]
        if z0 is None:
            lt = (video_length - 1) // (
                self.vae_cfg.time_compression_ratio if self.vae_cfg else 4) + 1
            shape = (B, lt, height // 8, width // 8, self.cfg.in_channels)
            gen = generator or torch.Generator(dev).manual_seed(0)
            z0 = torch.randn(shape, generator=gen, device=dev)
        z0 = torch.as_tensor(z0, dtype=torch.float32, device=dev)
        if text_mask is None:
            text_mask = torch.ones(txt.shape[:2], dtype=torch.int32, device=dev)
        lat = self._sample(z0, txt, pooled, torch.as_tensor(text_mask, device=dev))
        if self.vae_params is None:
            return lat
        return self._decode(lat)

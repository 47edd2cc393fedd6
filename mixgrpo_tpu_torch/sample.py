"""Inference: mixed-model FLUX sampling (GRPO-tuned + base).

Port of mixgrpo_tpu/sample.py (``DualFluxPipeline``): the GRPO-tuned
transformer runs the first ``mix_sampling_steps`` of the trajectory and the
base transformer the rest, every step a deterministic ODE step (eta = 0);
the dynamic-shift schedule follows diffusers' FluxPipeline
(``calculate_shift``, then ``sigma' = e^mu / (e^mu + 1/sigma - 1)``).

``main`` is the CLI over a FLUX directory in the HF layout: the base
transformer (``transformer/``, sharded safetensors), an optional tuned one
(``--new_model_ckpt``, one export file), the VAE decoder and both text
encoders, each loaded on ``--device`` (``cuda`` by default, in bf16; the
tests ask for ``cpu``, which computes in f32).  Each prompt batch's
initial noise comes from ``torch.Generator(device).manual_seed(seed)``, so
the same ``--seed`` gives other images than JAX's ``jax.random.key(seed)``.
One process samples every prompt (JAX shards them by process).
``quant="int8"`` quantises the base and tuned trees' block matmuls
(``ops/quant.py``); the pipeline holds only the quantised trees, whose other
leaves are the input's tensors.

Run: ``python -m mixgrpo_tpu_torch.sample --model_path FLUX.1-dev
--prompt_path prompts.txt --output_dir out``.
"""

from __future__ import annotations

import argparse
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
        virtual_depth=None,  # benchmark aid: see flux_forward's docstring
        vae_tiling: str = "auto",  # auto | on | off
        max_steps_per_call: Optional[int] = None,
        device="cuda",
    ):
        if quant == "int8":
            from mixgrpo_tpu_torch.ops.quant import quantize_flux_params

            base_params = quantize_flux_params(base_params)
            tuned_params = quantize_flux_params(tuned_params) if tuned_params is not None \
                else None
        elif quant != "none":
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
            virtual_depth=virtual_depth, device=self.device,
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
    process_index: int = 0, start: int = 0,
):
    """PNG per prompt + metadata JSON.  ``start`` numbers the images of a
    later batch after the earlier ones, whose metadata entries are kept
    (JAX numbers every batch from 0, so each batch overwrote the last)."""
    from PIL import Image

    os.makedirs(output_dir, exist_ok=True)
    meta_path = os.path.join(output_dir, f"metadata_{process_index}.json")
    meta = []
    if start > 0 and os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    arr = images01.float().cpu().numpy() if torch.is_tensor(images01) else np.asarray(images01)
    for i, (img, prompt) in enumerate(zip(arr, prompts)):
        name = f"img_p{process_index}_{start + i:05d}.png"
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(output_dir, name)
        )
        meta.append({"image": name, "prompt": prompt, "seed": int(seeds[i])})
    with open(meta_path, "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def main(argv=None, family=None):
    """Sample every prompt of ``--prompt_path`` with the base (and tuned)
    transformer; writes PNGs and ``metadata_0.json`` to ``--output_dir``.
    ``family`` defaults to ``presets.flux_family()``."""
    from mixgrpo_tpu_torch.models.flux.load import load_flux_params, load_vae_decoder_params
    from mixgrpo_tpu_torch.preprocess import (
        build_prompt_encoder_from_dir, compute_dtype, read_prompts,
    )
    from mixgrpo_tpu_torch.parallel.mesh import init_distributed, resolve_device
    from mixgrpo_tpu_torch.presets import flux_family
    from mixgrpo_tpu_torch.utils.logging import main_print, process_count, process_index

    p = argparse.ArgumentParser(description="Mixed-model FLUX sampling (tuned + base)")
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--new_model_ckpt", type=str, default=None,
                   help="fine-tuned transformer safetensors (one export file)")
    p.add_argument("--prompt_path", type=str, required=True)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--h", type=int, default=1024)
    p.add_argument("--w", type=int, default=1024)
    p.add_argument("--sampling_steps", type=int, default=50)
    p.add_argument("--mix_sampling_steps", type=int, default=30)
    p.add_argument("--guidance_scale", type=float, default=3.5)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--clip_bpe_path", type=str, default=os.environ.get("CLIP_BPE_PATH"))
    p.add_argument("--vae_tiling", type=str, default="auto", choices=["auto", "on", "off"],
                   help="tiled VAE decode (auto: on above 768px)")
    p.add_argument("--quant", type=str, default="none", choices=["none", "int8"])
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (each rank takes cuda:<LOCAL_RANK mod cards>) or cpu")
    args = p.parse_args(argv)

    fam = family or flux_family()
    dev = resolve_device(args.device)  # raises without a card unless --device cpu
    init_distributed(device=dev)  # torchrun; no-op for one
    dtype = compute_dtype(dev)
    flux_cfg, vae_cfg = fam["flux"], fam["vae"]
    kw = dict(dtype=dtype, device=dev)
    vae = load_vae_decoder_params(os.path.join(args.model_path, "vae"), vae_cfg, **kw)
    enc = build_prompt_encoder_from_dir(args.model_path, clip_bpe_path=args.clip_bpe_path,
                                        family=fam, **kw)
    # the trees go straight to the pipeline, so that under --quant int8 only
    # their quantised copies stay alive
    pipe = DualFluxPipeline(
        flux_cfg, load_flux_params(os.path.join(args.model_path, "transformer"), flux_cfg, **kw),
        load_flux_params(args.new_model_ckpt, flux_cfg, **kw) if args.new_model_ckpt else None,
        vae_cfg=vae_cfg, vae_params=vae, height=args.h, width=args.w,
        num_steps=args.sampling_steps, mix_sampling_steps=args.mix_sampling_steps,
        guidance_scale=args.guidance_scale, dtype=dtype, quant=args.quant,
        vae_tiling=args.vae_tiling, device=dev)

    prompts = read_prompts(args.prompt_path)
    pi, pc = process_index(), process_count()
    mine = prompts[pi::pc]  # each rank every pc-th prompt from its pi-th, as JAX
    for i in range(0, len(mine), args.batch_size):
        chunk = mine[i:i + args.batch_size]
        emb, pooled = enc(chunk)
        seed = args.seed + pi * 100000 + i
        imgs = pipe(torch.from_numpy(emb).to(dev, dtype), torch.from_numpy(pooled).to(dev, dtype),
                    torch.Generator(dev).manual_seed(seed))
        save_outputs(imgs, chunk, args.output_dir, [seed + j for j in range(len(chunk))],
                     pi, start=i)
        main_print(f"sampled {i + len(chunk)}/{len(mine)}")


if __name__ == "__main__":
    main()

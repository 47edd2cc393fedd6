"""t-SNE embedding probe: rollouts with a fixed SDE interval, latents saved.

Port of mixgrpo_tpu/tsne_probe.py: sample groups of images with the SDE
active only in ``[SDE_sampling_start_step, SDE_sampling_end_step)`` and
save every step's latents (``latents_all_steps.npy``, (B, T+1, L, C)), the
final latents and, with a VAE, the decoded images for t-SNE analysis.
The rollout is the port's ``FluxSampler`` (the DiT on ``--device``, ``cuda``
by default, in bf16; f32 on the CPU), its noise from ``torch.Generator``s
seeded by ``--seed``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from mixgrpo_tpu_torch.sampler import FluxSampler
from mixgrpo_tpu_torch.solvers.rollout import SamplerConfig
from mixgrpo_tpu_torch.solvers.schedule import deterministic_mask, sigma_schedule
from mixgrpo_tpu_torch.utils.logging import main_print


def run_probe(
    sampler: FluxSampler,
    params,
    txt,
    pooled,
    *,
    sampling_steps: int,
    shift: float,
    sde_start: int,
    sde_end: int,
    num_generations: int,
    generator: torch.Generator,
    output_dir: str,
    decode_fn=None,
):
    """Roll out ``num_generations`` trajectories per prompt with the SDE
    window fixed to [sde_start, sde_end); save all step latents + images."""
    from mixgrpo_tpu_torch.sample import save_outputs

    os.makedirs(output_dir, exist_ok=True)
    T = sampling_steps
    sig = sigma_schedule(T, shift)
    det = deterministic_mask(T, range(sde_start, sde_end))

    G = num_generations
    txt_g = torch.repeat_interleave(txt, G, dim=0)
    pooled_g = torch.repeat_interleave(pooled, G, dim=0)
    z0 = sampler.init_noise(generator, txt.shape[0] * G, same_noise_groups=G)
    out = sampler.rollout(params, z0, txt_g, pooled_g, sig, det, T, generator)

    lat = out.all_latents.float().cpu().numpy()  # (B, T+1, L, C)
    np.save(os.path.join(output_dir, "latents_all_steps.npy"), lat)
    np.save(os.path.join(output_dir, "latents_final.npy"), out.final_latents.float().cpu().numpy())
    if decode_fn is not None:
        imgs = decode_fn(out.final_latents)
        save_outputs(imgs, [f"gen_{i}" for i in range(imgs.shape[0])], output_dir,
                     seeds=[0] * imgs.shape[0])
    main_print(f"probe saved to {output_dir}: latents {lat.shape}")
    return out


def main(argv=None, family=None):
    """``family`` defaults to ``presets.flux_family()``."""
    from mixgrpo_tpu_torch.data.dataset import LatentDataset
    from mixgrpo_tpu_torch.models.flux.load import load_flux_params
    from mixgrpo_tpu_torch.preprocess import compute_dtype
    from mixgrpo_tpu_torch.presets import flux_family

    p = argparse.ArgumentParser()
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--data_json_path", type=str, required=True, help="embedding cache dir")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--h", type=int, default=512)
    p.add_argument("--w", type=int, default=512)
    p.add_argument("--sampling_steps", type=int, default=25)
    p.add_argument("--shift", type=float, default=3.0)
    p.add_argument("--eta", type=float, default=0.7)
    p.add_argument("--SDE_sampling_start_step", type=int, default=0)
    p.add_argument("--SDE_sampling_end_step", type=int, default=25)
    p.add_argument("--num_generations", type=int, default=12)
    p.add_argument("--num_prompts", type=int, default=2)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    fam = family or flux_family()
    flux_cfg = fam["flux"]
    dev, dtype = torch.device(args.device), compute_dtype(args.device)
    params = load_flux_params(os.path.join(args.model_path, "transformer"), flux_cfg,
                              dtype=dtype, device=dev)
    ds = LatentDataset(args.data_json_path)
    items = [ds.get(i) for i in range(min(args.num_prompts, len(ds)))]
    txt = torch.from_numpy(np.stack([it["prompt_embed"] for it in items])).to(dev, dtype)
    pooled = torch.from_numpy(np.stack([it["pooled"] for it in items])).to(dev, dtype)
    sampler = FluxSampler(flux_cfg, SamplerConfig(num_steps_max=args.sampling_steps,
                                                  eta=args.eta),
                          height=args.h, width=args.w, text_len=txt.shape[1], dtype=dtype,
                          device=dev)
    return run_probe(sampler, params, txt, pooled, sampling_steps=args.sampling_steps,
                     shift=args.shift, sde_start=args.SDE_sampling_start_step,
                     sde_end=args.SDE_sampling_end_step, num_generations=args.num_generations,
                     generator=torch.Generator(dev).manual_seed(args.seed),
                     output_dir=args.output_dir)


if __name__ == "__main__":
    main()

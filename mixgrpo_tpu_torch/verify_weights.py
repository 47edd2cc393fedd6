"""Real-checkpoint numerical parity harness.

Port of mixgrpo_tpu/verify_weights.py: given the released checkpoints, each
check computes a small deterministic fingerprint of one model's output on
fixed inputs (a flattened slice, the mean and the std) and compares it with
recorded goldens.

Workflow:

  1. On a machine with the released weights, validate outputs once (e.g.
     against diffusers/transformers), then record goldens:
         python -m mixgrpo_tpu_torch.verify_weights --record \\
             --goldens goldens_torch.npz \\
             --flux /ckpts/flux-dev/transformer --flux-vae /ckpts/flux-dev/vae \\
             --t5 /ckpts/flux-dev/text_encoder_2 --clip-l /ckpts/flux-dev/text_encoder \\
             --hps /ckpts/HPS_v2.1_compressed.pt --pick-score /ckpts/PickScore_v1 \\
             --clip-score /ckpts/DFN5B-CLIP-ViT-H-14-384.bin \\
             --image-reward /ckpts/ImageReward.pt \\
             --image-reward-med-config /ckpts/med_config.json
  2. Commit the small .npz; a later environment (another torch or CUDA
     version, a refactored loader) re-runs with --check and must match.

The inputs come from numpy seeds (JAX draws its FLUX and VAE inputs from
``jax.random``), so the port's goldens are its own and are not shared with
the JAX package's.  The HunyuanVideo checks draw from numpy with the seed
JAX gives its ``jax.random.key`` (13, 14, 17; the DiT's latents, text and
pooled vector all from 17, as JAX draws them from one key).  Every check
computes in f32 unless given a ``dtype``, on ``--device`` (``cuda`` by
default).  ``hunyuan_llm`` takes the depth of the file it reads (a tower cut
to fewer than 32 layers runs all but the skipped two), and so does
``mochi`` (its config read from the file's tensors); the Mochi checks draw
from numpy with JAX's seeds (15 for the DiT's latents and text, as JAX
draws both from one key; 16 for the VAE's latents).
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Callable, Dict

import numpy as np
import torch

SLICE = 64  # fingerprint length per output


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().float().cpu().numpy()
    return np.asarray(v, np.float64)


def fingerprint(out: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Reduce arrays to committed-size fingerprints."""
    fp = {}
    for k, v in out.items():
        a = _numpy(v).reshape(-1)
        fp[f"{k}.slice"] = a[:SLICE].astype(np.float32)
        fp[f"{k}.mean"] = np.float32(a.mean())
        fp[f"{k}.std"] = np.float32(a.std())
    return fp


def _image(h: int, w: int, batch: int = 2) -> np.ndarray:
    """Deterministic synthetic image batch in [0, 1] (no RNG dependence)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = (np.sin(xx / 7.0) + np.cos(yy / 11.0) + 2.0) / 4.0
    imgs = np.stack([np.clip(base * (0.6 + 0.4 * b), 0, 1) for b in range(batch)])
    return np.repeat(imgs[..., None], 3, axis=-1)


def _ids(vocab: int, n: int, seq: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(1, max(vocab - 2, 2), size=(n, seq)).astype(np.int64)


def _normal(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# checks: name -> fn(path, cfg=None, device=..., dtype=None, **aux) -> outputs
# ---------------------------------------------------------------------------


def check_flux(path: str, cfg=None, depth=None, device="cuda", dtype=None):
    import dataclasses

    from mixgrpo_tpu_torch.models.flux.load import load_flux_params
    from mixgrpo_tpu_torch.models.flux.model import flux_forward
    from mixgrpo_tpu_torch.models.flux.rope import make_image_ids, make_text_ids, rope_tables
    from mixgrpo_tpu_torch.presets import flux_family

    cfg = cfg or flux_family()["flux"]
    params = load_flux_params(path, cfg, dtype=torch.float32, device=device)
    if depth is not None:
        dd, ds = depth
        params = dict(params)
        params["double"] = {k: {n: t[:dd] for n, t in v.items()}
                            for k, v in params["double"].items()}
        params["single"] = {k: {n: t[:ds] for n, t in v.items()}
                            for k, v in params["single"].items()}
        cfg = dataclasses.replace(cfg, depth_double=dd, depth_single=ds)
    lh = lw = lt = 16
    t = lambda a: torch.from_numpy(a).to(device)
    img = t(_normal(7, (1, (lh // 2) * (lw // 2), cfg.in_channels)))
    txt = t(_normal(8, (1, lt, cfg.context_dim)))
    pooled = t(_normal(9, (1, cfg.pooled_dim)))
    ids = np.concatenate([make_text_ids(lt), make_image_ids(lh, lw)])
    cos, sin = rope_tables(ids, cfg.axes_dims, cfg.theta, device=device)
    with torch.no_grad():
        out = flux_forward(params, cfg, img, txt, pooled, t(np.full((1,), 0.5, np.float32)),
                           t(np.full((1,), 3.5, np.float32)), cos, sin,
                           dtype=dtype or torch.float32, attn_impl="eager")
    return {"flux_out": out}


def check_flux_vae(path: str, cfg=None, device="cuda", dtype=None):
    from mixgrpo_tpu_torch.models.flux.load import load_vae_decoder_params
    from mixgrpo_tpu_torch.models.flux.vae import vae_decode
    from mixgrpo_tpu_torch.presets import flux_family

    cfg = cfg or flux_family()["vae"]
    params = load_vae_decoder_params(path, cfg, dtype=torch.float32, device=device)
    lat = torch.from_numpy(_normal(11, (1, 16, 16, cfg.latent_channels))).to(device)
    with torch.no_grad():
        img = vae_decode(params, cfg, lat, dtype=dtype or torch.float32)
    return {"flux_vae_out": img}


def check_t5(path: str, cfg=None, device="cuda", dtype=None):
    from mixgrpo_tpu_torch.models.flux.load import load_safetensors_dir
    from mixgrpo_tpu_torch.models.text.t5 import load_t5_hf, t5_encode
    from mixgrpo_tpu_torch.presets import flux_family

    cfg = cfg or flux_family()["t5"]
    params = load_t5_hf(load_safetensors_dir(path), cfg, device=device)
    ids = _ids(cfg.vocab, 2, 24, seed=3)
    mask = np.ones_like(ids)
    mask[1, 16:] = 0
    with torch.no_grad():
        out = t5_encode(params, cfg, torch.from_numpy(ids).to(device),
                        torch.from_numpy(mask).to(device), dtype=dtype or torch.float32)
    return {"t5_out": out}


def check_clip_l(path: str, cfg=None, device="cuda", dtype=None):
    from mixgrpo_tpu_torch.models.flux.load import load_safetensors_dir
    from mixgrpo_tpu_torch.models.text.clip import clip_text_features
    from mixgrpo_tpu_torch.models.text.clip_load import load_clip_hf_text_only
    from mixgrpo_tpu_torch.presets import flux_family

    cfg = cfg or flux_family()["clip"]
    params = load_clip_hf_text_only(load_safetensors_dir(path), cfg, device=device)
    ids = np.sort(_ids(cfg.text.vocab, 2, cfg.text.context, seed=4), axis=1)
    pooled = clip_text_features(params, cfg, torch.from_numpy(ids),
                                dtype=dtype or torch.float32, project=False)
    return {"clip_l_pooled": pooled}


def _clip_reward_check(model):
    size = model.cfg.vision.image_size
    ids = np.sort(_ids(model.cfg.text.vocab, 2, model.cfg.text.context, seed=5), axis=1)
    return model.score(_image(size, size), ids)


def check_hps(path: str, cfg=None, device="cuda", dtype=None):
    from mixgrpo_tpu_torch.rewards.clip_family import HPSReward

    model = HPSReward.from_checkpoint(path, device=device, dtype=dtype or torch.float32)
    return {"hps_scores": _clip_reward_check(model)}


def check_pick_score(path: str, cfg=None, device="cuda", dtype=None):
    from mixgrpo_tpu_torch.rewards.clip_family import PickScoreReward

    model = PickScoreReward.from_checkpoint(path, device=device, dtype=dtype or torch.float32)
    return {"pick_scores": _clip_reward_check(model)}


def check_clip_score(path: str, cfg=None, device="cuda", dtype=None):
    from mixgrpo_tpu_torch.rewards.clip_family import CLIPScoreReward

    model = CLIPScoreReward.from_checkpoint(path, device=device, dtype=dtype or torch.float32)
    return {"clip_scores": _clip_reward_check(model)}


def check_image_reward(path: str, cfg=None, med_config=None, device="cuda", dtype=None):
    """``cfg``: an optional (vision, text) pair of BLIP configs (default
    ViT-L/16 and ``med_config``'s BERT)."""
    from mixgrpo_tpu_torch.rewards.image_reward import ImageRewardModel

    vcfg, tcfg = cfg or (None, None)
    model = ImageRewardModel.from_checkpoint(path, med_config, vision_cfg=vcfg, text_cfg=tcfg,
                                             device=device, dtype=dtype or torch.float32)
    vocab = min(30522, model.tcfg.vocab)
    ids = _ids(vocab, 2, 35, seed=6)
    ids[:, 0] = min(101, vocab - 1)  # [CLS]
    return {"image_reward_scores": model.score(_image(224, 224), ids, np.ones_like(ids))}


def check_hunyuan_llm(path: str, cfg=None, device="cuda", dtype=None):
    import dataclasses

    from mixgrpo_tpu_torch.models.text.llama import (
        LlamaConfig, llama_hidden_states, llama_layers_in, load_llama_hf,
    )
    from mixgrpo_tpu_torch.utils.safetensors_io import SafetensorsDir

    state = SafetensorsDir(path)
    cfg = cfg or dataclasses.replace(LlamaConfig.llava_llama3_8b(),
                                     n_layers=llama_layers_in(state))
    params = load_llama_hf(state, cfg, device=device, dtype=torch.float32)
    ids = _ids(min(cfg.vocab, 32000), 2, 24, seed=8)
    mask = np.ones_like(ids)
    mask[1, 18:] = 0
    out = llama_hidden_states(params, cfg, torch.from_numpy(ids), torch.from_numpy(mask),
                              hidden_state_skip_layer=2, dtype=dtype or torch.float32)
    return {"hunyuan_llm_out": out}


def check_hunyuan_vae(path: str, cfg=None, device="cuda", dtype=None):
    from mixgrpo_tpu_torch.models.hunyuan.vae3d import (
        CausalVAEConfig, causal_vae_decode, causal_vae_encode, load_causal_vae_decoder,
        load_causal_vae_encoder,
    )

    cfg = cfg or CausalVAEConfig.hunyuan_video()
    dt = dtype or torch.float32
    dec = load_causal_vae_decoder(path, cfg, device=device, dtype=torch.float32)
    lat = torch.from_numpy(_normal(13, (1, 2, 8, 8, cfg.latent_channels))).to(device)
    out = {"hunyuan_vae_dec": causal_vae_decode(dec, cfg, lat, dtype=dt)}
    try:
        enc = load_causal_vae_encoder(path, cfg, device=device, dtype=torch.float32)
    except KeyError:  # a decoder-only checkpoint
        return out
    vid = torch.from_numpy(_normal(14, (1, 5, 32, 32, 3))).to(device)
    out["hunyuan_vae_enc"] = causal_vae_encode(enc, cfg, vid, sample=False, dtype=dt)
    return out


def check_hunyuan_dit(path: str, cfg=None, device="cuda", dtype=None):
    from mixgrpo_tpu_torch.models.hunyuan.load import load_hunyuan_video
    from mixgrpo_tpu_torch.models.hunyuan.model import hunyuan_video_forward

    params, cfg = load_hunyuan_video(path, cfg, device=device, dtype=torch.float32)
    t = lambda a: torch.from_numpy(a).to(device)
    z = t(_normal(17, (1, 2, 8, 8, cfg.in_channels)))
    txt = t(_normal(17, (1, 6, cfg.text_states_dim)))
    pooled = t(_normal(17, (1, cfg.text_states_dim_2)))
    g = t(np.full((1,), 6.0, np.float32)) if cfg.guidance_embed else None
    with torch.no_grad():
        out = hunyuan_video_forward(params, cfg, z, txt, pooled, t(np.full((1,), 0.5, np.float32)),
                                    g, text_mask=t(np.ones((1, 6), np.int32)),
                                    dtype=dtype or torch.float32, attn_impl="eager")
    return {"hunyuan_dit_out": out}


def check_mochi(path: str, cfg=None, device="cuda", dtype=None):
    from mixgrpo_tpu_torch.models.mochi.load import infer_mochi_config, load_mochi_hf
    from mixgrpo_tpu_torch.models.mochi.model import mochi_forward
    from mixgrpo_tpu_torch.utils.safetensors_io import SafetensorsDir

    state = SafetensorsDir(path)
    cfg = cfg or infer_mochi_config(state)
    params = load_mochi_hf(state, cfg, device=device, dtype=torch.float32)
    t = lambda a: torch.from_numpy(a).to(device)
    z = t(_normal(15, (1, 2, 8, 8, cfg.in_channels)))
    txt = t(_normal(15, (1, 6, cfg.text_embed_dim)))
    with torch.no_grad():
        out = mochi_forward(params, cfg, z, txt, t(np.full((1,), 0.5, np.float32)),
                            t(np.ones((1, 6), np.int32)), dtype=dtype or torch.float32,
                            attn_impl="eager", remat=False)
    return {"mochi_out": out}


def check_mochi_vae(path: str, cfg=None, device="cuda", dtype=None):
    from mixgrpo_tpu_torch.models.mochi.vae import (
        MochiVAEConfig, load_mochi_vae_decoder, mochi_vae_decode,
    )

    cfg = cfg or MochiVAEConfig.mochi_preview()
    params = load_mochi_vae_decoder(path, cfg, device=device, dtype=torch.float32)
    lat = torch.from_numpy(_normal(16, (1, 2, 8, 8, cfg.latent_channels))).to(device)
    return {"mochi_vae_dec": mochi_vae_decode(params, cfg, lat, dtype=dtype or torch.float32)}


CHECKS: Dict[str, Callable] = {
    "flux": check_flux,
    "flux_vae": check_flux_vae,
    "t5": check_t5,
    "clip_l": check_clip_l,
    "hps": check_hps,
    "pick_score": check_pick_score,
    "clip_score": check_clip_score,
    "image_reward": check_image_reward,
    "hunyuan_llm": check_hunyuan_llm,
    "hunyuan_vae": check_hunyuan_vae,
    "hunyuan_dit": check_hunyuan_dit,
    "mochi": check_mochi,
    "mochi_vae": check_mochi_vae,
}


def run_checks(
    specs: Dict[str, Dict[str, Any]],
    goldens_path: str,
    record: bool,
    rtol: float = 2e-3,
    atol: float = 2e-3,
) -> Dict[str, str]:
    """``specs``: check name -> kwargs for the check fn (must include
    ``path``).  Returns {check: "recorded"|"ok"|"MISMATCH: ..."}."""
    results: Dict[str, str] = {}
    fps: Dict[str, np.ndarray] = {}
    golden = None if record else dict(np.load(goldens_path))
    for name, kwargs in specs.items():
        out = CHECKS[name](**kwargs)
        fp = {f"{name}/{k}": v for k, v in fingerprint(out).items()}
        if record:
            fps.update(fp)
            results[name] = "recorded"
            continue
        errs = []
        for k, v in fp.items():
            if k not in golden:
                errs.append(f"{k}: missing from goldens")
                continue
            try:
                np.testing.assert_allclose(v, golden[k], rtol=rtol, atol=atol)
            except AssertionError:
                diff = float(np.max(np.abs(np.asarray(v, np.float64)
                                           - np.asarray(golden[k], np.float64))))
                errs.append(f"{k}: max|diff|={diff:.3e}")
        results[name] = "ok" if not errs else "MISMATCH: " + "; ".join(errs)
    if record:
        np.savez(goldens_path, **fps)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--goldens", required=True)
    ap.add_argument("--record", action="store_true")
    ap.add_argument("--rtol", type=float, default=2e-3)
    ap.add_argument("--atol", type=float, default=2e-3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--flux")
    ap.add_argument("--flux-depth", default=None,
                    help="D,S truncated-depth fingerprint (memory bound)")
    ap.add_argument("--flux-vae")
    ap.add_argument("--t5")
    ap.add_argument("--clip-l")
    ap.add_argument("--hps")
    ap.add_argument("--pick-score")
    ap.add_argument("--clip-score")
    ap.add_argument("--image-reward")
    ap.add_argument("--image-reward-med-config")
    ap.add_argument("--hunyuan-llm")
    ap.add_argument("--hunyuan-vae")
    ap.add_argument("--hunyuan-dit", help="HunyuanVideo transformer .pt file or directory")
    ap.add_argument("--mochi")
    ap.add_argument("--mochi-vae")
    args = ap.parse_args(argv)

    dev = {"device": args.device}
    specs: Dict[str, Dict[str, Any]] = {}
    if args.flux:
        depth = None
        if args.flux_depth:
            d, s = args.flux_depth.split(",")
            depth = (int(d), int(s))
        specs["flux"] = {"path": args.flux, "depth": depth, **dev}
    for flag in ("flux_vae", "t5", "clip_l", "hps", "pick_score", "clip_score",
                 "hunyuan_llm", "hunyuan_vae", "hunyuan_dit", "mochi", "mochi_vae"):
        v = getattr(args, flag)
        if v:
            specs[flag] = {"path": v, **dev}
    if args.image_reward:
        specs["image_reward"] = {"path": args.image_reward,
                                 "med_config": args.image_reward_med_config, **dev}
    if not specs:
        ap.error("no checkpoints given")

    results = run_checks(specs, args.goldens, args.record, rtol=args.rtol, atol=args.atol)
    bad = 0
    for name, status in results.items():
        print(f"{name}: {status}")
        bad += status.startswith("MISMATCH")
    if bad:
        sys.exit(1)
    return results


if __name__ == "__main__":
    main()

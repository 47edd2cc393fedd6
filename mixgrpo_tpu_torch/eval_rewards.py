"""Reward evaluation app: score generated images with the reward zoo.

Port of mixgrpo_tpu/eval_rewards.py: read the inference metadata JSON, score
each (image, prompt) pair with any or all reward models ("all" = HPS +
CLIP-score + PickScore + ImageReward [+ UnifiedReward when its URL is
given]), and write a per-image JSON plus per-model means.  PickScore is
reported denormalized as ``(r * 8 + 18) / 100``; per-sample success flags
propagate into the means (failed scores are left out).  Single-image mode:
``--image`` + ``--prompt``.

Under torchrun each rank scores every ``count``-th entry from its own
(``entries[pi::pc]``) into ``rewards_<pi>.json``, and rank 0 writes the
summary over every shard after a barrier, as JAX does across hosts.  The
models run on ``--device`` (``cuda`` by default, each rank on
``cuda:<LOCAL_RANK mod cards>``, bf16; f32 on the CPU).  As
in ``train.build_reward_models``, every tokenizer is found when the models
are built, ImageReward's too, and a missing one raises there.

Run: ``python -m mixgrpo_tpu_torch.eval_rewards --metadata out/metadata_0.json
--image_dir out --output_dir eval --hps_path ... --clip_bpe_path merges.txt``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Sequence

import numpy as np

from mixgrpo_tpu_torch.utils.logging import main_print


def load_metadata(path: str) -> List[dict]:
    """Load inference metadata: a single JSON list or a directory of
    ``metadata_*.json`` host shards."""
    if os.path.isdir(path):
        entries = []
        for f in sorted(os.listdir(path)):
            if f.startswith("metadata") and f.endswith(".json"):
                with open(os.path.join(path, f)) as fh:
                    entries.extend(json.load(fh))
        return entries
    with open(path) as f:
        return json.load(f)


def load_images(image_dir: str, names: Sequence[str]) -> np.ndarray:
    from PIL import Image

    imgs = []
    for n in names:
        arr = np.asarray(
            Image.open(os.path.join(image_dir, n)).convert("RGB"), np.float32
        ) / 255.0
        imgs.append(arr)
    return np.stack(imgs)


def evaluate(
    entries: List[dict],
    image_dir: str,
    reward_models: Dict[str, object],
    batch_size: int = 8,
    process_index: int = 0,
    process_count: int = 1,
) -> List[dict]:
    mine = entries[process_index::process_count]
    results = []
    for i in range(0, len(mine), batch_size):
        chunk = mine[i : i + batch_size]
        images = load_images(image_dir, [e["image"] for e in chunk])
        prompts = [e["prompt"] for e in chunk]
        per_model: Dict[str, tuple] = {}
        for name, model in reward_models.items():
            scores, successes = model(images, prompts)
            per_model[name] = (scores, successes)
        for j, e in enumerate(chunk):
            row = dict(e)
            for name, (scores, successes) in per_model.items():
                row[f"{name}_reward"] = scores[j]
                row[f"{name}_success"] = bool(successes[j])
            results.append(row)
        main_print(f"scored {i + len(chunk)}/{len(mine)}")
    return results


def summarize(results: List[dict]) -> Dict[str, float]:
    """Per-model means over successful samples; PickScore denormalized."""
    out: Dict[str, float] = {}
    names = {
        k[: -len("_reward")] for k in results[0] if k.endswith("_reward")
    } if results else set()
    for name in sorted(names):
        vals = [
            r[f"{name}_reward"] for r in results
            if r.get(f"{name}_success", True) and r[f"{name}_reward"] is not None
        ]
        if not vals:
            continue
        mean = float(np.mean(vals))
        if name == "pick_score":
            mean = (mean * 8.0 + 18.0) / 100.0
        out[f"{name}_mean"] = mean
        out[f"{name}_count"] = len(vals)
    return out


def gather_result_shards(output_dir: str) -> List[dict]:
    """Every ``rewards_*.json`` shard of ``output_dir``, so the summary
    covers all images (the reference all_gathers before computing means)."""
    results: List[dict] = []
    for f in sorted(os.listdir(output_dir)):
        if f.startswith("rewards_") and f.endswith(".json"):
            with open(os.path.join(output_dir, f)) as fh:
                results.extend(json.load(fh))
    return results


def score_single_image(
    image_path: str, prompt: str, reward_models: Dict[str, object]
) -> Dict[str, float]:
    """One-shot scoring mode.  An item a model could not score (score
    ``None``) reads 0.0 with success False, as in ``rewards.compute_reward``
    (JAX's ``float(None)`` raises)."""
    from PIL import Image

    arr = np.asarray(Image.open(image_path).convert("RGB"), np.float32) / 255.0
    images = arr[None]
    out: Dict[str, float] = {}
    for name, model in reward_models.items():
        scores, successes = model(images, [prompt])
        failed = scores[0] is None
        out[f"{name}_reward"] = 0.0 if failed else float(scores[0])
        out[f"{name}_success"] = not failed and bool(successes[0])
    return out


def build_models(args) -> Dict[str, object]:
    """The reward models ``args.reward_model`` names, on ``args.device``,
    through ``train.build_reward_models`` (UnifiedReward with 8 workers)."""
    from mixgrpo_tpu_torch.config import RewardConfig, TrainConfig
    from mixgrpo_tpu_torch.train import build_reward_models

    wanted = (["hpsv2", "clip_score", "pick_score", "image_reward"]
              + (["unified_reward"] if args.unified_reward_url else [])
              if args.reward_model == "all" else [args.reward_model])
    cfg = TrainConfig(reward=RewardConfig(
        hps_path=args.hps_path, clip_score_path=args.clip_score_path,
        pick_score_path=args.pick_score_path, image_reward_path=args.image_reward_path,
        image_reward_med_config=args.image_reward_med_config,
        unified_reward_url=args.unified_reward_url, unified_reward_num_workers=8))
    return build_reward_models(cfg, device=args.device, names=wanted, merges=args.clip_bpe_path)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--metadata", type=str, default=None)
    p.add_argument("--image_dir", type=str, default=None)
    p.add_argument("--output_dir", type=str, default=None)
    p.add_argument("--image", type=str, default=None,
                   help="single-image mode: path to one image")
    p.add_argument("--prompt", type=str, default=None,
                   help="single-image mode: its prompt")
    p.add_argument("--reward_model", type=str, default="all",
                   choices=["all", "hpsv2", "clip_score", "pick_score",
                            "image_reward", "unified_reward"])
    p.add_argument("--batch_size", type=int, default=8)
    # checkpoint paths (same flags as the trainer)
    p.add_argument("--hps_path", type=str, default="hps_ckpt/HPS_v2.1_compressed.pt")
    p.add_argument("--clip_score_path", type=str, default="clip_ckpt")
    p.add_argument("--pick_score_path", type=str, default="pickscore_ckpt")
    p.add_argument("--image_reward_path", type=str, default="image_reward_ckpt/ImageReward.pt")
    p.add_argument("--image_reward_med_config", type=str, default=None)
    p.add_argument("--unified_reward_url", type=str, default=None)
    p.add_argument("--clip_bpe_path", type=str, default=os.environ.get("CLIP_BPE_PATH"))
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    single = args.image is not None
    if single and args.prompt is None:
        p.error("--image requires --prompt")
    if not single and not (args.metadata and args.image_dir and args.output_dir):
        p.error("batch mode requires --metadata, --image_dir and --output_dir")

    from mixgrpo_tpu_torch.parallel.mesh import default_device, init_distributed
    from mixgrpo_tpu_torch.utils.logging import process_count, process_index

    if args.device == "cuda":
        args.device = default_device()
    init_distributed(device=args.device)  # no-op for one
    models = build_models(args)
    if single:
        scores = score_single_image(args.image, args.prompt, models)
        main_print(json.dumps(scores, indent=2))
        if args.output_dir:
            os.makedirs(args.output_dir, exist_ok=True)
            with open(os.path.join(args.output_dir, "single_reward.json"), "w") as f:
                json.dump({"image": args.image, "prompt": args.prompt, **scores}, f, indent=2)
        return scores

    entries = load_metadata(args.metadata)
    pi, pc = process_index(), process_count()
    results = evaluate(entries, args.image_dir, models, args.batch_size, pi, pc)
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, f"rewards_{pi}.json"), "w") as f:
        json.dump(results, f, indent=2)
    if pc > 1:
        import torch.distributed as dist

        dist.barrier()  # every shard is on disk before rank 0 summarises
        if pi != 0:
            return None
    summary = summarize(gather_result_shards(args.output_dir))
    with open(os.path.join(args.output_dir, "reward_means.txt"), "w") as f:
        for k, v in summary.items():
            f.write(f"{k}: {v}\n")
    main_print(summary)
    return summary


if __name__ == "__main__":
    main()

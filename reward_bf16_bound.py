#!/usr/bin/env python3
"""The bound that ``chip_smoke.py`` holds each reward model's bf16 scores to.

Runs on the CPU, in the setup of the smoke run's ``rewards`` phase cut in
depth.  For each depth ``L`` of ``DEPTHS`` the four reward checkpoints are
written by ``chip_smoke.write_reward_ckpts`` at ``chip_smoke.reward_geometry()``'s
widths with every tower cut to ``L`` blocks (BLIP's BERT to ``L // 2``: 12
against the ViT's 24), in the smoke run's file dtypes (F16 HPS and
CLIP-score, F32 PickScore and ImageReward).  Each model is loaded from its
file with ``from_checkpoint`` once in bf16 and once in f32, as the smoke run
loads it, so the rounding of the weights to bf16 is part of the difference;
both score ``chip_smoke.smoke_images`` (12 at 720x720) against
``chip_smoke.REWARD_PROMPTS``, and the largest |bf16 - f32| of the scores is
recorded at each depth.  Each block adds its own rounding to the residual
stream, independent of the others', so the difference is taken to grow at
most as the square root of the depth from the deepest depth measured: the
bound at the full depth is ``MARGIN * max_L(err_L) * sqrt(L_full / max(DEPTHS))``.
Prints one JSON line per model and one with the bounds.

Run: ``python reward_bf16_bound.py`` (a few minutes on 8 cores; up to ~3 GB
of files in ``.reward_bound/`` beside the script, which it removes).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys

import torch

MARGIN = 3.0
DEPTHS = (2, 4, 8)
FULL_DEPTH = {"hpsv2": 32, "pick_score": 32, "clip_score": 32, "image_reward": 24}


def cut_geometry(geo, L):
    """``geo`` (``chip_smoke.reward_geometry()``) with every tower cut to
    ``L`` blocks, BLIP's text tower to ``L // 2``."""
    clip = lambda c: dataclasses.replace(c, vision=dataclasses.replace(c.vision, layers=L),
                                         text=dataclasses.replace(c.text, layers=L))
    return {"hps": clip(geo["hps"]), "pick_score": clip(geo["pick_score"]),
            "clip_score": clip(geo["clip_score"]),
            "blip_vision": dataclasses.replace(geo["blip_vision"], layers=L),
            "blip_text": dataclasses.replace(geo["blip_text"], layers=max(L // 2, 1))}


def errors_at_depth(L, images, prompts):
    """max |bf16 - f32| of each model's scores with the towers cut to ``L``."""
    import numpy as np

    import chip_smoke as CS
    from mixgrpo_tpu_torch.rewards import CLIPScoreReward, HPSReward, PickScoreReward
    from mixgrpo_tpu_torch.rewards.image_reward import ImageRewardModel
    from mixgrpo_tpu_torch.train import find_bert_vocab_dir

    geo = cut_geometry(CS.reward_geometry(), L)
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".reward_bound", f"L{L}")
    try:
        paths, _ = CS.write_reward_ckpts(torch, "cpu", geo, d)
        vocab = find_bert_vocab_dir(paths["med_config"], paths["image_reward"])
        build = {
            "hpsv2": lambda dt: HPSReward.from_checkpoint(paths["hps"], paths["merges"],
                                                          device="cpu", dtype=dt),
            "pick_score": lambda dt: PickScoreReward.from_checkpoint(
                paths["pick_score"], paths["merges"], device="cpu", dtype=dt),
            "clip_score": lambda dt: CLIPScoreReward.from_checkpoint(
                paths["clip_score"], paths["merges"], device="cpu", dtype=dt),
            "image_reward": lambda dt: ImageRewardModel.from_checkpoint(
                paths["image_reward"], paths["med_config"], vocab,
                vision_cfg=geo["blip_vision"], device="cpu", dtype=dt),
        }
        out = {}
        for name, make in build.items():
            s16, _ = make(torch.bfloat16)(images, prompts)
            s32, _ = make(torch.float32)(images, prompts)
            out[name] = float(np.abs(np.asarray(s16) - np.asarray(s32)).max())
        return out
    finally:
        shutil.rmtree(os.path.dirname(d), ignore_errors=True)


def main():
    import chip_smoke as CS

    torch.set_num_threads(8)
    prompts = list(CS.REWARD_PROMPTS)
    images = CS.smoke_images(torch, "cpu", len(prompts), 720, 40)
    by_depth = {L: errors_at_depth(L, images, prompts) for L in DEPTHS}
    bounds = {}
    for name, full in FULL_DEPTH.items():
        e = {L: by_depth[L][name] for L in DEPTHS}
        print(json.dumps({"model": name, "max_abs_bf16_vs_f32_by_depth": e}), flush=True)
        bounds[name] = MARGIN * max(e.values()) * (full / max(DEPTHS)) ** 0.5
    print(json.dumps({"margin": MARGIN, "full_depth": FULL_DEPTH, "bounds": bounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

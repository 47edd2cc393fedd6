"""A tiny GRPO cell in a throwaway copy of the benchmark, for the CPU tests:
the same kind, reference and readers at toy widths."""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CONFIG = {
    "attention_head_dim": 32, "axes_dims_rope": [8, 12, 12], "guidance_embeds": True,
    "in_channels": 16, "joint_attention_dim": 64, "num_attention_heads": 4, "num_layers": 1,
    "num_single_layers": 2, "patch_size": 1, "pooled_projection_dim": 32,
    "vae": {"latent_channels": 4, "out_channels": 3, "block_out_channels": [8, 16, 16, 32],
            "layers_per_block": 2, "norm_num_groups": 4, "scaling_factor": 0.3611,
            "shift_factor": 0.1159},
    "reward_model": {"name": "hpsv2", "embed_dim": 16,
                     "vision": {"width": 32, "layers": 2, "heads": 2, "patch": 8,
                                "image_size": 32},
                     "text": {"width": 32, "layers": 2, "heads": 2, "vocab": 600,
                              "context": 16}},
    "dtype": "float32",
    "assumed": {"mlp_ratio": 4.0, "time_freq_dim": 32, "rope_theta": 10000.0, "norm_eps": 1e-6,
                "text_len": 8},
}


TINY_VIDEO_CONFIG = {
    "hidden_size": 96, "heads_num": 4, "mlp_width_ratio": 4, "mm_double_blocks_depth": 1,
    "mm_single_blocks_depth": 2, "patch_size": [1, 2, 2], "in_channels": 4,
    "rope_dim_list": [8, 8, 8], "rope_theta": 256, "text_states_dim": 32,
    "text_states_dim_2": 16, "guidance_embed": True, "refiner_depth": 1,
    "vae": {"latent_channels": 4, "out_channels": 3, "block_out_channels": [8, 8, 16, 16],
            "layers_per_block": 2, "norm_num_groups": 4, "time_compression_ratio": 4,
            "spatial_compression_ratio": 8, "scaling_factor": 0.476986},
    "dtype": "float32", "assumed": {"time_freq_dim": 32, "norm_eps": 1e-6},
}
# the published block count and head size at a toy width, in bf16: deep
# enough that bf16 rounding and the int8 control read as they do at full
# size (PERF.md)
TOY_BF16_CONFIG = dict(TINY_CONFIG, attention_head_dim=128, axes_dims_rope=[16, 56, 56],
                       num_attention_heads=2, num_layers=10, num_single_layers=19,
                       in_channels=64, joint_attention_dim=128, pooled_projection_dim=64,
                       dtype="bfloat16",
                       vae=dict(TINY_CONFIG["vae"], latent_channels=16),
                       assumed=dict(TINY_CONFIG["assumed"], text_len=32, time_freq_dim=256))

# 34 latent columns: the decode tiles in space
TINY_VIDEO_TRAFFIC = {"height": 64, "width": 272, "frames": 9, "steps": 4, "shift": 7.0,
                      "guidance_scale": 6.0, "text_len": 8, "text_tokens": 3, "check_steps": 3}


# the published depth and head size of the video DiT at a toy width, bf16,
# the traffic's 50 steps
TOY_BF16_VIDEO_CONFIG = dict(TINY_VIDEO_CONFIG, hidden_size=256, heads_num=2,
                             mm_double_blocks_depth=10, mm_single_blocks_depth=20,
                             rope_dim_list=[16, 56, 56], refiner_depth=2, in_channels=16,
                             dtype="bfloat16",
                             vae=dict(TINY_VIDEO_CONFIG["vae"], latent_channels=16),
                             assumed=dict(TINY_VIDEO_CONFIG["assumed"], time_freq_dim=256))
TOY_VIDEO_TRAFFIC = dict(TINY_VIDEO_TRAFFIC, width=96, steps=50, check_steps=8, text_len=16,
                         text_tokens=4)


def tiny_traffic(**kw):
    with open(os.path.join(BENCH, "traffic", "grpo-flash-lora.json")) as f:
        t = json.load(f)
    t.update(resolution=64, sampling_steps=8, num_generations=6, rollout_chunk=2,
             gradient_accumulation_steps=2, prompts=3, check_rows=2, check_update_steps=3)
    t["optim"]["learning_rate"] = 1e-3
    t.update(kw)
    return t


def _add(bench_dir, name, config, traffic, kind, metric, limits):
    root = os.path.dirname(bench_dir)
    cfg, tr = name.split(".")[0], name.replace(".", "-")
    with open(os.path.join(bench_dir, "configs", cfg + ".json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(bench_dir, "traffic", tr + ".json"), "w") as f:
        json.dump(traffic, f)
    cell = {"kind": kind, "config": cfg, "traffic": tr, "chips": 1,
            "metric": metric, "limits": limits}
    with open(os.path.join(bench_dir, "cells", name + ".json"), "w") as f:
        json.dump(cell, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": cfg, "source": "toy", "reduced": [], "why": "toy",
                            "file": f"benchmark/configs/{cfg}.json"})
    spec["workloads"].append({"name": name, "config": cfg, "traffic": tr, "chips": 1,
                              "why": "toy"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if metric["name"] in (m["name"], m.get("moves")) and "workloads" in m:
            m["workloads"].append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)


def write_tiny(bench_dir, limits, video_limits=None):
    """Add the tiny GRPO cells ``tiny.grpo`` (f32) and ``toy.grpo`` (bf16, the
    published depth at a toy width, the recipe's 25 steps) and, with
    ``video_limits``, the video cells ``tinyvideo.t2v`` and ``toyvideo.t2v``
    alike, to the copy at ``bench_dir`` and to its ``BENCHMARK.json``."""
    metric = {"name": "grpo_samples_per_s", "form": "work_per_s"}
    _add(bench_dir, "tiny.grpo", TINY_CONFIG, tiny_traffic(), "grpo", metric, limits)
    toy = tiny_traffic(resolution=128, sampling_steps=25, check_update_steps=1)
    toy["optim"]["learning_rate"] = 1e-5
    _add(bench_dir, "toy.grpo", TOY_BF16_CONFIG, toy, "grpo", metric, limits)
    if video_limits is not None:
        metric = {"name": "video_s_per_video", "form": "s_per_unit"}
        _add(bench_dir, "tinyvideo.t2v", TINY_VIDEO_CONFIG, TINY_VIDEO_TRAFFIC, "t2v", metric,
             video_limits)
        _add(bench_dir, "toyvideo.t2v", TOY_BF16_VIDEO_CONFIG, TOY_VIDEO_TRAFFIC, "t2v", metric,
             video_limits)


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of ``BENCHMARK.json`` and the benchmark's folder; returns the folder."""
    dst = tmp_path / "benchmark"
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    return str(dst)

"""HunyuanVideoSampler: the user-facing ``predict`` wrapper.

Port of mixgrpo_tpu/models/hunyuan/sampler.py: the argument checks
(positive sizes, ``(video_length - 1) % 4 == 0``), the reference's seed
fan-out (an int, one per prompt, one per video, or None for random draws),
one ``torch.Generator`` per video seeded with its seed, the default negative
prompt, and a result dict with ``samples`` (numpy (T, H, W, 3) f32 in [0,
1]), ``seeds``, ``prompts`` and ``negative_prompt``.  HunyuanVideo is
guidance-distilled: the negative prompt is carried in the result, and no
classifier-free guidance pass runs.  Each video is one batch-1 call of
``HunyuanVideoPipeline``.  Under sequence parallelism (the pipeline's
``attn_impl="ulysses"`` or ``"ring"``) every rank must draw the same noise,
so ``seed`` must be given: None, which draws seeds at random per process,
is refused there.
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence, Union

import torch

from mixgrpo_tpu_torch.models.hunyuan.pipeline import HunyuanVideoPipeline
from mixgrpo_tpu_torch.models.hunyuan.prompting import NEGATIVE_PROMPT


def _resolve_seeds(seed: Union[None, int, Sequence[int]], batch_size: int,
                   num_videos: int) -> List[int]:
    """The reference's seed fan-out."""
    if seed is None:
        return [random.randint(0, 1_000_000) for _ in range(batch_size * num_videos)]
    if isinstance(seed, int):
        return [seed + i for _ in range(batch_size) for i in range(num_videos)]
    seed = list(seed)
    if len(seed) == batch_size:
        return [int(s) + j for s in seed for j in range(num_videos)]
    if len(seed) == batch_size * num_videos:
        return [int(s) for s in seed]
    raise ValueError(
        f"Length of seed must equal batch_size ({batch_size}) or "
        f"batch_size * num_videos_per_prompt ({batch_size * num_videos}), got {len(seed)}.")


class HunyuanVideoSampler:
    def __init__(self, pipeline: HunyuanVideoPipeline):
        self.pipeline = pipeline
        self.default_negative_prompt = NEGATIVE_PROMPT

    def predict(self, prompt: Union[str, Sequence[str]], height: int = 192, width: int = 336,
                video_length: int = 129, seed: Union[None, int, Sequence[int]] = None,
                negative_prompt: Optional[str] = None, num_videos_per_prompt: int = 1,
                **kwargs) -> dict:
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        if width <= 0 or height <= 0 or video_length <= 0:
            raise ValueError(
                "`height`, `width` and `video_length` must be positive, got "
                f"height={height}, width={width}, video_length={video_length}")
        if (video_length - 1) % 4 != 0:
            raise ValueError(f"`video_length-1` must be a multiple of 4, got {video_length}")
        if negative_prompt is None:
            negative_prompt = self.default_negative_prompt

        if seed is None and self.pipeline.attn_impl in ("ulysses", "ring"):
            raise ValueError("sequence-parallel sampling needs a seed: every rank must draw "
                             "the same noise")
        seeds = _resolve_seeds(seed, len(prompts), num_videos_per_prompt)
        txt, mask, pooled = self.pipeline.encode_prompt(prompts)
        samples, i = [], 0
        for p in range(len(prompts)):
            for _ in range(num_videos_per_prompt):
                gen = torch.Generator(self.pipeline.device).manual_seed(seeds[i])
                out = self.pipeline(txt[p:p + 1], pooled[p:p + 1], video_length=video_length,
                                    height=height, width=width, text_mask=mask[p:p + 1],
                                    generator=gen)
                samples.append(out[0].float().cpu().numpy())
                i += 1
        return {"samples": samples, "seeds": seeds, "prompts": prompts,
                "negative_prompt": negative_prompt}

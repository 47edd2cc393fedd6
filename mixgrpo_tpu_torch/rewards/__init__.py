"""Reward models (mirrors mixgrpo_tpu/rewards/).  Only the CLIP BPE
tokenizer is ported so far; the reward models wait for ROADMAP Queue 1
item 4."""

from mixgrpo_tpu_torch.rewards.tokenizer import CLIPTokenizer

__all__ = ["CLIPTokenizer"]

"""Reward models (port of mixgrpo_tpu/rewards/): JAX's exports, and the CLIP
BPE tokenizer."""

from mixgrpo_tpu_torch.rewards.base import RewardModel, compute_reward
from mixgrpo_tpu_torch.rewards.clip_family import (
    CLIPScoreReward,
    HPSReward,
    PickScoreReward,
)
from mixgrpo_tpu_torch.rewards.tokenizer import CLIPTokenizer
from mixgrpo_tpu_torch.rewards.unified_reward import UnifiedReward

__all__ = [
    "RewardModel",
    "compute_reward",
    "HPSReward",
    "PickScoreReward",
    "CLIPScoreReward",
    "UnifiedReward",
    "CLIPTokenizer",
]

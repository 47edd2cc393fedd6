from mixgrpo_tpu_torch.rl.advantage import (
    global_advantages,
    group_advantages,
    mix_advantages,
    mix_rewards,
)
from mixgrpo_tpu_torch.rl.balance import balance_pos_neg
from mixgrpo_tpu_torch.rl.ppo import PPOConfig, ppo_loss
from mixgrpo_tpu_torch.rl.window import SlidingWindowState

__all__ = [
    "SlidingWindowState",
    "group_advantages",
    "global_advantages",
    "mix_advantages",
    "mix_rewards",
    "ppo_loss",
    "PPOConfig",
    "balance_pos_neg",
]

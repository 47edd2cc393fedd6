"""Group-relative advantage computation and multi-reward mixing.

Port of mixgrpo_tpu/rl/advantage.py, every variant: group, trimmed, global,
weighted mixing of rewards or of advantages, and the success-masked forms the
trainer uses.  Rewards are reshaped to ``(num_groups, group_size)`` and
normalized in one pass.  As in JAX, std uses Bessel's correction (ddof = 1,
torch's ``std`` default); the trimmed variant drops the lowest
``min(int(G * ratio), G - 1)`` rewards of each group and normalizes every
entry by the statistics of the rest.
"""

from __future__ import annotations

from typing import Mapping

import torch


def _std(x, dim=None, keepdim=False):
    """Sample standard deviation (ddof=1)."""
    if dim is None:
        return torch.std(x, unbiased=True)
    return torch.std(x, dim=dim, keepdim=keepdim, unbiased=True)


def _groups(rewards, num_generations):
    n = rewards.shape[0]
    if n % num_generations:
        raise ValueError(f"{n} rewards do not split into groups of {num_generations}")
    return rewards.reshape(-1, num_generations)


def group_advantages(rewards: torch.Tensor, num_generations: int,
                     trimmed_ratio: float = 0.0, eps: float = 1e-8) -> torch.Tensor:
    """Per-group normalized advantages; consecutive blocks of
    ``num_generations`` rewards are one prompt group."""
    g = _groups(rewards, num_generations)
    s = g
    if trimmed_ratio > 0:
        trim = min(int(num_generations * trimmed_ratio), num_generations - 1)
        s = torch.sort(g, dim=1).values[:, trim:]
    mean = s.mean(dim=1, keepdim=True)
    std = _std(s, dim=1, keepdim=True) + eps
    return ((g - mean) / std).reshape(rewards.shape[0])


def global_advantages(rewards: torch.Tensor, gathered_rewards: torch.Tensor,
                      eps: float = 1e-8) -> torch.Tensor:
    """Non-group advantages against the statistics of all gathered rewards."""
    return (rewards - gathered_rewards.mean()) / (_std(gathered_rewards) + eps)


def mix_advantages(rewards_dict: Mapping[str, torch.Tensor], weights: Mapping[str, float],
                   num_generations: int, trimmed_ratio: float = 0.0) -> torch.Tensor:
    """``advantage_aggr`` mixing: weighted sum of per-model group advantages."""
    if not rewards_dict:
        raise ValueError("empty rewards_dict")
    return sum(group_advantages(r, num_generations, trimmed_ratio)
               * float(weights.get(name, 1.0)) for name, r in rewards_dict.items())


def mix_rewards(rewards_dict: Mapping[str, torch.Tensor],
                weights: Mapping[str, float]) -> torch.Tensor:
    """``reward_aggr`` mixing: weighted sum of raw per-model rewards."""
    if not rewards_dict:
        raise ValueError("empty rewards_dict")
    return sum(r * float(weights.get(name, 1.0)) for name, r in rewards_dict.items())


def masked_group_advantages(rewards: torch.Tensor, successes: torch.Tensor,
                            num_generations: int, trimmed_ratio: float = 0.0,
                            eps: float = 1e-8) -> torch.Tensor:
    """Per-group advantages with a per-sample success mask: failed samples
    (success 0) are left out of the group's mean and std and get advantage
    0; with every sample successful this is ``group_advantages``."""
    n, G = rewards.shape[0], num_generations
    g = _groups(rewards, G)
    s = successes.reshape(-1, G).to(rewards.dtype)
    if trimmed_ratio > 0:
        trim = min(int(G * trimmed_ratio), G - 1)
        # failures sorted to the top: positions [trim, k) of the ascending
        # order are the surviving successful entries (k = successes)
        big = torch.where(s > 0, g, torch.full_like(g, float("inf")))
        order = torch.argsort(big, dim=1, stable=True)
        sv = torch.gather(g, 1, order)
        k = s.sum(dim=1, keepdim=True)
        pos = torch.arange(G, device=g.device)[None, :]
        w = ((pos >= trim) & (pos < k)).to(rewards.dtype)
    else:
        sv, w = g, s
    cnt = w.sum(dim=1, keepdim=True)
    mean = (sv * w).sum(dim=1, keepdim=True) / cnt.clamp_min(1.0)
    var = (w * (sv - mean) ** 2).sum(dim=1, keepdim=True) / (cnt - 1.0).clamp_min(1.0)
    std = torch.sqrt(var) + eps
    return (s * (g - mean) / std).reshape(n)


def masked_mix_advantages(rewards_dict: Mapping[str, torch.Tensor],
                          successes_dict: Mapping[str, torch.Tensor],
                          weights: Mapping[str, float], num_generations: int,
                          trimmed_ratio: float = 0.0) -> torch.Tensor:
    """``advantage_aggr`` mixing with success masks: per sample, the weighted
    sum over the models that succeeded on it, rescaled to the full weight
    total."""
    if not rewards_dict:
        raise ValueError("empty rewards_dict")
    total_w = sum(float(weights.get(n, 1.0)) for n in rewards_dict)
    num = den = 0.0
    for name, r in rewards_dict.items():
        w = float(weights.get(name, 1.0))
        s = successes_dict[name].to(r.dtype)
        num = num + masked_group_advantages(r, s, num_generations, trimmed_ratio) * w
        den = den + s * w
    return num / den.clamp_min(1e-8) * total_w


def masked_mix_rewards(rewards_dict: Mapping[str, torch.Tensor],
                       successes_dict: Mapping[str, torch.Tensor],
                       weights: Mapping[str, float]) -> torch.Tensor:
    """Weighted reward mixing with per-model success masks: failed scores are
    dropped from each sample's weighted mean, rescaled to the full weight
    total."""
    if not rewards_dict:
        raise ValueError("empty rewards_dict")
    total_w = sum(float(weights.get(n, 1.0)) for n in rewards_dict)
    num = den = 0.0
    for name, r in rewards_dict.items():
        w = float(weights.get(name, 1.0))
        s = successes_dict[name].to(r.dtype)
        num = num + r * s * w
        den = den + s * w
    return num / den.clamp_min(1e-8) * total_w

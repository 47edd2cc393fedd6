"""PPO-style clipped policy loss over per-step SDE log-probs.

Port of mixgrpo_tpu/rl/ppo.py:

  ratio       = exp(new_logp - old_logp)
  policy_loss = mean(max(-A * ratio, -A * clip(ratio, 1-c, 1+c)))
  kl_loss     = 0.5 * mean((new_logp - old_logp)^2)
  loss        = policy_loss + kl_coeff * kl_loss
  clip_frac   = mean(|ratio - 1| > c)

Advantages are clamped to +-adv_clip_max first; ``loss_scale`` multiplies
both loss terms.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    clip_range: float = 1e-4
    adv_clip_max: float = 5.0
    kl_coeff: float = 0.0


def ppo_loss(new_log_probs: torch.Tensor, old_log_probs: torch.Tensor,
             advantages: torch.Tensor, cfg: PPOConfig, loss_scale: float = 1.0,
             mask: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Clipped PPO loss; ``advantages`` broadcast to the log-probs' shape,
    ``mask`` (optional) restricts every mean to the unmasked entries.
    Returns (loss, metrics) with 0-dim tensors."""
    adv = torch.clamp(advantages, -cfg.adv_clip_max, cfg.adv_clip_max)
    adv = torch.broadcast_to(adv, new_log_probs.shape)
    diff = new_log_probs - old_log_probs
    ratio = torch.exp(diff)
    unclipped = -adv * ratio
    clipped = -adv * torch.clamp(ratio, 1.0 - cfg.clip_range, 1.0 + cfg.clip_range)
    per_elem_policy = torch.maximum(unclipped, clipped)
    per_elem_kl = 0.5 * diff * diff
    clip_ind = ((ratio - 1.0).abs() > cfg.clip_range).float()

    if mask is not None:
        m = torch.broadcast_to(mask, new_log_probs.shape).float()
        denom = m.sum().clamp_min(1.0)
        mean = lambda x: (x * m).sum() / denom
    else:
        mean = torch.mean

    policy_loss = mean(per_elem_policy) * loss_scale
    kl_loss = mean(per_elem_kl) * loss_scale
    loss = policy_loss + cfg.kl_coeff * kl_loss
    metrics = {
        "loss": loss,
        "policy_loss": policy_loss,
        "kl_loss": kl_loss,
        "clip_frac": mean(clip_ind),
        "ratio_mean": mean(ratio),
    }
    return loss, metrics

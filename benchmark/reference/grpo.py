"""MixGRPO's sampler steps and update rule in plain PyTorch and NumPy.

From the MixGRPO paper and recipe (arXiv:2507.21802;
``scripts/finetune/finetune_flux_grpo_MixGRPO.sh``) and the methods it
builds on:

- the SD3-shifted sigma schedule and MixGRPO-Flash's "post" compression of
  the ODE tail after the SDE window;
- Flow-GRPO's SDE step on a rectified flow (arXiv:2505.05470, eq. 8-9) with
  its Gaussian log-probability, averaged over the latent's entries;
- multistep DPM-Solver++ (arXiv:2211.01095), second order, midpoint form, in
  the flow convention alpha = 1 - sigma, on the tail;
- GRPO's group-normalised advantages (sample std), PPO's clipped surrogate
  (arXiv:1707.06347), a global-norm gradient clip and AdamW
  (arXiv:1711.05101) with bias correction.
"""

from __future__ import annotations

import math

import numpy as np
import torch

LOG_SQRT_2PI = 0.5 * math.log(2 * math.pi)
EPS = 1e-7


def sd3_shift(t, shift):
    return shift * t / (1 + (shift - 1) * t)


def flash_schedule(steps: int, shift: float, window, compress: float):
    """(sigmas, num_steps) of a MixGRPO-Flash rollout: the shifted schedule
    up to the end of the SDE ``window``, then ``int(max((steps - last) *
    compress, 1))`` points from the unshifted time after the window down to
    0, shifted again."""
    t = np.linspace(1.0, 0.0, steps + 1, dtype=np.float64)
    base = sd3_shift(t, shift).astype(np.float32)
    last = int(max(window))
    n_post = int(max((steps - last) * compress, 1))
    post = sd3_shift(np.linspace(t[last + 1], 0.0, n_post, dtype=np.float64), shift)
    sig = np.concatenate([base[:last + 1], post.astype(np.float32)])
    return sig, len(sig) - 1


def model_time(sigma: torch.Tensor) -> torch.Tensor:
    """The DiT's input time: sigma floored to a thousandth."""
    return torch.floor(sigma * 1000.0) / 1000.0


def gaussian_log_prob(x, mean, std):
    ll = -((x - mean) ** 2) / (2 * std * std) - torch.log(std) - LOG_SQRT_2PI
    return ll.mean(dim=tuple(range(1, x.ndim)))


def sde_mean_std(v, z, sigma, sigma_next, sigma_max, eta):
    """Flow-GRPO's transition z -> N(mean, std^2): the flow ODE's drift plus
    the score correction of noise level ``eta``; at sigma = 1 the noise
    scale uses ``sigma_max`` (the schedule's second point) in place of 1."""
    dt = sigma_next - sigma
    std_t = torch.sqrt(sigma / (1 - (sigma_max if float(sigma) == 1.0 else sigma))) * eta
    mean = z * (1 + std_t ** 2 / (2 * sigma) * dt) \
        + v * (1 + std_t ** 2 * (1 - sigma) / (2 * sigma)) * dt
    return mean, std_t * torch.sqrt(-dt)


def _lam(s):
    s = torch.clamp(s, EPS, 1 - EPS)
    return torch.log1p(-s) - torch.log(s)


def dpmpp_ode(z, x0_now, x0_prev, s_next, s_now, s_prev):
    """One DPM-Solver++ ODE step from ``s_now`` to ``s_next``: first order
    when ``x0_prev`` is None, else the second-order midpoint step that takes
    the previous x0 prediction (at ``s_prev``) too."""
    a_t = 1 - s_next
    h = _lam(s_next) - _lam(s_now)
    em1 = torch.exp(-h) - 1
    out = (s_next / s_now) * z - a_t * em1 * x0_now
    if x0_prev is not None:
        r0 = (_lam(s_now) - _lam(s_prev)) / h
        out = out - 0.5 * a_t * em1 * (x0_now - x0_prev) / r0
    return out


def group_advantages(rewards: np.ndarray, group: int, eps: float = 1e-8) -> np.ndarray:
    g = np.asarray(rewards, np.float64).reshape(-1, group)
    return ((g - g.mean(1, keepdims=True)) / (g.std(1, ddof=1, keepdims=True) + eps)).reshape(-1)


def ppo_terms(new_lp, old_lp, adv, clip_range, adv_max):
    """Per-pair clipped surrogate max(-A r, -A clip(r, 1 - c, 1 + c))."""
    adv = torch.clamp(adv, -adv_max, adv_max)
    ratio = torch.exp(new_lp - old_lp)
    return torch.maximum(-adv * ratio, -adv * torch.clamp(ratio, 1 - clip_range, 1 + clip_range))


class AdamW:
    """AdamW with a global-norm clip applied first (the clip scales by
    max_norm / norm only when norm >= max_norm)."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                 max_norm=1.0):
        self.params = params
        self.lr, self.betas, self.eps = lr, betas, eps
        self.wd, self.max_norm = weight_decay, max_norm
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        """Returns the clipped gradients the moments took."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
        if float(norm) >= self.max_norm:
            grads = [g * (self.max_norm / norm).to(g.dtype) for g in grads]
        self.t += 1
        b1, b2 = self.betas
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            p.mul_(1 - self.lr * self.wd)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            den = (v / (1 - b2 ** self.t)).sqrt().add_(self.eps)
            p.addcdiv_(m, den, value=-self.lr / (1 - b1 ** self.t))
        return grads

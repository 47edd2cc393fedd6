"""Flow-matching ODE/SDE step functions with Gaussian log-probs.

Port of mixgrpo_tpu/solvers/steps.py:
  - ``flow_grpo_step``  — Flow-GRPO SDE step;
  - ``dance_grpo_step`` — DanceGRPO score-function SDE step;
  - ``gaussian_log_prob`` — per-sample diagonal-Gaussian log-density averaged
    over all non-batch dims.
As in JAX, both branches are computed and the ODE/SDE choice (a bool or a
bool tensor) selects between them, and ``dance_grpo_step``'s log-prob keeps
the Gaussian normalization constants.
"""

from __future__ import annotations

import math

import torch

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def _mean_over_nonbatch(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=tuple(range(1, x.ndim)))


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _flag(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.bool, device=like.device)


def gaussian_log_prob(sample, mean, total_std):
    """Diagonal Gaussian log-density of ``sample`` ~ N(mean, total_std^2),
    averaged over the non-batch dims."""
    var = total_std * total_std
    ll = -((sample - mean) ** 2) / (2.0 * var) - torch.log(total_std) - _LOG_SQRT_2PI
    return _mean_over_nonbatch(ll)


def flow_grpo_step(
    model_output,
    latents,
    eta: float,
    sigma,
    sigma_prev,
    sigma_max,
    noise=None,
    prev_sample=None,
    deterministic=False,
):
    """Flow-GRPO SDE step.

      dt        = sigma_prev - sigma                        (negative)
      x0        = x - sigma * v
      std_t     = eta * sqrt(sigma / (1 - sigma'))          sigma'=sigma_max if sigma==1
      mean      = x*(1 + std_t^2/(2 sigma) dt) + v*(1 + std_t^2 (1-sigma)/(2 sigma)) dt
      x_next    = mean + std_t * sqrt(-dt) * noise          (SDE)
      x_next    = x + dt * v                                (deterministic ODE)
      log_prob  = N(x_next | mean, (std_t sqrt(-dt))^2)     averaged over dims
    """
    sigma = _scalar(sigma, latents)
    sigma_prev = _scalar(sigma_prev, latents)
    sigma_max = _scalar(sigma_max, latents)
    dt = sigma_prev - sigma

    x0_pred = latents - sigma * model_output

    denom = 1.0 - torch.where(sigma == 1.0, sigma_max, sigma)
    std_t = torch.sqrt(sigma / denom) * eta
    total_std = std_t * torch.sqrt(-dt)

    mean = latents * (1.0 + std_t**2 / (2.0 * sigma) * dt) + model_output * (
        1.0 + std_t**2 * (1.0 - sigma) / (2.0 * sigma)
    ) * dt

    if prev_sample is None:
        if noise is None:
            raise ValueError("need noise when prev_sample is not given")
        sde_next = mean + total_std * noise
        ode_next = latents + dt * model_output
        next_latents = torch.where(_flag(deterministic, latents), ode_next, sde_next)
    else:
        next_latents = prev_sample

    log_prob = gaussian_log_prob(next_latents, mean, total_std)
    return next_latents, x0_pred, log_prob, mean, total_std


def dance_grpo_step(
    model_output,
    latents,
    eta: float,
    sigma,
    sigma_prev,
    noise=None,
    prev_sample=None,
    sde=True,
):
    """DanceGRPO score-function SDE step.

      dsigma    = sigma_prev - sigma                        (negative)
      mean      = x + dsigma * v
      x0        = x - sigma * v
      std_t     = eta * sqrt(-dsigma)
      if sde:   score = -(x - x0*(1-sigma)) / sigma^2
                mean += (-0.5 eta^2 score) * dsigma
      x_next    = mean + std_t * noise  (sde) | mean  (ode)
      log_prob  = N(x_next | mean, std_t^2)
    """
    sigma = _scalar(sigma, latents)
    sigma_prev = _scalar(sigma_prev, latents)
    sde = _flag(sde, latents)
    dsigma = sigma_prev - sigma

    ode_mean = latents + dsigma * model_output
    x0_pred = latents - sigma * model_output

    std_t = eta * torch.sqrt(sigma - sigma_prev)

    score = -(latents - x0_pred * (1.0 - sigma)) / (sigma**2)
    sde_mean = ode_mean + (-0.5 * eta**2 * score) * dsigma
    mean = torch.where(sde, sde_mean, ode_mean)

    if prev_sample is None:
        if noise is None:
            raise ValueError("need noise when prev_sample is not given")
        next_latents = torch.where(sde, mean + std_t * noise, mean)
    else:
        next_latents = prev_sample

    # guard the log against std_t == 0 on a pure-ODE step
    safe_std = torch.where(std_t > 0, std_t, torch.ones_like(std_t))
    log_prob = gaussian_log_prob(next_latents, mean, safe_std)
    return next_latents, x0_pred, log_prob

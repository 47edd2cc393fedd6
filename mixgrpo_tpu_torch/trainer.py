"""GRPO policy-update step: recomputed log-probs + clipped PPO loss + AdamW.

Port of mixgrpo_tpu/trainer.py.  All (sample, timestep) pairs of an
accumulation group are batched into one forward and backward (the same
gradient as the reference's per-pair loop, whose per-pair normalization
telescopes to a mean over the group), then one optimizer step.

JAX's functions are pure and jitted, with donated buffers; here they update
the parameter tensors and the optimizer state in place and return them, so
callers keep JAX's ``params, opt_state, metrics = update_step(...)`` form.

The optimizer is optax's ``chain(clip_by_global_norm(max_grad_norm),
adamw(schedule, b1=0.9, b2=0.999, eps=1e-8, weight_decay))`` on
``torch.optim.AdamW`` (the same update: decoupled decay scaled by the rate,
eps outside the square root, bias correction from step 1):
  - the clip is optax's: grads * max_norm / norm only when norm >= max_norm
    (``clip_grad_norm_`` adds 1e-6 to the norm and is not used);
  - the rate follows optax's count: the first update uses ``schedule(0)``, so
    ``constant_with_warmup`` with warmup > 0 makes the first step a no-op
    (the moments still move);
  - ``grad_norm`` is reported before clipping.
LoRA (``make_lora_update_fns``) and the DPM-Solver "all" log-prob wait for
the ports of lora.py and solvers/dpm.py.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Sequence

import torch

from mixgrpo_tpu_torch.models.flux.model import FluxConfig, flux_forward, param_leaves
from mixgrpo_tpu_torch.rl.ppo import PPOConfig, ppo_loss
from mixgrpo_tpu_torch.sampler import quantized_timestep
from mixgrpo_tpu_torch.solvers.rollout import SamplerConfig
from mixgrpo_tpu_torch.solvers.steps import dance_grpo_step, flow_grpo_step


class UpdateBatch(NamedTuple):
    """One accumulation group of (sample, window-timestep) pairs: N
    independent rows."""

    latents: torch.Tensor  # (N, L, C) latent before step t
    next_latents: torch.Tensor  # (N, L, C) stored latent after step t
    t_index: torch.Tensor  # (N,) int step index into sigmas
    old_log_probs: torch.Tensor  # (N,)
    advantages: torch.Tensor  # (N,)
    txt: torch.Tensor  # (N, Lt, context_dim)
    pooled: torch.Tensor  # (N, pooled_dim)


def recompute_log_prob(sampler_cfg: SamplerConfig, pred, latents, next_latents, sigmas,
                       t_index):
    """Per-row SDE log-prob of stored transitions given a fresh prediction."""
    if sampler_cfg.use_dpm and sampler_cfg.dpm_apply_strategy != "post":
        raise NotImplementedError("the DPM-Solver 'all' log-prob waits for the port of "
                                  "solvers/dpm.py")
    shape = (-1,) + (1,) * (latents.ndim - 1)
    sig = sigmas[t_index].reshape(shape)
    sig_prev = sigmas[t_index + 1].reshape(shape)
    if sampler_cfg.flow_grpo_sampling:
        _, _, log_prob, _, _ = flow_grpo_step(
            pred, latents, sampler_cfg.eta, sig, sig_prev, sigmas[1],
            prev_sample=next_latents, deterministic=False)
    else:
        _, _, log_prob = dance_grpo_step(pred, latents, sampler_cfg.eta, sig, sig_prev,
                                         prev_sample=next_latents, sde=True)
    return log_prob


# ----------------------------------------------------------------------------
# optimizer
# ----------------------------------------------------------------------------


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, in f32 (optax.global_norm)."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


@dataclasses.dataclass
class Optimizer:
    """Global-norm clip + Adam(W) with a schedule counted as optax counts.

    ``init(params)`` makes the state, a ``torch.optim`` optimizer over the
    parameter tree's tensors whose first param group also keeps ``count``
    (the number of updates applied, saved with its ``state_dict``);
    ``apply(state, grads)`` clips, sets the rate to ``schedule(count)`` and
    steps."""

    schedule: Callable[[int], float]
    weight_decay: float = 1e-4
    max_grad_norm: float = 1.0
    decoupled: bool = True  # AdamW; False = Adam without decay

    def init(self, params) -> torch.optim.Optimizer:
        leaves = param_leaves(params)
        if self.decoupled:
            opt = torch.optim.AdamW(leaves, lr=float(self.schedule(0)), betas=(0.9, 0.999),
                                    eps=1e-8, weight_decay=self.weight_decay)
        else:
            opt = torch.optim.Adam(leaves, lr=float(self.schedule(0)), betas=(0.9, 0.999),
                                   eps=1e-8)
        opt.param_groups[0]["count"] = 0
        return opt

    @torch.no_grad()
    def apply(self, state: torch.optim.Optimizer, grads: Sequence[torch.Tensor]):
        """One update with ``grads`` (in the order of the state's params);
        returns their global norm before clipping."""
        group = state.param_groups[0]
        norm = global_norm(grads)
        if float(norm) >= self.max_grad_norm:  # optax: where(norm < max, g, g / norm * max)
            grads = [g / norm * self.max_grad_norm for g in grads]
        for p, g in zip(group["params"], grads):
            p.grad = g.to(p.dtype)
        count = group["count"]
        group["lr"] = float(self.schedule(count))
        state.step()
        group["count"] = count + 1
        for p in group["params"]:
            p.grad = None
        return norm


def _polynomial(init, end, power, steps):
    """optax.polynomial_schedule."""
    def sched(count):
        c = min(max(count, 0), steps)
        return (init - end) * (1 - c / steps) ** power + end
    return sched


def _cosine(init, steps):
    """optax.cosine_decay_schedule with alpha 0."""
    def sched(count):
        c = min(count, steps)
        return init * 0.5 * (1 + math.cos(math.pi * c / steps))
    return sched


def _join(schedules, boundaries):
    """optax.join_schedules: schedule i from boundary i - 1 on, counted from
    that boundary."""
    def sched(count):
        out = schedules[0](count)
        for b, s in zip(boundaries, schedules[1:]):
            if count >= b:
                out = s(count - b)
        return out
    return sched


def make_schedule(learning_rate: float = 1e-5, lr_scheduler: str = "constant_with_warmup",
                  warmup_steps: int = 0, total_steps: int = 300, lr_num_cycles: int = 1,
                  lr_power: float = 1.0) -> Callable[[int], float]:
    """The learning rate of update ``count`` (0 for the first), as optax's
    schedules in mixgrpo_tpu/trainer.py::make_optimizer give it."""
    lr = learning_rate
    if lr_scheduler == "constant" or (lr_scheduler == "constant_with_warmup"
                                      and warmup_steps <= 0):
        return lambda count: lr
    if lr_scheduler == "constant_with_warmup":
        return _join([_polynomial(0.0, lr, 1.0, warmup_steps), lambda count: lr],
                     [warmup_steps])
    if lr_scheduler == "linear":
        return _polynomial(lr, 0.0, 1.0, total_steps)
    if lr_scheduler == "cosine":
        return _cosine(lr, total_steps)
    if lr_scheduler == "cosine_with_restarts":
        per = max(total_steps // max(lr_num_cycles, 1), 1)
        return _join([_cosine(lr, per)] * lr_num_cycles,
                     [per * i for i in range(1, lr_num_cycles)])
    if lr_scheduler == "polynomial":
        return _polynomial(lr, 0.0, lr_power, total_steps)
    raise ValueError(f"unknown lr_scheduler {lr_scheduler}")


def make_optimizer(learning_rate: float = 1e-5, weight_decay: float = 1e-4,
                   max_grad_norm: float = 1.0, lr_scheduler: str = "constant_with_warmup",
                   warmup_steps: int = 0, total_steps: int = 300, lr_num_cycles: int = 1,
                   lr_power: float = 1.0) -> Optimizer:
    """AdamW + global-norm clip + HF-style LR schedules (the reference's
    betas (0.9, 0.999) and eps 1e-8)."""
    return Optimizer(make_schedule(learning_rate, lr_scheduler, warmup_steps, total_steps,
                                   lr_num_cycles, lr_power),
                     weight_decay=weight_decay, max_grad_norm=max_grad_norm)


def get_optimizer(name: str = "adamw", learning_rate: float = 1e-5,
                  weight_decay: float = 1e-4, max_grad_norm: float = 1.0,
                  **kw) -> Optimizer:
    """Optimizer factory: ``adamw`` (with the schedules) or ``adam`` (a
    constant rate, no decay), both behind the global-norm clip."""
    if name == "adamw":
        return make_optimizer(learning_rate=learning_rate, weight_decay=weight_decay,
                              max_grad_norm=max_grad_norm, **kw)
    if name == "adam":
        return Optimizer(lambda count: learning_rate, weight_decay=0.0,
                         max_grad_norm=max_grad_norm, decoupled=False)
    raise ValueError(f"optimizer {name!r} not supported (use adam/adamw)")


# ----------------------------------------------------------------------------
# update functions
# ----------------------------------------------------------------------------


def make_update_fns(flux_cfg: FluxConfig, sampler_cfg: SamplerConfig, ppo_cfg: PPOConfig,
                    optimizer: Optimizer, rope_cos, rope_sin, *,
                    guidance_scale: float = 3.5, dtype=torch.bfloat16,
                    attn_impl: str = "auto", remat="dots", loss_scale: float = 1.0,
                    virtual_depth=None):
    """``(update_step, accum_step, apply_step)``:

    ``update_step(params, opt_state, batch, sigmas) -> (params, opt_state,
    metrics)``; ``accum_step(params, grad_acc, batch, sigmas, weight) ->
    (grad_acc, metrics)`` adds ``weight``-scaled grads without applying;
    ``apply_step(params, opt_state, grad_acc) -> (params, opt_state,
    zeroed grad_acc, its global norm)``.  ``virtual_depth`` is the benchmark
    aid of ``flux_forward``.  Metrics are 0-dim tensors."""

    def loss_fn(params, batch: UpdateBatch, sigmas):
        N = batch.latents.shape[0]
        t = quantized_timestep(sigmas[batch.t_index])
        g = torch.full((N,), guidance_scale, dtype=torch.float32, device=t.device)
        pred = flux_forward(params, flux_cfg, batch.latents.to(dtype), batch.txt,
                            batch.pooled, t, g, rope_cos, rope_sin, dtype=dtype,
                            attn_impl=attn_impl, remat=remat, virtual_depth=virtual_depth)
        new_lp = recompute_log_prob(sampler_cfg, pred, batch.latents.float(),
                                    batch.next_latents.float(), sigmas, batch.t_index)
        return ppo_loss(new_lp, batch.old_log_probs, batch.advantages, ppo_cfg,
                        loss_scale=loss_scale)

    def grads_of(params, batch, sigmas):
        leaves = [t.requires_grad_(True) for t in param_leaves(params)]
        with torch.enable_grad():
            loss, metrics = loss_fn(params, batch, sigmas)
            grads = torch.autograd.grad(loss, leaves)
        return grads, {k: v.detach() for k, v in metrics.items()}

    def update_step(params, opt_state, batch: UpdateBatch, sigmas):
        grads, metrics = grads_of(params, batch, sigmas)
        metrics["grad_norm"] = optimizer.apply(opt_state, grads)
        return params, opt_state, metrics

    @torch.no_grad()
    def accum_step(params, grad_acc, batch: UpdateBatch, sigmas, weight):
        grads, metrics = grads_of(params, batch, sigmas)
        for a, g in zip(param_leaves(grad_acc), grads):
            a.add_(g * weight)
        return grad_acc, metrics

    @torch.no_grad()
    def apply_step(params, opt_state, grad_acc):
        acc = param_leaves(grad_acc)
        norm = optimizer.apply(opt_state, acc)  # done with the grads once it returns
        for a in acc:
            a.zero_()
        return params, opt_state, grad_acc, norm

    return update_step, accum_step, apply_step


def build_update_batch(rollout_latents, rollout_log_probs, advantages, txt, pooled,
                       sample_idx, t_idx) -> UpdateBatch:
    """Gather (sample, timestep) pairs into one batched update group:
    ``rollout_latents`` (B, T+1, L, C), ``rollout_log_probs`` (B, T),
    ``advantages`` (B,), ``txt`` (B, Lt, D), ``pooled`` (B, P); pair n
    trains timestep ``t_idx[n]`` of sample ``sample_idx[n]``."""
    dev = rollout_latents.device
    sample_idx = torch.as_tensor(sample_idx, dtype=torch.long, device=dev)
    t_idx = torch.as_tensor(t_idx, dtype=torch.long, device=dev)
    return UpdateBatch(
        latents=rollout_latents[sample_idx, t_idx],
        next_latents=rollout_latents[sample_idx, t_idx + 1],
        t_index=t_idx,
        old_log_probs=rollout_log_probs[sample_idx, t_idx],
        advantages=torch.as_tensor(advantages, device=dev)[sample_idx],
        txt=txt[sample_idx],
        pooled=pooled[sample_idx],
    )

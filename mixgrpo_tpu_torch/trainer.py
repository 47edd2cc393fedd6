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
``make_lora_update_fns`` differentiates the factors of a LoRA adapter only,
through the same loss: the base stays frozen (no grad is kept for it) and
each factor merges into its weight inside the block that uses it
(``lora.lora_blocks``).

On a mesh (``mesh=``, ``parallel/``) each rank computes the loss of its own
rows, and its parameters are its shards of the tree
(``parallel.sharding``): the forward gathers them where they are used, the
gradients are averaged over the batch ranks (dp x fsdp) so that the loss is
the mean over the update group's global rows, as in JAX, the global norm
sums the shards' squares over ``fsdp`` (so every rank takes the same clip
decision), AdamW steps each rank's shards, and the metrics are the batch
ranks' mean.  The LoRA update keeps its base and factors whole on every rank
and averages the factors' gradients over the batch ranks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from mixgrpo_tpu_torch.lora import lora_blocks
from mixgrpo_tpu_torch.models.flux.model import FluxConfig, flux_forward, param_leaves
from mixgrpo_tpu_torch.parallel.collectives import all_reduce_
from mixgrpo_tpu_torch.parallel.sharding import flatten_specs, fsdp_view, reduce_grads
from mixgrpo_tpu_torch.rl.ppo import PPOConfig, ppo_loss
from mixgrpo_tpu_torch.sampler import quantized_timestep
from mixgrpo_tpu_torch.solvers import dpm as dpm_mod
from mixgrpo_tpu_torch.solvers.rollout import SamplerConfig
from mixgrpo_tpu_torch.solvers.steps import (
    dance_grpo_step, flow_grpo_step, gaussian_log_prob,
)


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
    """Per-row SDE log-prob of stored transitions given a fresh prediction:
    the window's SDE step (no DPM, or DPM "post"), or for DPM "all" the
    first-order DPM-Solver step with no multistep state."""
    shape = (-1,) + (1,) * (latents.ndim - 1)
    sig = sigmas[t_index].reshape(shape)
    sig_prev = sigmas[t_index + 1].reshape(shape)
    if sampler_cfg.use_dpm and sampler_cfg.dpm_apply_strategy == "all":
        x0 = dpm_mod.convert_model_output(pred, latents, sig)
        mean, _, std, dts = dpm_mod._first_order(sampler_cfg.dpm_algorithm_type, latents, x0,
                                                 sig_prev, sig)
        return gaussian_log_prob(next_latents, mean, torch.clamp(std * dts, min=1e-7))
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


def global_norm(tensors: Sequence[torch.Tensor], mesh=None,
                sharded: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, in f32 (optax.global_norm).
    On a mesh, the tensors flagged in ``sharded`` are this rank's fsdp
    shards: their squares are summed over the fsdp group, and the others
    (whole on every rank) are counted once."""
    if mesh is None or mesh.size("fsdp") == 1 or not any(sharded or ()):
        return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))
    sq = [(t.float() ** 2).sum() for t in tensors]
    zero = torch.zeros((), dtype=torch.float32, device=tensors[0].device)
    own = sum((q for q, s in zip(sq, sharded) if s), zero)
    whole = sum((q for q, s in zip(sq, sharded) if not s), zero)
    return torch.sqrt(all_reduce_(own, mesh, "fsdp") + whole)


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
    def apply(self, state: torch.optim.Optimizer, grads: Sequence[torch.Tensor], *,
              mesh=None, sharded: Optional[Sequence[bool]] = None):
        """One update with ``grads`` (in the order of the state's params);
        returns their global norm before clipping (``global_norm``'s
        ``mesh`` and ``sharded``)."""
        group = state.param_groups[0]
        norm = global_norm(grads, mesh, sharded)
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


def _make_grads_of(flux_cfg: FluxConfig, sampler_cfg: SamplerConfig, ppo_cfg: PPOConfig,
                   rope_cos, rope_sin, guidance_scale, dtype, attn_impl, remat, loss_scale,
                   virtual_depth):
    """``grads_of(params, leaves, batch, sigmas, block_params=None) ->
    (grads, metrics)``: the PPO loss of the forward on ``params`` (with
    ``flux_forward``'s ``block_params``), differentiated with respect to
    ``leaves``, tensors with ``requires_grad`` that ``params`` is built
    from."""

    def loss_fn(params, batch: UpdateBatch, sigmas, block_params):
        N = batch.latents.shape[0]
        t = quantized_timestep(sigmas[batch.t_index])
        g = torch.full((N,), guidance_scale, dtype=torch.float32, device=t.device)
        pred = flux_forward(params, flux_cfg, batch.latents.to(dtype), batch.txt,
                            batch.pooled, t, g, rope_cos, rope_sin, dtype=dtype,
                            attn_impl=attn_impl, remat=remat, virtual_depth=virtual_depth,
                            block_params=block_params)
        new_lp = recompute_log_prob(sampler_cfg, pred, batch.latents.float(),
                                    batch.next_latents.float(), sigmas, batch.t_index)
        return ppo_loss(new_lp, batch.old_log_probs, batch.advantages, ppo_cfg,
                        loss_scale=loss_scale)

    def grads_of(params, leaves, batch, sigmas, block_params=None):
        with torch.enable_grad():
            loss, metrics = loss_fn(params, batch, sigmas, block_params)
            grads = torch.autograd.grad(loss, leaves)
        return grads, {k: v.detach() for k, v in metrics.items()}

    return grads_of


def _batch_mean(metrics, mesh):
    """The metrics' mean over the batch ranks (one all-reduce)."""
    if mesh is None or mesh.batch_size == 1:
        return metrics
    keys = sorted(metrics)
    flat = torch.stack([metrics[k].float() for k in keys])
    all_reduce_(flat, mesh, "batch")
    return dict(zip(keys, (flat / mesh.batch_size).unbind(0)))


def make_update_fns(flux_cfg: FluxConfig, sampler_cfg: SamplerConfig, ppo_cfg: PPOConfig,
                    optimizer: Optimizer, rope_cos, rope_sin, *,
                    guidance_scale: float = 3.5, dtype=torch.bfloat16,
                    attn_impl: str = "auto", remat="dots", loss_scale: float = 1.0,
                    virtual_depth=None, mesh=None, param_specs=None):
    """``(update_step, accum_step, apply_step)``:

    ``update_step(params, opt_state, batch, sigmas) -> (params, opt_state,
    metrics)``; ``accum_step(params, grad_acc, batch, sigmas, weight) ->
    (grad_acc, metrics)`` adds ``weight``-scaled grads without applying;
    ``apply_step(params, opt_state, grad_acc) -> (params, opt_state,
    zeroed grad_acc, its global norm)``.  ``virtual_depth`` is the benchmark
    aid of ``flux_forward``.  Metrics are 0-dim tensors.  On a ``mesh``,
    ``params`` are this rank's shards and ``param_specs`` is
    ``parallel.sharding.flux_param_specs`` of the whole tree."""
    grads_of = _make_grads_of(flux_cfg, sampler_cfg, ppo_cfg, rope_cos, rope_sin,
                              guidance_scale, dtype, attn_impl, remat, loss_scale,
                              virtual_depth)
    on_mesh = mesh is not None and mesh.world > 1
    flat_specs = sharded = None

    def all_grads(params, batch, sigmas):
        nonlocal flat_specs, sharded
        leaves = [t.requires_grad_(True) for t in param_leaves(params)]
        if not on_mesh:
            return grads_of(params, leaves, batch, sigmas)
        if flat_specs is None:
            flat_specs = flatten_specs(param_specs)
            sharded = ["fsdp" in s for s in flat_specs]
        with torch.enable_grad():  # the gathers outside the blocks are on the graph
            fwd, hook = fsdp_view(params, mesh, param_specs)
        grads, metrics = grads_of(fwd, leaves, batch, sigmas, block_params=hook)
        return reduce_grads(grads, flat_specs, mesh), _batch_mean(metrics, mesh)

    def apply(opt_state, grads):
        return optimizer.apply(opt_state, grads, mesh=mesh if on_mesh else None,
                               sharded=sharded)

    def update_step(params, opt_state, batch: UpdateBatch, sigmas):
        grads, metrics = all_grads(params, batch, sigmas)
        metrics["grad_norm"] = apply(opt_state, grads)
        return params, opt_state, metrics

    @torch.no_grad()
    def accum_step(params, grad_acc, batch: UpdateBatch, sigmas, weight):
        grads, metrics = all_grads(params, batch, sigmas)
        for a, g in zip(param_leaves(grad_acc), grads):
            a.add_(g * weight)
        return grad_acc, metrics

    @torch.no_grad()
    def apply_step(params, opt_state, grad_acc):
        acc = param_leaves(grad_acc)
        norm = apply(opt_state, acc)  # done with the grads once it returns
        for a in acc:
            a.zero_()
        return params, opt_state, grad_acc, norm

    return update_step, accum_step, apply_step


def make_lora_update_fns(flux_cfg: FluxConfig, sampler_cfg: SamplerConfig,
                         ppo_cfg: PPOConfig, optimizer: Optimizer, rope_cos, rope_sin, *,
                         guidance_scale: float = 3.5, dtype=torch.bfloat16,
                         attn_impl: str = "auto", remat="dots", loss_scale: float = 1.0,
                         virtual_depth=None, mesh=None):
    """LoRA variant of ``make_update_fns``: ``update_step(factors, opt_state,
    lora_meta, base_params, batch, sigmas) -> (factors, opt_state, metrics)``.
    Gradients flow into the factors only (``opt_state`` is ``optimizer.init``
    of the factor tree) and ``grad_norm`` is their global norm before
    clipping.  The base tree is read, never written, and needs no
    ``requires_grad``.  On a ``mesh`` the factors' gradients are averaged
    over the batch ranks."""
    grads_of = _make_grads_of(flux_cfg, sampler_cfg, ppo_cfg, rope_cos, rope_sin,
                              guidance_scale, dtype, attn_impl, remat, loss_scale,
                              virtual_depth)

    def update_step(factors, opt_state, lora_meta, base_params, batch: UpdateBatch, sigmas):
        leaves = [t.requires_grad_(True) for t in param_leaves(factors)]
        with torch.enable_grad():  # merges outside the blocks are on the graph too
            params, merge_block = lora_blocks(base_params, {**lora_meta, "factors": factors})
        grads, metrics = grads_of(params, leaves, batch, sigmas, block_params=merge_block)
        if mesh is not None and mesh.world > 1:
            grads = reduce_grads(grads, [()] * len(grads), mesh)
            metrics = _batch_mean(metrics, mesh)
        metrics["grad_norm"] = optimizer.apply(opt_state, grads)
        return factors, opt_state, metrics

    return update_step


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

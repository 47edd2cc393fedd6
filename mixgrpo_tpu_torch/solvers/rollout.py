"""Mixed ODE-SDE rollout driver.

Port of mixgrpo_tpu/solvers/rollout.py.  JAX runs the trajectory as one
traced ``while_loop``; here it is a Python loop over the ``num_steps`` valid
steps (eager PyTorch has no trace to keep shape-stable).  The padded-step
contract is kept: schedule rows with ``i >= num_steps`` leave the latents
frozen at z_T with log_prob 0.

DPM-Solver (``dpm_algorithm_type`` "dpmsolver" or "dpmsolver++"): strategy
"all" runs every step as a multistep DPM-Solver step (SDE inside the window);
"post" (MixGRPO-Flash) runs the window's steps as SDE steps and the tail
after the last SDE step as DPM-Solver ODE steps.  Each ``run_rollout`` call
(each chunk of a chunked rollout) starts its own x0 ring buffer of
``max(order, 1)`` zeros; a window step pushes its x0 and counts toward the
order warm-up, so the first tail step can already run second order.

Noise: JAX draws ``normal(fold_in(rng, i))`` per step, which torch cannot
reproduce; ``noise_fn(i, shape)`` lets a caller (the parity tests) supply the
draws, otherwise SDE steps draw from ``generator`` and ODE steps use none.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from mixgrpo_tpu_torch.solvers import dpm as dpm_mod
from mixgrpo_tpu_torch.solvers.steps import dance_grpo_step, flow_grpo_step


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Static sampler configuration (mirrors the reference flag surface)."""

    num_steps_max: int
    eta: float = 0.7
    flow_grpo_sampling: bool = True  # True: Flow-GRPO SDE; False: DanceGRPO
    dpm_algorithm_type: str = "null"  # "null" | "dpmsolver" | "dpmsolver++"
    dpm_apply_strategy: str = "post"  # "post" | "all"
    dpm_solver_order: int = 2
    dpm_solver_type: str = "midpoint"  # "midpoint" | "heun"
    drop_last_sample: bool = False

    @property
    def use_dpm(self) -> bool:
        return "dpmsolver" in self.dpm_algorithm_type


class RolloutOutput(NamedTuple):
    final_latents: torch.Tensor  # (B, ...) z_T (or x0 if drop_last_sample)
    all_latents: torch.Tensor  # (B, T_max+1, ...)
    all_log_probs: torch.Tensor  # (B, T_max)
    step_valid: torch.Tensor  # (T_max,) bool


def rollout_step(
    cfg: SamplerConfig,
    model_fn: Callable,
    z,
    dpm_state,
    *,
    sigmas,
    step_index: int,
    num_steps: int,
    deterministic,
    last_sde_index,
    noise,
):
    """One solver step given the model prediction.

    ``model_fn(z, sigma) -> velocity``; ``deterministic`` is this step's
    ODE/SDE flag; ``last_sde_index`` the index of the last SDE step (-1 for
    none), which splits a "post" schedule into window and tail.  Returns
    ``(z_next, log_prob, x0_pred, dpm_state)``; a step at or past
    ``num_steps`` passes the latents and the state through with log_prob 0."""
    i = int(step_index)
    zf = z.float()
    if i >= num_steps:
        return zf, zf.new_zeros(zf.shape[0]), zf, dpm_state
    sigma, sigma_prev, sigma_max = sigmas[i], sigmas[i + 1], sigmas[1]
    pred = model_fn(z, sigma).float()

    def sde_step():
        if cfg.flow_grpo_sampling:
            z_next, x0, log_prob, _, _ = flow_grpo_step(
                pred, zf, cfg.eta, sigma, sigma_prev, sigma_max,
                noise=noise, deterministic=deterministic,
            )
        else:
            z_next, x0, log_prob = dance_grpo_step(
                pred, zf, cfg.eta, sigma, sigma_prev,
                noise=noise, sde=not bool(deterministic),
            )
        return z_next, x0, log_prob

    if not cfg.use_dpm:
        z_next, x0, log_prob = sde_step()
        return z_next, log_prob, x0, dpm_state
    x0 = dpm_mod.convert_model_output(pred, zf, sigma)
    st = dpm_mod.dpm_state_update(dpm_state, x0)
    if cfg.dpm_apply_strategy == "post" and i <= last_sde_index:
        # a window step: the SDE step, with its x0 pushed into the ring
        z_next, _, log_prob = sde_step()
        return z_next, log_prob, x0, dpm_mod.dpm_state_bump(st, cfg.dpm_solver_order)
    # "all" (SDE inside the window), or the tail of "post" (ODE)
    sde = cfg.dpm_apply_strategy == "all" and not bool(deterministic)
    z_next, _, log_prob, st = dpm_mod.dpm_solver_step(
        algo=cfg.dpm_algorithm_type, solver_order=cfg.dpm_solver_order,
        solver_type=cfg.dpm_solver_type, state=st, sample=zf, sigmas=sigmas, step_index=i,
        num_steps=num_steps, noise=noise if sde else None, sde=sde,
    )
    return z_next, log_prob, x0, st


def run_rollout(
    cfg: SamplerConfig,
    model_fn: Callable,
    z0: torch.Tensor,
    *,
    sigmas,
    deterministic,
    num_steps: int,
    generator: Optional[torch.Generator] = None,
    noise_fn: Optional[Callable] = None,
) -> RolloutOutput:
    """Run the T-step rollout (no gradients).

    Args:
      model_fn: ``(z, sigma) -> velocity`` closure over weights/conditioning.
      z0: initial noise latents, any shape with leading batch dim.
      sigmas: (num_steps_max + 1,) padded sigma schedule.
      deterministic: (num_steps_max,) bools, True = ODE step.
      num_steps: number of valid steps (<= num_steps_max).
      generator: draws the SDE steps' noise when ``noise_fn`` is not given.
      noise_fn: ``(i, shape) -> noise`` for step ``i`` (array-like).
    """
    T = cfg.num_steps_max
    dev = z0.device
    sigmas = torch.as_tensor(sigmas, dtype=torch.float32, device=dev)
    det = [bool(d) for d in torch.as_tensor(deterministic).tolist()]
    if sigmas.shape[0] != T + 1 or len(det) != T:
        raise ValueError(f"schedule {tuple(sigmas.shape)} / {len(det)} != T={T}")
    num_steps = int(num_steps)
    if not 0 <= num_steps <= T:
        raise ValueError(f"num_steps={num_steps} outside [0, {T}]")

    sde_steps = [i for i, d in enumerate(det) if not d]
    last_sde_index = sde_steps[-1] if sde_steps else -1
    dpm_state = dpm_mod.dpm_state_init(max(cfg.dpm_solver_order, 1), z0.shape, device=dev)

    z = z0.float()
    z0f, x0_final = z, z
    zs, lps = [], []
    with torch.no_grad():
        for i in range(num_steps):
            if noise_fn is not None:
                noise = torch.as_tensor(noise_fn(i, tuple(z.shape)),
                                        dtype=torch.float32, device=dev)
            elif det[i]:
                noise = torch.zeros_like(z)  # the ODE branch ignores it
            else:
                noise = torch.randn(z.shape, generator=generator, device=dev)
            z, log_prob, x0, dpm_state = rollout_step(
                cfg, model_fn, z, dpm_state,
                sigmas=sigmas, step_index=i, num_steps=num_steps,
                deterministic=det[i], last_sde_index=last_sde_index, noise=noise,
            )
            zs.append(z)
            lps.append(log_prob)
            if i == num_steps - 1:
                x0_final = x0
    # padded tail: latents frozen at z_T, log_prob 0
    zs += [z] * (T - num_steps)
    lps += [z.new_zeros(z.shape[0])] * (T - num_steps)

    all_latents = torch.stack([z0f] + zs, dim=1)  # (B, T+1, ...)
    all_log_probs = torch.stack(lps, dim=1) if lps else z.new_zeros((z.shape[0], 0))
    final = x0_final if cfg.drop_last_sample else z
    step_valid = torch.arange(T, device=dev) < num_steps
    return RolloutOutput(final, all_latents, all_log_probs, step_valid)

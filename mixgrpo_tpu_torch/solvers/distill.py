"""Consistency-distillation solver (PCM flow matching) and multiphase Euler.

Port of mixgrpo_tpu/solvers/distill.py (the reference's legacy distillation
stack, fastvideo/distill/solver.py):

  - ``linear_quadratic_schedule``: Mochi's linear-then-quadratic sigmas,
    Python float arithmetic cast to f32, copied as is (the Mochi pipeline's
    schedule, bit for bit JAX's);
  - ``pcm_sigma_schedule``: the dense descending sigma table over the
    training timesteps, time-shifted or linear-quadratic (host numpy);
  - ``EulerSolver``: (sigmas, sigmas_prev) at the Euler points (numpy
    tables); ``euler_step`` and ``multiphase_pred`` take and return tensors;
  - ``pcm_scheduler_step``: the Euler step of ``PCMFMScheduler.step``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from mixgrpo_tpu_torch.solvers.schedule import sd3_time_shift


def linear_quadratic_schedule(steps: int, threshold: float, linear_steps: int):
    """Mochi-style linear-then-quadratic sigma schedule
    (mochi_hf/pipeline_mochi.py)."""
    if linear_steps is None:
        linear_steps = steps // 2
    linear = [i * threshold / linear_steps for i in range(linear_steps)]
    threshold_noise_step_diff = linear_steps - threshold * steps
    quadratic_steps = steps - linear_steps
    quadratic_coef = threshold_noise_step_diff / (linear_steps * quadratic_steps**2)
    linear_coef = threshold / linear_steps - 2 * threshold_noise_step_diff / (
        quadratic_steps**2
    )
    const = quadratic_coef * (linear_steps**2)
    quadratic = [
        quadratic_coef * (i**2) + linear_coef * i + const
        for i in range(linear_steps, steps)
    ]
    sigmas = linear + quadratic
    return np.asarray([1.0 - x for x in sigmas], np.float32)


def pcm_sigma_schedule(
    num_train_timesteps: int = 1000,
    shift: float = 1.0,
    linear_quadratic: bool = False,
    lq_threshold: float = 0.025,
    lq_range: float = 0.5,
) -> np.ndarray:
    """Dense descending sigma table over training timesteps (solver.py:32-56)."""
    if linear_quadratic:
        return linear_quadratic_schedule(
            num_train_timesteps, lq_threshold, int(num_train_timesteps * lq_range))
    t = np.linspace(1, num_train_timesteps, num_train_timesteps, dtype=np.float32)[::-1]
    sig = t / num_train_timesteps
    return sd3_time_shift(shift, sig).astype(np.float32)


class EulerSolver(NamedTuple):
    """Euler-point sigma tables (solver.py:243-268)."""

    euler_timesteps: np.ndarray  # (K,) dense-timestep index per point
    euler_timesteps_prev: np.ndarray
    sigmas: np.ndarray  # (K,)
    sigmas_prev: np.ndarray

    @classmethod
    def build(cls, sigmas: np.ndarray, timesteps: int = 1000,
              euler_timesteps: int = 50) -> "EulerSolver":
        step_ratio = timesteps // euler_timesteps
        idx = (np.arange(1, euler_timesteps + 1) * step_ratio).round().astype(np.int64) - 1
        idx_prev = np.asarray([0] + idx[:-1].tolist())
        return cls(
            euler_timesteps=idx,
            euler_timesteps_prev=idx_prev,
            sigmas=np.asarray(sigmas)[idx],
            sigmas_prev=np.asarray([sigmas[0]] + np.asarray(sigmas)[idx[:-1]].tolist(),
                                   np.float32),
        )

    @staticmethod
    def _bcast(table, t_index, like):
        """``table[t_index]`` on ``like``'s device, shaped to broadcast over
        ``like``'s trailing axes."""
        idx = torch.as_tensor(np.asarray(t_index), device=like.device).long()
        v = torch.as_tensor(np.asarray(table), device=like.device)[idx]
        return v.reshape((-1,) + (1,) * (like.ndim - 1))

    def euler_step(self, sample, model_pred, timestep_index):
        sigma = self._bcast(self.sigmas, timestep_index, model_pred)
        sigma_prev = self._bcast(self.sigmas_prev, timestep_index, model_pred)
        return sample + (sigma_prev - sigma) * model_pred

    def multiphase_pred(self, sample, model_pred, timestep_index, multiphase: int,
                        is_target: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Jump each sample to its phase boundary (solver.py:272-310): the
        last boundary at or below its point.  Returns (sample, t_end)."""
        K = len(self.euler_timesteps)
        bounds = torch.as_tensor(np.floor(np.linspace(0, K, num=multiphase, endpoint=False))
                                 .astype(np.int64), device=sample.device)
        t_idx = torch.as_tensor(np.asarray(timestep_index), device=sample.device).long()
        valid = t_idx[:, None] >= bounds[None, :]
        last_valid = valid.shape[1] - 1 - torch.argmax(valid.flip(1).int(), dim=1)
        t_end = bounds[last_valid]
        table = self.sigmas_prev if is_target else self.sigmas
        sigma = self._bcast(table, t_idx, sample)
        sigma_prev = self._bcast(self.sigmas_prev, t_end, sample)
        return sample + (sigma_prev - sigma) * model_pred, t_end


def pcm_scheduler_step(sigmas: np.ndarray, step_index: int, model_output, sample):
    """PCMFMScheduler.step (solver.py:175-237): Euler on the subsampled
    schedule.  ``sigmas`` includes the trailing 0 (sigmas_); the step's dt
    is taken in f32, as JAX takes it in numpy."""
    sigma = np.float32(sigmas[step_index])
    denoised = sample - model_output * float(sigma)
    derivative = (sample - denoised) / float(sigma)
    dt = np.float32(sigmas[step_index + 1]) - sigma
    return sample + derivative * float(dt)

"""Flow-match discrete Euler scheduler (the HunyuanVideo inference path).

Port of mixgrpo_tpu/models/hunyuan/scheduler.py: sigmas = linspace(1, 0,
N+1) in f64, time-shifted (sigma' = s*sigma / (1 + (s-1)*sigma), the
pipeline's shift is 7.0), then cast to f32; timesteps = sigma * 1000; the
reverse-flow Euler step x_{t+1} = x_t + (sigma_next - sigma_t) * v.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mixgrpo_tpu_torch.solvers.schedule import sd3_time_shift


@dataclasses.dataclass
class FlowMatchDiscreteScheduler:
    num_train_timesteps: int = 1000
    shift: float = 1.0
    reverse: bool = True

    def set_timesteps(self, num_inference_steps: int):
        sigmas = np.linspace(1.0, 0.0, num_inference_steps + 1, dtype=np.float64)
        if not self.reverse:
            sigmas = 1.0 - sigmas
        sigmas = sd3_time_shift(self.shift, sigmas).astype(np.float32)
        self.sigmas = sigmas
        self.timesteps = (sigmas[:-1] * self.num_train_timesteps).astype(np.float32)
        return self.timesteps

    def step(self, model_output, step_index: int, sample):
        dt = float(self.sigmas[step_index + 1] - self.sigmas[step_index])
        return sample + torch.as_tensor(model_output) * dt

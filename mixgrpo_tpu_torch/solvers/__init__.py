"""Flow-matching step functions, DPM-Solver and the rollout driver (mirrors
mixgrpo_tpu/solvers/, with the same exports)."""

from mixgrpo_tpu_torch.solvers.schedule import (
    sd3_time_shift,
    sigma_schedule,
    flash_post_schedule,
)
from mixgrpo_tpu_torch.solvers.steps import (
    flow_grpo_step,
    dance_grpo_step,
    gaussian_log_prob,
)
from mixgrpo_tpu_torch.solvers.dpm import (
    DPMState,
    dpm_state_init,
    dpm_state_update,
    convert_model_output,
    dpm_solver_step,
)
from mixgrpo_tpu_torch.solvers.rollout import SamplerConfig, run_rollout, rollout_step

__all__ = [
    "sd3_time_shift",
    "sigma_schedule",
    "flash_post_schedule",
    "flow_grpo_step",
    "dance_grpo_step",
    "gaussian_log_prob",
    "DPMState",
    "dpm_state_init",
    "dpm_state_update",
    "convert_model_output",
    "dpm_solver_step",
    "SamplerConfig",
    "run_rollout",
    "rollout_step",
]

"""Sigma schedules for rectified-flow sampling.

Port of mixgrpo_tpu/solvers/schedule.py, copied in full (host-side numpy):
  - ``sd3_time_shift``: the SD3 time shift;
  - ``sigma_schedule``: ``linspace(1, 0, T+1)`` time-shifted;
  - ``flash_post_schedule``: MixGRPO-Flash "post" compression of the ODE tail
    after the SDE window, padded to a fixed length with a valid-step count
    (the DPM-Solver steps that run such a schedule wait for the port of
    ``solvers/dpm.py``, so the trainer refuses it for now);
  - ``deterministic_mask``: the per-step ODE/SDE mask of the window.
Schedules are computed once per iteration and handed to the rollout as data.
"""

from __future__ import annotations

import numpy as np


def sd3_time_shift(shift: float, t):
    """SD3-style timestep shift: ``t' = s*t / (1 + (s-1)*t)``."""
    return (shift * t) / (1.0 + (shift - 1.0) * t)


def sigma_schedule(num_steps: int, shift: float = 1.0) -> np.ndarray:
    """Shifted linear sigma schedule, length ``num_steps + 1``, from 1 to 0."""
    t = np.linspace(1.0, 0.0, num_steps + 1, dtype=np.float64)
    return sd3_time_shift(shift, t).astype(np.float32)


def flash_post_schedule(
    base_sigmas: np.ndarray,
    deterministic: np.ndarray,
    shift: float,
    compress_ratio: float,
    pad_to: int | None = None,
):
    """MixGRPO-Flash: compress the ODE tail after the SDE window.

    Given the base schedule (length T+1) and the per-step ``deterministic``
    mask (length T, False inside the SDE window), rebuild the portion of the
    schedule after the last SDE step with fewer (compressed) steps, using a
    fresh linspace from the post-window time down to 0, re-time-shifted.

    Returns ``(sigmas, num_steps, deterministic_out)`` where ``sigmas`` has
    length ``pad_to + 1`` (padded by repeating the final 0.0) and
    ``num_steps`` counts the valid steps.  Steps past the window are ODE
    (deterministic=True); padded steps are marked deterministic and masked
    out by ``step < num_steps`` in the rollout.
    """
    base_sigmas = np.asarray(base_sigmas, dtype=np.float32)
    deterministic = np.asarray(deterministic, dtype=bool)
    T = base_sigmas.shape[0] - 1
    assert deterministic.shape[0] == T

    sde_idx = np.nonzero(~deterministic)[0]
    if sde_idx.size == 0:
        # no SDE window: nothing to compress
        sigmas, n = base_sigmas, T
    else:
        last = int(sde_idx[-1])
        # reference: int(max((len(sigmas) - 1 - last) * ratio, 1))
        num_post = int(max((T - last) * compress_ratio, 1))
        # time value one step past the window on the *unshifted* grid
        post_t = np.linspace(1.0, 0.0, T + 1, dtype=np.float64)[last + 1]
        post = sd3_time_shift(shift, np.linspace(post_t, 0.0, num_post, dtype=np.float64))
        sigmas = np.concatenate([base_sigmas[: last + 1], post.astype(np.float32)])
        n = sigmas.shape[0] - 1

    det_out = np.ones(n, dtype=bool)
    det_out[: deterministic.shape[0]][: n] = deterministic[: min(n, T)]
    # all steps past the original window are deterministic ODE steps
    if sde_idx.size:
        det_out[int(sde_idx[-1]) + 1 :] = True

    if pad_to is not None:
        assert pad_to >= n, f"pad_to={pad_to} < num_steps={n}"
        sigmas = np.concatenate([sigmas, np.zeros(pad_to - n, dtype=np.float32)])
        det_out = np.concatenate([det_out, np.ones(pad_to - n, dtype=bool)])
    return sigmas, n, det_out


def deterministic_mask(num_steps: int, train_timesteps) -> np.ndarray:
    """Per-step ODE/SDE mask: True = deterministic ODE, False = SDE.

    Mirrors fastvideo/train_grpo_flux.py:251-256 ("part" strategy): all steps
    deterministic except the sliding-window timesteps.
    """
    det = np.ones(num_steps, dtype=bool)
    for i in train_timesteps:
        det[int(i)] = False
    return det

"""Multistep DPM-Solver / DPM-Solver++ for rectified flow (MixGRPO-Flash).

Port of mixgrpo_tpu/solvers/dpm.py:

  - ``DPMState``: a ``(order, *latent_shape)`` ring buffer of x0-predictions
    (oldest first) and the ``lower_order_nums`` counter;
  - the order rules of the reference: warm-up to the full order, first order
    at the final step, second order at the second-to-last step of a schedule
    shorter than 15 steps.  JAX computes every order and selects with
    ``jnp.where`` inside its traced loop; eager PyTorch branches on the
    Python step counters and computes only the selected order (the same
    numbers);
  - flow-matching convention alpha_t = 1 - sigma, sigma_t = sigma; sigmas
    are clamped to ``_EPS`` before the log so the final sigma = 0 step stays
    finite.

Log-prob convention as the SDE steps: x_next ~ N(mean, (std * dt_sqrt)^2),
std = sigma_t, the total std clamped at ``_EPS``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mixgrpo_tpu_torch.solvers.steps import gaussian_log_prob

_EPS = 1e-7


class DPMState(NamedTuple):
    """Ring buffer of the ``order`` most recent x0-predictions (oldest first)."""

    model_outputs: torch.Tensor  # (order, *latent_shape)
    lower_order_nums: int


def dpm_state_init(order: int, latent_shape, dtype=torch.float32, device="cuda") -> DPMState:
    return DPMState(torch.zeros((order, *latent_shape), dtype=dtype, device=device), 0)


def dpm_state_update(state: DPMState, x0_pred: torch.Tensor) -> DPMState:
    """Shift the ring buffer and append the newest x0 prediction."""
    buf = torch.cat([state.model_outputs[1:],
                     x0_pred[None].to(state.model_outputs.dtype)], dim=0)
    return DPMState(buf, state.lower_order_nums)


def dpm_state_bump(state: DPMState, order: int) -> DPMState:
    return DPMState(state.model_outputs, min(state.lower_order_nums + 1, order))


def convert_model_output(model_output, sample, sigma):
    """Velocity -> x0 prediction."""
    return sample - sigma * model_output


def _lambda(sigma):
    s = torch.clamp(sigma, _EPS, 1.0 - _EPS)
    return torch.log1p(-s) - torch.log(s)


def _first_order(algo, sample, m0, sig_t, sig_s):
    a_t, a_s = 1.0 - sig_t, 1.0 - sig_s
    h = _lambda(sig_t) - _lambda(sig_s)
    if algo == "dpmsolver++":
        mean = (sig_t / sig_s * torch.exp(-h)) * sample + (a_t * (1 - torch.exp(-2.0 * h))) * m0
        ode = (sig_t / sig_s) * sample - (a_t * (torch.exp(-h) - 1.0)) * m0
        dt_sqrt = torch.sqrt(torch.clamp(1.0 - torch.exp(-2.0 * h), min=0.0))
    else:  # "dpmsolver"
        mean = (a_t / a_s) * sample - 2.0 * (sig_t * (torch.exp(h) - 1.0)) * m0
        ode = (a_t / a_s) * sample - (sig_t * (torch.exp(h) - 1.0)) * m0
        dt_sqrt = torch.sqrt(torch.clamp(torch.exp(2.0 * h) - 1.0, min=0.0))
    return mean, ode, sig_t, dt_sqrt


def _second_order(algo, solver_type, sample, m0, m1, sig_t, sig_s0, sig_s1):
    a_t, a_s0 = 1.0 - sig_t, 1.0 - sig_s0
    l_t, l_s0, l_s1 = _lambda(sig_t), _lambda(sig_s0), _lambda(sig_s1)
    h, h0 = l_t - l_s0, l_s0 - l_s1
    r0 = h0 / h
    D0 = m0
    D1 = (m0 - m1) / r0
    if algo == "dpmsolver++":
        em = torch.exp(-h)
        e2 = 1.0 - torch.exp(-2.0 * h)
        base = (sig_t / sig_s0 * em) * sample + (a_t * e2) * D0
        if solver_type == "midpoint":
            mean = base + 0.5 * (a_t * e2) * D1
            ode = ((sig_t / sig_s0) * sample - (a_t * (em - 1.0)) * D0
                   - 0.5 * (a_t * (em - 1.0)) * D1)
        else:  # heun
            mean = base + (a_t * (e2 / (-2.0 * h) + 1.0)) * D1
            ode = ((sig_t / sig_s0) * sample - (a_t * (em - 1.0)) * D0
                   + (a_t * ((em - 1.0) / h + 1.0)) * D1)
        dt_sqrt = torch.sqrt(torch.clamp(e2, min=0.0))
    else:
        eh = torch.exp(h)
        if solver_type == "midpoint":
            mean = ((a_t / a_s0) * sample - 2.0 * (sig_t * (eh - 1.0)) * D0
                    - (sig_t * (eh - 1.0)) * D1)
            ode = ((a_t / a_s0) * sample - (sig_t * (eh - 1.0)) * D0
                   - 0.5 * (sig_t * (eh - 1.0)) * D1)
        else:
            mean = ((a_t / a_s0) * sample - 2.0 * (sig_t * (eh - 1.0)) * D0
                    - 2.0 * (sig_t * ((eh - 1.0) / h - 1.0)) * D1)
            ode = ((a_t / a_s0) * sample - (sig_t * (eh - 1.0)) * D0
                   - (sig_t * ((eh - 1.0) / h - 1.0)) * D1)
        dt_sqrt = torch.sqrt(torch.clamp(torch.exp(2.0 * h) - 1.0, min=0.0))
    return mean, ode, sig_t, dt_sqrt


def _third_order(algo, sample, m0, m1, m2, sig_t, sig_s0, sig_s1, sig_s2):
    a_t, a_s0 = 1.0 - sig_t, 1.0 - sig_s0
    l_t, l_s0, l_s1, l_s2 = _lambda(sig_t), _lambda(sig_s0), _lambda(sig_s1), _lambda(sig_s2)
    h, h0, h1 = l_t - l_s0, l_s0 - l_s1, l_s1 - l_s2
    r0, r1 = h0 / h, h1 / h
    D0 = m0
    D1_0, D1_1 = (m0 - m1) / r0, (m1 - m2) / r1
    D1 = D1_0 + (r0 / (r0 + r1)) * (D1_0 - D1_1)
    D2 = (D1_0 - D1_1) / (r0 + r1)
    if algo == "dpmsolver++":
        em = torch.exp(-h)
        e2 = 1.0 - torch.exp(-2.0 * h)
        mean = ((sig_t / sig_s0 * em) * sample
                + (a_t * e2) * D0
                + (a_t * (e2 / (-2.0 * h) + 1.0)) * D1
                + (a_t * ((e2 - 2.0 * h) / (2.0 * h) ** 2 - 0.5)) * D2)
        ode = ((sig_t / sig_s0) * sample
               - (a_t * (em - 1.0)) * D0
               + (a_t * ((em - 1.0) / h + 1.0)) * D1
               - (a_t * ((em - 1.0 + h) / h**2 - 0.5)) * D2)
        dt_sqrt = torch.sqrt(torch.clamp(e2, min=0.0))
    else:
        eh = torch.exp(h)
        ode = ((a_t / a_s0) * sample
               - (sig_t * (eh - 1.0)) * D0
               - (sig_t * ((eh - 1.0) / h - 1.0)) * D1
               - (sig_t * ((eh - 1.0 - h) / h**2 - 0.5)) * D2)
        mean = ode  # plain dpmsolver order 3 has no SDE variant (the reference asserts)
        dt_sqrt = torch.sqrt(torch.clamp(torch.exp(2.0 * h) - 1.0, min=0.0))
    return mean, ode, sig_t, dt_sqrt


def dpm_solver_step(*, algo: str, solver_order: int, solver_type: str, state: DPMState,
                    sample, sigmas, step_index: int, num_steps: int, noise=None,
                    prev_sample=None, sde=False):
    """One multistep DPM-Solver update with its Gaussian log-prob.

    The ring buffer must already hold this step's x0 in its last slot (call
    ``dpm_state_update`` first).  ``sigmas`` (a 1-D f32 tensor) may be longer
    than the live schedule (Flash padding); ``num_steps`` bounds the
    final-step rule.  Returns ``(next_latents, mean, log_prob, new_state)``.
    """
    i, n = int(step_index), int(num_steps)
    sig = lambda j: sigmas[min(max(j, 0), sigmas.shape[0] - 1)]
    sig_t, sig_s0, sig_s1, sig_s2 = sig(i + 1), sig(i), sig(i - 1), sig(i - 2)
    m = state.model_outputs
    m0 = m[-1]
    m1 = m[-2] if solver_order >= 2 else m0
    m2 = m[-3] if solver_order >= 3 else m0

    nums = state.lower_order_nums
    lower_order_final = i == n - 1
    lower_order_second = i == n - 2 and n < 15
    if solver_order == 1 or nums < 1 or lower_order_final:
        mean, ode, std, dts = _first_order(algo, sample, m0, sig_t, sig_s0)
    elif solver_order == 2 or nums < 2 or lower_order_second:
        mean, ode, std, dts = _second_order(algo, solver_type, sample, m0, m1, sig_t, sig_s0,
                                            sig_s1)
    else:
        mean, ode, std, dts = _third_order(algo, sample, m0, m1, m2, sig_t, sig_s0, sig_s1,
                                           sig_s2)

    if prev_sample is not None:
        next_latents = prev_sample
    elif noise is not None and sde:
        next_latents = mean + std * dts * noise
    else:
        next_latents = ode

    total_std = torch.clamp(std * dts, min=_EPS)
    log_prob = gaussian_log_prob(next_latents, mean, total_std)
    return next_latents, mean, log_prob, dpm_state_bump(state, solver_order)

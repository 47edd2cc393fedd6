"""Port's solver steps, rollout driver and sampler vs the JAX package.

Both sides get the same numpy inputs; the rollout's SDE noise is JAX's own
``normal(fold_in(rng, i))`` draw handed to the port through ``noise_fn``.
fp32 tolerances: 1e-5 for the step math, 2e-4 for a tiny-FLUX rollout (the
model's matmuls sum in another order).  At eta = 0 every log-prob is
non-finite on both sides (zero variance), so only latents are compared there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixgrpo_tpu import sampler as JS
from mixgrpo_tpu.models.flux import model as JM
from mixgrpo_tpu.solvers import rollout as JR
from mixgrpo_tpu.solvers import steps as JSt
from mixgrpo_tpu_torch import sampler as S
from mixgrpo_tpu_torch.convert import from_jax_params
from mixgrpo_tpu_torch.models.flux import model as M
from mixgrpo_tpu_torch.solvers import rollout as R
from mixgrpo_tpu_torch.solvers import steps as St


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _np(x):
    return np.asarray(x, np.float32)


def _step_inputs(seed=0):
    rng = np.random.default_rng(seed)
    shape = (3, 4, 8)
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(3))


@pytest.mark.parametrize("deterministic", [False, True])
@pytest.mark.parametrize("sigma,sigma_prev", [(1.0, 0.9), (0.6, 0.45)])
def test_flow_grpo_step_matches_jax(deterministic, sigma, sigma_prev):
    v, x, noise = _step_inputs()
    want = JSt.flow_grpo_step(jnp.asarray(v), jnp.asarray(x), 0.7, sigma, sigma_prev,
                              0.95, noise=jnp.asarray(noise),
                              deterministic=deterministic)
    got = St.flow_grpo_step(_t(v), _t(x), 0.7, sigma, sigma_prev, 0.95,
                            noise=_t(noise), deterministic=deterministic)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-5, atol=1e-5)
    # recompute mode: prev_sample instead of noise
    lp = St.flow_grpo_step(_t(v), _t(x), 0.7, sigma, sigma_prev, 0.95,
                           prev_sample=got[0])[2]
    np.testing.assert_allclose(lp.numpy(), got[2].numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("sde", [True, False])
def test_dance_grpo_step_matches_jax(sde):
    v, x, noise = _step_inputs(1)
    want = JSt.dance_grpo_step(jnp.asarray(v), jnp.asarray(x), 0.7, 0.6, 0.45,
                               noise=jnp.asarray(noise), sde=sde)
    got = St.dance_grpo_step(_t(v), _t(x), 0.7, 0.6, 0.45, noise=_t(noise), sde=sde)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-5, atol=1e-5)


def test_gaussian_log_prob_and_timestep_quantization():
    x, m, s = _step_inputs(2)
    s = np.abs(s) + 0.1
    np.testing.assert_allclose(
        St.gaussian_log_prob(_t(x), _t(m), _t(s)).numpy(),
        _np(JSt.gaussian_log_prob(*map(jnp.asarray, (x, m, s)))), rtol=1e-6, atol=1e-6)
    sig = np.array([1.0, 0.9999, 0.5005, 0.0123, 0.0], np.float32)
    np.testing.assert_array_equal(S.quantized_timestep(_t(sig)).numpy(),
                                  _np(JS.quantized_timestep(jnp.asarray(sig))))


def _jax_noise(rng):
    return lambda i, shape: np.array(
        jax.random.normal(jax.random.fold_in(rng, i), shape, jnp.float32))


@pytest.mark.parametrize("flow", [True, False])
@pytest.mark.parametrize("eta", [0.7, 0.0])
def test_run_rollout_matches_jax_with_padded_steps(flow, eta):
    """5-row schedule, 4 valid steps (row 4 is padding: latents frozen at
    z_T, log_prob 0), mixed ODE/SDE mask, analytic velocity field."""
    T, n = 5, 4
    sig = np.array([1.0, 0.8, 0.55, 0.3, 0.1, 0.1], np.float32)
    det = np.array([False, True, False, True, True])
    z0 = np.random.default_rng(3).standard_normal((2, 6, 4)).astype(np.float32)
    rng = jax.random.key(7)
    cfg_j = JR.SamplerConfig(num_steps_max=T, eta=eta, flow_grpo_sampling=flow)
    cfg = R.SamplerConfig(num_steps_max=T, eta=eta, flow_grpo_sampling=flow)
    model = lambda z, s: 0.5 * z + s - 0.25
    want = JR.run_rollout(cfg_j, model, jnp.asarray(z0), sigmas=jnp.asarray(sig),
                          deterministic=jnp.asarray(det), num_steps=n, rng=rng)
    got = R.run_rollout(cfg, model, _t(z0), sigmas=sig, deterministic=det,
                        num_steps=n, noise_fn=_jax_noise(rng))
    np.testing.assert_allclose(got.all_latents.numpy(), _np(want.all_latents),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.final_latents.numpy(), _np(want.final_latents),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.step_valid.numpy(), np.asarray(want.step_valid))
    np.testing.assert_array_equal(got.all_latents[:, n + 1].numpy(),
                                  got.all_latents[:, n].numpy())
    assert (got.all_log_probs[:, n:] == 0).all()
    if eta > 0:
        np.testing.assert_allclose(got.all_log_probs.numpy(), _np(want.all_log_probs),
                                   rtol=1e-5, atol=1e-5)


def test_rollout_refuses_dpm():
    """The rollout no longer refuses DPM-Solver configurations: the "post"
    rollout of the analytic field (window at steps 0-1, a DPM-Solver++ tail)
    runs and matches JAX's (tests/test_torch_dpm.py covers the DPM rollouts
    in full)."""
    kw = dict(num_steps_max=4, eta=0.7, dpm_algorithm_type="dpmsolver++")
    sig = np.array([1.0, 0.8, 0.5, 0.2, 0.0], np.float32)
    det = np.array([False, False, True, True])
    z0 = np.random.default_rng(5).standard_normal((2, 6, 4)).astype(np.float32)
    rng = jax.random.key(9)
    model = lambda z, s: 0.5 * z + s - 0.25
    want = JR.run_rollout(JR.SamplerConfig(**kw), model, jnp.asarray(z0),
                          sigmas=jnp.asarray(sig), deterministic=jnp.asarray(det),
                          num_steps=4, rng=rng)
    got = R.run_rollout(R.SamplerConfig(**kw), model, _t(z0), sigmas=sig, deterministic=det,
                        num_steps=4, noise_fn=_jax_noise(rng))
    np.testing.assert_allclose(got.all_latents.numpy(), _np(want.all_latents),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.all_log_probs.numpy(), _np(want.all_log_probs),
                               rtol=1e-5, atol=1e-5)


def test_flux_sampler_rollout_matches_jax():
    """Tiny FLUX under the sampler: quantized timesteps, RoPE tables and the
    SDE noise path, eta = 0.7, 3 of 4 schedule rows valid."""
    jcfg, cfg = JM.FluxConfig.tiny(), M.FluxConfig.tiny()
    jparams = JM.init_flux(jax.random.key(0), jcfg)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    kw = dict(height=32, width=32, text_len=8, guidance_scale=3.5)
    js = JS.FluxSampler(jcfg, JR.SamplerConfig(num_steps_max=4, eta=0.7),
                        dtype=jnp.float32, attn_impl="xla", **kw)
    ts = S.FluxSampler(cfg, R.SamplerConfig(num_steps_max=4, eta=0.7),
                       dtype=torch.float32, device="cpu", **kw)
    rng = np.random.default_rng(4)
    z0 = rng.standard_normal((2, ts.num_image_tokens, cfg.in_channels)).astype(np.float32)
    txt = rng.standard_normal((2, 8, cfg.context_dim)).astype(np.float32)
    pooled = rng.standard_normal((2, cfg.pooled_dim)).astype(np.float32)
    sig = np.array([1.0, 0.7, 0.4, 0.2, 0.2], np.float32)
    det = np.array([False, False, True, True])
    key = jax.random.key(11)
    want = js.rollout(jparams, *map(jnp.asarray, (z0, txt, pooled)), sig, det, 3, key)
    got = ts.rollout(params, *map(_t, (z0, txt, pooled)), sig, det, 3,
                     noise_fn=_jax_noise(key))
    np.testing.assert_allclose(got.all_latents.numpy(), _np(want.all_latents),
                               rtol=0, atol=2e-4)
    np.testing.assert_allclose(got.all_log_probs.numpy(), _np(want.all_log_probs),
                               rtol=1e-4, atol=2e-4)

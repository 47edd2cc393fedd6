"""Port's DPM-Solver (MixGRPO-Flash) vs the JAX package.

Both sides get the same numpy inputs.  ``dpm_solver_step`` runs as a chain of
steps over a whole schedule (the order warm-up, second order at the
second-to-last step of a schedule shorter than 15 steps, first order at the
final step, whose sigma is 0), ODE or SDE with the same noise; latents, means,
log-probs and the ring buffer within 1e-5 (the same f32 math, op by op; the
log-prob relative).  Rollouts take JAX's SDE draws through ``noise_fn``: the
analytic velocity field within 1e-5, tiny FLUX within 2e-4 on latents and
1e-4 relative on log-probs (the model's matmuls sum in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixgrpo_tpu import sampler as JS
from mixgrpo_tpu.models.flux import model as JM
from mixgrpo_tpu.solvers import dpm as JD
from mixgrpo_tpu.solvers import rollout as JR
from mixgrpo_tpu.solvers.schedule import (
    deterministic_mask, flash_post_schedule, sigma_schedule,
)
from mixgrpo_tpu_torch import sampler as S
from mixgrpo_tpu_torch import solvers as TS
from mixgrpo_tpu_torch.convert import from_jax_params
from mixgrpo_tpu_torch.models.flux import model as M
from mixgrpo_tpu_torch.solvers import dpm as D
from mixgrpo_tpu_torch.solvers import rollout as R


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _np(x):
    return np.asarray(x, np.float32)


def _schedule(algo, T):
    # plain "dpmsolver" divides by alpha_s = 1 - sigma_s, singular at sigma = 1
    # on both sides, so its chains start below 1
    if algo == "dpmsolver++":
        return sigma_schedule(T, 3.0)
    return np.linspace(0.9, 0.0, T + 1).astype(np.float32)


CHAINS = [(algo, order, kind, sde, 8)
          for algo in ("dpmsolver++", "dpmsolver") for order in (1, 2, 3)
          for kind in ("midpoint", "heun") for sde in (False, True)]
# order 3 at a schedule of 15 steps or more: third order up to the step before
# the last
CHAINS += [(algo, 3, kind, sde, 16) for algo in ("dpmsolver++", "dpmsolver")
           for kind in ("midpoint", "heun") for sde in (False, True)]


@pytest.mark.parametrize("algo,order,kind,sde,T", CHAINS)
def test_dpm_solver_step_matches_jax(algo, order, kind, sde, T):
    rng = np.random.default_rng(order * 10 + T)
    sig = _schedule(algo, T)
    z = rng.standard_normal((2, 6, 4)).astype(np.float32)
    jst, tst = JD.dpm_state_init(order, z.shape), D.dpm_state_init(order, z.shape,
                                                                    device="cpu")
    jz, tz = jnp.asarray(z), _t(z)
    for i in range(T):
        v, noise = (rng.standard_normal(z.shape).astype(np.float32) for _ in range(2))
        jst = JD.dpm_state_update(jst, JD.convert_model_output(jnp.asarray(v), jz, sig[i]))
        tst = D.dpm_state_update(tst, D.convert_model_output(_t(v), tz, _t(sig)[i]))
        kw = dict(algo=algo, solver_order=order, solver_type=kind, step_index=i,
                  num_steps=T, sde=sde)
        jz1, jm, jlp, jst1 = JD.dpm_solver_step(state=jst, sample=jz, sigmas=jnp.asarray(sig),
                                                noise=jnp.asarray(noise), **kw)
        tz1, tm, tlp, tst1 = D.dpm_solver_step(state=tst, sample=tz, sigmas=_t(sig),
                                               noise=_t(noise), **kw)
        np.testing.assert_allclose(tz1.numpy(), _np(jz1), rtol=0, atol=1e-5, err_msg=f"z {i}")
        np.testing.assert_allclose(tm.numpy(), _np(jm), rtol=0, atol=1e-5, err_msg=f"mean {i}")
        np.testing.assert_allclose(tlp.numpy(), _np(jlp), rtol=1e-5, atol=1e-5,
                                   err_msg=f"log_prob {i}")
        assert tst1.lower_order_nums == int(jst1.lower_order_nums)
        assert np.isfinite(tz1.numpy()).all() and np.isfinite(tlp.numpy()).all()
        # the stored transition's log-prob, recomputed from prev_sample
        _, _, jre, _ = JD.dpm_solver_step(state=jst, sample=jz, sigmas=jnp.asarray(sig),
                                          prev_sample=jz1, **kw)
        _, _, tre, _ = D.dpm_solver_step(state=tst, sample=tz, sigmas=_t(sig),
                                         prev_sample=tz1, **kw)
        np.testing.assert_allclose(tre.numpy(), _np(jre), rtol=1e-5, atol=1e-5)
        jz, tz, jst, tst = jz1, tz1, jst1, tst1
        np.testing.assert_allclose(tst.model_outputs.numpy(), _np(jst.model_outputs),
                                   rtol=0, atol=1e-5)


def test_state_helpers_and_exports_match_jax():
    x = np.random.default_rng(1).standard_normal((3, 5)).astype(np.float32)
    st = D.dpm_state_init(3, x.shape, device="cpu")
    jst = JD.dpm_state_init(3, x.shape)
    for k in range(4):
        st = D.dpm_state_bump(D.dpm_state_update(st, _t(x + k)), 3)
        jst = JD.dpm_state_bump(JD.dpm_state_update(jst, jnp.asarray(x + k)), 3)
    np.testing.assert_array_equal(st.model_outputs.numpy(), _np(jst.model_outputs))
    assert st.lower_order_nums == int(jst.lower_order_nums) == 3
    sig = np.array([0.0, 1e-9, 0.3, 1.0], np.float32)
    np.testing.assert_allclose(D._lambda(_t(sig)).numpy(), _np(JD._lambda(jnp.asarray(sig))),
                               rtol=1e-6)
    from mixgrpo_tpu import solvers as JSV
    assert sorted(TS.__all__) == sorted(JSV.__all__)


def _flash(T, window, ratio):
    det = deterministic_mask(T, window)
    return flash_post_schedule(sigma_schedule(T, 3.0), det, 3.0, ratio, pad_to=T)


# (strategy, algo, order, kind, flow): "post" with the window mid-trajectory,
# so the tail's first step already runs second (or third) order on the x0 the
# window's last step pushed; "all" on the plain schedule
ROLLOUTS = [("post", "dpmsolver++", 2, "midpoint", True),
            ("post", "dpmsolver++", 3, "heun", True),
            ("post", "dpmsolver", 2, "midpoint", False),
            ("post", "dpmsolver++", 1, "midpoint", True),
            ("all", "dpmsolver++", 1, "midpoint", True),
            ("all", "dpmsolver++", 2, "heun", True),
            ("all", "dpmsolver++", 3, "midpoint", True)]


@pytest.mark.parametrize("strategy,algo,order,kind,flow", ROLLOUTS)
def test_run_rollout_dpm_matches_jax(strategy, algo, order, kind, flow):
    """10-row schedule, analytic velocity field; "post": window [3, 4] and
    the Flash-compressed tail (ratio 0.8: 8 valid steps of 10, the last two
    rows padding); "all": SDE at steps 2-3, DPM everywhere."""
    T = 10
    if strategy == "post":
        sig, n, det = _flash(T, [3, 4], 0.8)
        assert n < T
    else:
        sig, n, det = sigma_schedule(T, 3.0), T, deterministic_mask(T, [2, 3])
    z0 = np.random.default_rng(order).standard_normal((2, 6, 4)).astype(np.float32)
    rng = jax.random.key(3 + order)
    kw = dict(num_steps_max=T, eta=0.7, flow_grpo_sampling=flow, dpm_algorithm_type=algo,
              dpm_apply_strategy=strategy, dpm_solver_order=order, dpm_solver_type=kind)
    model = lambda z, s: 0.5 * z + s - 0.25
    want = JR.run_rollout(JR.SamplerConfig(**kw), model, jnp.asarray(z0),
                          sigmas=jnp.asarray(sig), deterministic=jnp.asarray(det),
                          num_steps=n, rng=rng)
    noise = lambda i, shape: np.array(jax.random.normal(jax.random.fold_in(rng, i), shape,
                                                        jnp.float32))
    got = R.run_rollout(R.SamplerConfig(**kw), model, _t(z0), sigmas=sig, deterministic=det,
                        num_steps=n, noise_fn=noise)
    np.testing.assert_allclose(got.all_latents.numpy(), _np(want.all_latents), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got.all_log_probs.numpy(), _np(want.all_log_probs),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.final_latents.numpy(), _np(want.final_latents), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got.step_valid.numpy(), np.asarray(want.step_valid))
    assert (got.all_log_probs[:, n:] == 0).all()


def test_rollout_post_state_machine():
    """In "post", a window step pushes its x0 and counts toward the warm-up,
    so the tail's first step runs second order: replacing the window's x0
    (an order-1 tail) changes it.  Padded steps leave the state alone."""
    sig, n, det = _flash(10, [3, 4], 0.8)
    assert n == 8
    cfg = R.SamplerConfig(num_steps_max=10, dpm_algorithm_type="dpmsolver++")
    model = lambda z, s: 0.5 * z + s - 0.25
    z = torch.ones(1, 4)
    sigmas = _t(sig)
    st = D.dpm_state_init(2, z.shape, device="cpu")
    for i in range(5):
        z, _, _, st = R.rollout_step(cfg, model, z, st, sigmas=sigmas, step_index=i,
                                     num_steps=n, deterministic=bool(det[i]),
                                     last_sde_index=4, noise=torch.zeros_like(z))
    assert st.lower_order_nums == 2
    second, _, _, _ = R.rollout_step(cfg, model, z, st, sigmas=sigmas, step_index=5,
                                     num_steps=n, deterministic=True, last_sde_index=4,
                                     noise=torch.zeros_like(z))
    first, _, _, _ = R.rollout_step(cfg, model, z, st._replace(lower_order_nums=0),
                                    sigmas=sigmas, step_index=5, num_steps=n,
                                    deterministic=True, last_sde_index=4,
                                    noise=torch.zeros_like(z))
    assert not torch.allclose(second, first)
    _, lp, _, same = R.rollout_step(cfg, model, z, st, sigmas=sigmas, step_index=n,
                                    num_steps=n, deterministic=True, last_sde_index=4,
                                    noise=torch.zeros_like(z))
    assert same is st and (lp == 0).all()


def test_flux_sampler_flash_rollout_matches_jax():
    """Tiny FLUX, MixGRPO-Flash: window [2, 3] of 8 steps, DPM-Solver++
    order-2 tail compressed by 0.6 and padded, two chunks of two rows (each
    chunk has its own ring buffer), JAX's draws per chunk."""
    jcfg, cfg = JM.FluxConfig.tiny(), M.FluxConfig.tiny()
    params = M.init_flux(cfg, generator=torch.Generator().manual_seed(2), device="cpu")
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    kw = dict(height=32, width=32, text_len=8, guidance_scale=3.5)
    skw = dict(num_steps_max=8, eta=0.7, dpm_algorithm_type="dpmsolver++")
    js = JS.FluxSampler(jcfg, JR.SamplerConfig(**skw), dtype=jnp.float32, attn_impl="xla",
                        **kw)
    ts = S.FluxSampler(cfg, R.SamplerConfig(**skw), dtype=torch.float32, attn_impl="eager",
                       device="cpu", **kw)
    sig, n, det = _flash(8, [2, 3], 0.6)
    assert n == 6
    rng = np.random.default_rng(4)
    z0 = rng.standard_normal((4, ts.num_image_tokens, cfg.in_channels)).astype(np.float32)
    txt = rng.standard_normal((4, 8, cfg.context_dim)).astype(np.float32)
    pooled = rng.standard_normal((4, cfg.pooled_dim)).astype(np.float32)
    key = jax.random.key(11)
    want = js.chunked_rollout(jparams, *map(jnp.asarray, (z0, txt, pooled)), sig, det, n, key,
                              chunk=2)

    def noise(j, i, shape):
        k = jax.random.fold_in(key, j)
        return np.array(jax.random.normal(jax.random.fold_in(k, i), shape, jnp.float32))

    got = ts.chunked_rollout(from_jax_params(jax.tree.map(np.asarray, jparams), "cpu"),
                             *map(_t, (z0, txt, pooled)), sig, det, n, chunk=2, noise_fn=noise)
    np.testing.assert_allclose(got.all_latents.numpy(), _np(want.all_latents), rtol=0,
                               atol=2e-4)
    np.testing.assert_allclose(got.all_log_probs.numpy(), _np(want.all_log_probs),
                               rtol=1e-4, atol=2e-4)

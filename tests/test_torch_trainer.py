"""Port's update step, optimizer, chunked rollout and training utilities vs
the JAX package, on a tiny fp32 FLUX with the same weights on both sides.

Tolerances: the log-prob recompute and the batch gather within 1e-5 (the
same f32 step math); model outputs and the rollout within 2e-4 (the model's
matmuls sum in another order); loss within 1e-5 and grad_norm within 1e-4
relative; parameters after AdamW steps within 2e-5 absolute at a rate of
1e-4 (each step moves a weight by at most about the rate, and grads agree to
~1e-5 relative, so only the last digits of the step differ); learning rates
read back from one optax AdamW update of a unit grad, within 2e-4 relative
and 1e-9 absolute (its f32 bias correction; rates are 1e-3 at most); EMA
within 1e-6.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixgrpo_tpu import config as JC
from mixgrpo_tpu import sampler as JS
from mixgrpo_tpu import trainer as JT
from mixgrpo_tpu.data import dataset as JD
from mixgrpo_tpu.models.flux import model as JM
from mixgrpo_tpu.rl.ppo import PPOConfig as JPPO
from mixgrpo_tpu.solvers import rollout as JR
from mixgrpo_tpu.utils import ema as JE
from mixgrpo_tpu_torch import config as C
from mixgrpo_tpu_torch import sampler as S
from mixgrpo_tpu_torch import trainer as T
from mixgrpo_tpu_torch.convert import from_jax_params
from mixgrpo_tpu_torch.data import dataset as D
from mixgrpo_tpu_torch.models.flux import model as M
from mixgrpo_tpu_torch.rl.ppo import PPOConfig
from mixgrpo_tpu_torch.solvers import rollout as R
from mixgrpo_tpu_torch.solvers.schedule import sigma_schedule
from mixgrpo_tpu_torch.utils import ema as E

RES, TEXT_LEN = 32, 8


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.fixture(scope="module")
def tiny():
    """Tiny FLUX weights for both sides, drawn by the port's initializer
    (its tree has the JAX layout), as numpy."""
    jcfg, cfg = JM.FluxConfig.tiny(), M.FluxConfig.tiny()
    params = M.init_flux(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    return jcfg, cfg, jax.tree.map(lambda t: t.numpy(), params)


def _samplers(jcfg, cfg, T_steps=4):
    kw = dict(height=RES, width=RES, text_len=TEXT_LEN, guidance_scale=3.5)
    js = JS.FluxSampler(jcfg, JR.SamplerConfig(num_steps_max=T_steps, eta=0.7),
                        dtype=jnp.float32, attn_impl="xla", **kw)
    ts = S.FluxSampler(cfg, R.SamplerConfig(num_steps_max=T_steps, eta=0.7),
                       dtype=torch.float32, attn_impl="eager", device="cpu", **kw)
    return js, ts


def _rollout_inputs(cfg, ts):
    rng = np.random.default_rng(6)
    z0 = rng.standard_normal((4, ts.num_image_tokens, cfg.in_channels)).astype(np.float32)
    txt = rng.standard_normal((4, TEXT_LEN, cfg.context_dim)).astype(np.float32)
    pooled = rng.standard_normal((4, cfg.pooled_dim)).astype(np.float32)
    sig = np.array([1.0, 0.7, 0.4, 0.2, 0.0], np.float32)
    det = np.array([False, False, True, True])
    return z0, txt, pooled, sig, det


def _batch(cfg, N, seed=1):
    rng = np.random.default_rng(seed)
    L = (RES // 16) ** 2
    lat = rng.standard_normal((N, L, cfg.in_channels)).astype(np.float32)
    return dict(
        latents=lat, next_latents=lat + 0.05 * rng.standard_normal(lat.shape).astype(np.float32),
        t_index=np.arange(N) % 3, old_log_probs=rng.normal(0, 0.01, N).astype(np.float32),
        advantages=rng.standard_normal(N).astype(np.float32),
        txt=rng.standard_normal((N, TEXT_LEN, cfg.context_dim)).astype(np.float32),
        pooled=rng.standard_normal((N, cfg.pooled_dim)).astype(np.float32))


@pytest.mark.parametrize("flow", [True, False])
def test_recompute_log_prob_matches_jax(flow):
    rng = np.random.default_rng(2)
    pred, lat, nxt = (rng.standard_normal((5, 6, 8)).astype(np.float32) for _ in range(3))
    sig = sigma_schedule(6, 3.0)
    t_idx = np.array([0, 1, 2, 4, 5])
    jcfg = JR.SamplerConfig(num_steps_max=6, eta=0.7, flow_grpo_sampling=flow)
    cfg = R.SamplerConfig(num_steps_max=6, eta=0.7, flow_grpo_sampling=flow)
    want = JT.recompute_log_prob(jcfg, *map(jnp.asarray, (pred, lat, nxt, sig)),
                                 jnp.asarray(t_idx))
    got = T.recompute_log_prob(cfg, _t(pred), _t(lat), _t(nxt), _t(sig),
                               torch.as_tensor(t_idx))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError):
        T.recompute_log_prob(R.SamplerConfig(num_steps_max=6, dpm_algorithm_type="dpmsolver",
                                             dpm_apply_strategy="all"),
                             _t(pred), _t(lat), _t(nxt), _t(sig), torch.as_tensor(t_idx))


def test_build_update_batch_matches_jax():
    rng = np.random.default_rng(3)
    lat = rng.standard_normal((4, 7, 5, 3)).astype(np.float32)
    lps = rng.standard_normal((4, 6)).astype(np.float32)
    adv, txt, pooled = (rng.standard_normal(s).astype(np.float32)
                        for s in ((4,), (4, 2, 3), (4, 5)))
    sidx, tidx = np.repeat([2, 0], 3), np.tile([1, 3, 4], 2)
    want = JT.build_update_batch(lat, lps, adv, txt, pooled, sidx, tidx)
    got = T.build_update_batch(*map(_t, (lat, lps, adv, txt, pooled)), sidx, tidx)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["constant", "constant_with_warmup", "linear", "cosine",
                                  "cosine_with_restarts", "polynomial"])
def test_lr_schedules_match_optax(name):
    """The rate of update ``count`` equals optax's ``scale_by_schedule`` rate;
    one update of a unit grad through optax's chain gives it back."""
    kw = dict(learning_rate=1e-3, lr_scheduler=name, warmup_steps=5, total_steps=40,
              lr_num_cycles=3, lr_power=2.0)
    sched = T.make_schedule(**kw)
    jopt = JT.make_optimizer(weight_decay=0.0, max_grad_norm=1e9, **kw)
    p = {"w": jnp.zeros(())}
    st = jopt.init(p)
    update = jax.jit(jopt.update)
    for count in range(48):
        # Adam's bias-corrected moment ratio is 1 for a constant unit grad,
        # so the update is -rate, up to f32: 1 - 0.999**t cancels to ~1e-4
        # relative at small t, and a zero rate comes out as ~1e-11
        up, st = update({"w": jnp.ones(())}, st, p)
        np.testing.assert_allclose(-float(up["w"]), sched(count), rtol=2e-4, atol=1e-9)


def _jax_update_fns(jcfg, js, lr, max_norm, warmup):
    opt = JT.make_optimizer(learning_rate=lr, weight_decay=1e-2, max_grad_norm=max_norm,
                            warmup_steps=warmup)
    fns = JT.make_update_fns(jcfg, js.sampler_cfg, JPPO(clip_range=0.2), opt, js.rope_cos,
                             js.rope_sin, dtype=jnp.float32, attn_impl="xla", remat=False)
    return opt, fns


def test_update_steps_match_jax_with_clipping_and_warmup(tiny):
    """Three update steps of 6 pairs: loss, grad_norm (before clipping) and
    the parameters after each AdamW step.  max_grad_norm is far below the
    grads' norm, so the clip is active; warmup 2 makes the first step's rate
    0 (a no-op on the parameters, the moments still move)."""
    jcfg, cfg, jnp_params = tiny
    js, ts = _samplers(jcfg, cfg)
    lr, max_norm, warmup = 1e-4, 1e-4, 2
    jopt, (jstep, _, _) = _jax_update_fns(jcfg, js, lr, max_norm, warmup)
    opt = T.make_optimizer(learning_rate=lr, weight_decay=1e-2, max_grad_norm=max_norm,
                           warmup_steps=warmup)
    step, _, _ = T.make_update_fns(cfg, ts.sampler_cfg, PPOConfig(clip_range=0.2), opt,
                                   ts.rope_cos, ts.rope_sin, dtype=torch.float32,
                                   attn_impl="eager", remat=True)
    jparams = jax.tree.map(jnp.asarray, jnp_params)
    jstate = jopt.init(jparams)
    params = from_jax_params(jnp_params, "cpu")
    state = opt.init(params)
    sig = sigma_schedule(4, 3.0)
    before = [t.detach().clone() for t in M.param_leaves(params)]
    for it in range(3):
        b = _batch(cfg, 6, seed=10 + it)
        jb = JT.UpdateBatch(**{k: jnp.asarray(v) for k, v in b.items()})
        tb = T.UpdateBatch(**{k: torch.as_tensor(v) for k, v in b.items()})
        jparams, jstate, jm = jstep(jparams, jstate, jb, jnp.asarray(sig))
        params, state, m = step(params, state, tb, _t(sig))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        assert float(m["grad_norm"]) > 10 * max_norm  # the clip is active
        for a, w in zip(M.param_leaves(params), jax.tree.leaves(jparams)):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(w), rtol=0, atol=2e-5)
        if it == 0:  # warmup: rate 0 at count 0
            assert all(torch.equal(a, b) for a, b in zip(M.param_leaves(params), before))
    assert state.param_groups[0]["count"] == 3
    assert not all(torch.equal(a, b) for a, b in zip(M.param_leaves(params), before))


def test_accumulated_update_matches_single_batch(tiny):
    """Two half-group ``accum_step``s then ``apply_step`` equal one
    ``update_step`` over the whole group (as JAX's own test checks)."""
    jcfg, cfg, jnp_params = tiny
    _, ts = _samplers(jcfg, cfg)
    opt = T.make_optimizer(learning_rate=1e-3)
    step, accum, apply = T.make_update_fns(cfg, ts.sampler_cfg, PPOConfig(clip_range=0.2),
                                           opt, ts.rope_cos, ts.rope_sin,
                                           dtype=torch.float32, attn_impl="eager",
                                           remat=False)
    b = {k: torch.as_tensor(v) for k, v in _batch(cfg, 6).items()}
    sig = _t(sigma_schedule(4, 3.0))
    pa = from_jax_params(jnp_params, "cpu")
    pa, _, _ = step(pa, opt.init(pa), T.UpdateBatch(**b), sig)
    pb = from_jax_params(jnp_params, "cpu")
    acc = E.ema_init(pb)
    for a in M.param_leaves(acc):
        a.zero_()
    for half in (slice(0, 3), slice(3, 6)):
        acc, _ = accum(pb, acc, T.UpdateBatch(**{k: v[half] for k, v in b.items()}), sig, 0.5)
    pb, _, acc, gn = apply(pb, opt.init(pb), acc)
    assert np.isfinite(float(gn)) and all((a == 0).all() for a in M.param_leaves(acc))
    for x, y in zip(M.param_leaves(pa), M.param_leaves(pb)):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(), rtol=2e-4,
                                   atol=2e-5)


def test_remat_and_virtual_depth_match_jax(tiny):
    """``flux_forward`` with per-block recompute and virtual_depth (4, 6)
    over the 2 + 4 tiny stacks (double: 4 % 2 == 0, JAX's cycle_scan; single:
    6 % 4 != 0, JAX's gathered scan): output and every parameter's gradient
    of sum(out * w) against JAX's (without remat there, which changes no
    value)."""
    jcfg, cfg, jnp_params = tiny
    js, ts = _samplers(jcfg, cfg)
    b = _batch(cfg, 2, seed=4)
    w = np.random.default_rng(5).standard_normal(b["latents"].shape).astype(np.float32)
    tq = np.array([0.7, 0.3], np.float32)
    g = np.full((2,), 3.5, np.float32)

    def jloss(p):
        out = JM.flux_forward(p, jcfg, jnp.asarray(b["latents"]), jnp.asarray(b["txt"]),
                              jnp.asarray(b["pooled"]), jnp.asarray(tq), jnp.asarray(g),
                              js.rope_cos, js.rope_sin, dtype=jnp.float32, attn_impl="xla",
                              remat=False, virtual_depth=(4, 6))
        return jnp.sum(out * w), out

    (_, jout), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, jnp_params))
    params = from_jax_params(jnp_params, "cpu")
    for t in M.param_leaves(params):
        t.requires_grad_(True)
    out = M.flux_forward(params, cfg, _t(b["latents"]), _t(b["txt"]), _t(b["pooled"]),
                         _t(tq), _t(g), ts.rope_cos, ts.rope_sin, dtype=torch.float32,
                         attn_impl="eager", remat=True, virtual_depth=(4, 6))
    (out * _t(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=0, atol=2e-4)
    for a, gj in zip(M.param_leaves(params), jax.tree.leaves(jgrad)):
        scale = max(float(np.abs(np.asarray(gj)).max()), 1e-3)
        np.testing.assert_allclose(a.grad.numpy() / scale, np.asarray(gj) / scale,
                                   rtol=0, atol=2e-4)


def test_chunked_rollout_matches_jax(tiny):
    """4 rows in chunks of 2: two calls, chunk j's SDE noise JAX's
    normal(fold_in(fold_in(rng, j), i)); latents and log-probs in row order
    against JAX's ``chunked_rollout``."""
    jcfg, cfg, jnp_params = tiny
    js, ts = _samplers(jcfg, cfg)
    z0, txt, pooled, sig, det = _rollout_inputs(cfg, ts)
    key = jax.random.key(12)
    want = js.chunked_rollout(jax.tree.map(jnp.asarray, jnp_params),
                              *map(jnp.asarray, (z0, txt, pooled)), sig, det, 4, key, chunk=2)

    def noise(j, i, shape):
        k = jax.random.fold_in(key, j)
        return np.array(jax.random.normal(jax.random.fold_in(k, i), shape, jnp.float32))

    calls = []
    rollout = ts.rollout
    ts.rollout = lambda *a, **k: calls.append(a[1].shape[0]) or rollout(*a, **k)
    got = ts.chunked_rollout(from_jax_params(jnp_params, "cpu"), *map(_t, (z0, txt, pooled)),
                             sig, det, 4, chunk=2, noise_fn=noise)
    assert calls == [2, 2]
    np.testing.assert_allclose(got.all_latents.numpy(), _np(want.all_latents), rtol=0,
                               atol=2e-4)
    np.testing.assert_allclose(got.all_log_probs.numpy(), _np(want.all_log_probs),
                               rtol=1e-4, atol=2e-4)
    np.testing.assert_allclose(got.final_latents.numpy(), _np(want.final_latents), rtol=0,
                               atol=2e-4)


def test_chunked_rollout_falls_back_to_one_call(tiny):
    """A chunk that does not split the group (3 of 4 rows) runs one rollout,
    equal to ``rollout`` itself, its noise_fn called with chunk None (JAX
    then draws from its unfolded key)."""
    _, cfg, jnp_params = tiny
    _, ts = _samplers(JM.FluxConfig.tiny(), cfg)
    z0, txt, pooled, sig, det = _rollout_inputs(cfg, ts)
    params = from_jax_params(jnp_params, "cpu")
    draws = np.random.default_rng(13).standard_normal((4, *z0.shape)).astype(np.float32)
    seen = []
    got = ts.chunked_rollout(params, *map(_t, (z0, txt, pooled)), sig, det, 4, chunk=3,
                             noise_fn=lambda j, i, shape: seen.append(j) or draws[i])
    want = ts.rollout(params, *map(_t, (z0, txt, pooled)), sig, det, 4,
                      noise_fn=lambda i, shape: draws[i])
    assert set(seen) == {None}
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)


def test_ema_matches_jax():
    rng = np.random.default_rng(7)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    new = jax.tree.map(lambda x: x + 1.0, tree)
    je = JE.ema_init(jax.tree.map(jnp.asarray, tree))
    te = E.ema_init(from_jax_params(tree, "cpu"))
    for step in range(3):
        je = JE.ema_update(je, jax.tree.map(jnp.asarray, new), 0.9, step=step, start_step=1)
        E.ema_update(te, from_jax_params(new, "cpu"), 0.9, step=step, start_step=1)
    for a, b in zip(M.param_leaves(te), jax.tree.leaves(je)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_config_cli_matches_jax():
    """Same flag names and defaults; one command line parses to the same
    config on both sides."""
    jp, tp = JC.build_arg_parser(), C.build_arg_parser()
    flags = lambda p: sorted(a.dest for a in p._actions if not isinstance(a, argparse._HelpAction))
    assert flags(tp) == flags(jp)
    argv = ["--num_generations", "6", "--no-use_group", "--learning_rate", "3e-6",
            "--sample_strategy", "decay", "--resume_from_checkpoint", "None"]
    jcfg, tcfg = (m.config_from_args(p.parse_args(argv))
                  for m, p in ((JC, jp), (C, tp)))
    assert tcfg.to_json() == jcfg.to_json()
    assert C.window_state_from_config(tcfg).to_dict() == \
        JC.window_state_from_config(jcfg).to_dict()
    assert tcfg.sampler_config().num_steps_max == 25 and tcfg.ppo_config().clip_range == 1e-4


def test_embedding_cache_interchanges_with_jax(tmp_path):
    """The port's numpy safetensors shards read in JAX's loader and JAX's in
    the port's, with cfg dropout and the loader's batch order equal."""
    rng = np.random.default_rng(8)
    rows = [(rng.standard_normal((4, 6)), rng.standard_normal(3)) for _ in range(7)]
    for Writer, d in ((D.EmbeddingCacheWriter, "port"), (JD.EmbeddingCacheWriter, "jax")):
        w = Writer(str(tmp_path / d), shard_size=3)
        for i, (e, p) in enumerate(rows):
            w.add(e, p, f"p{i}")
        w.finish()
    for d in ("port", "jax"):
        jl = JD.PromptLoader(JD.LatentDataset(str(tmp_path / d), cfg_rate=0.3, seed=1,
                                              use_native=False), 2, seed=3)
        tl = D.PromptLoader(D.LatentDataset(str(tmp_path / d), cfg_rate=0.3, seed=1), 2,
                            seed=3)
        for _, x, y in zip(range(8), jl, tl):
            assert x["captions"] == y["captions"]
            np.testing.assert_array_equal(x["prompt_embed"], y["prompt_embed"])
            np.testing.assert_array_equal(x["pooled"], y["pooled"])

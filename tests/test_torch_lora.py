"""Port's LoRA adapters and LoRA update vs the JAX package, on a tiny fp32
FLUX with the same weights on both sides.

Tolerances: merged weights within 1e-6 (one rank-r product and an add, f32);
model outputs within 2e-4 and factor gradients within 2e-4 of their scale
(the model's matmuls sum in another order); after AdamW steps at a rate of
1e-4, factors within 2e-5 absolute, loss within 1e-5 and grad_norm within
1e-4 relative (as the full-parameter update tests); files bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixgrpo_tpu import lora as JL
from mixgrpo_tpu import sampler as JS
from mixgrpo_tpu import trainer as JT
from mixgrpo_tpu.models.flux import model as JM
from mixgrpo_tpu.rl.ppo import PPOConfig as JPPO
from mixgrpo_tpu.solvers import rollout as JR
from mixgrpo_tpu_torch import lora as L
from mixgrpo_tpu_torch import sampler as S
from mixgrpo_tpu_torch import trainer as T
from mixgrpo_tpu_torch.convert import from_jax_params
from mixgrpo_tpu_torch.models.flux import model as M
from mixgrpo_tpu_torch.rl.ppo import PPOConfig
from mixgrpo_tpu_torch.solvers import rollout as R
from mixgrpo_tpu_torch.solvers.schedule import sigma_schedule

RES, TEXT_LEN = 32, 8


@pytest.fixture(scope="module")
def tiny():
    """Tiny FLUX weights (the port's initializer, JAX layout) and a JAX
    adapter of rank 4, alpha 8 whose ``b`` factors are made nonzero, all as
    numpy."""
    cfg = M.FluxConfig.tiny()
    params = M.init_flux(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    np_params = jax.tree.map(lambda t: t.numpy(), params)
    lora = JL.init_lora(jax.random.key(3), jax.tree.map(jnp.asarray, np_params), rank=4,
                        alpha=8.0)
    rng = np.random.default_rng(4)
    factors = {p: {"a": np.asarray(f["a"]),
                   "b": 0.05 * rng.standard_normal(f["b"].shape).astype(np.float32)}
               for p, f in lora["factors"].items()}
    return cfg, np_params, factors


def _jlora(factors):
    return {"factors": jax.tree.map(jnp.asarray, factors), "rank": 4, "alpha": 8.0}


def _tlora(factors):
    return {"factors": from_jax_params(factors, "cpu"), "rank": 4, "alpha": 8.0}


def test_init_lora_targets_and_shapes_match_jax(tiny):
    cfg, np_params, _ = tiny
    want = JL.init_lora(jax.random.key(0), jax.tree.map(jnp.asarray, np_params), rank=3)
    got = L.init_lora(torch.Generator().manual_seed(0), from_jax_params(np_params, "cpu"),
                      rank=3)
    assert list(got["factors"]) == sorted(want["factors"])
    assert "double/img_qkv/w" in got["factors"] and "single/linear2/w" in got["factors"]
    assert (got["rank"], got["alpha"]) == (want["rank"], want["alpha"])
    for p, f in got["factors"].items():
        for k in ("a", "b"):
            assert tuple(f[k].shape) == want["factors"][p][k].shape and f[k].dtype == torch.float32
        assert (f["b"] == 0).all()
        din = f["a"].shape[-2]
        assert abs(float(f["a"].std()) * din ** 0.5 - 1.0) < 0.2  # N(0, 1/in)
    # 12 double-block targets (img/txt x qkv, attn_out, mlp_in, mlp_out), 2 single
    assert len(got["factors"]) == 10


def test_apply_lora_matches_jax(tiny):
    cfg, np_params, factors = tiny
    want = JL.apply_lora(jax.tree.map(jnp.asarray, np_params), _jlora(factors))
    got = L.apply_lora(from_jax_params(np_params, "cpu"), _tlora(factors))
    for a, w in zip(M.param_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    merged = L.merge_lora(from_jax_params(np_params, "cpu"), _tlora(factors))
    assert all(torch.equal(a, b) for a, b in zip(M.param_leaves(merged), M.param_leaves(got)))


def _inputs(cfg):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, (RES // 16) ** 2, cfg.in_channels)).astype(np.float32)
    txt = rng.standard_normal((2, TEXT_LEN, cfg.context_dim)).astype(np.float32)
    pooled = rng.standard_normal((2, cfg.pooled_dim)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    tq, g = np.array([0.7, 0.3], np.float32), np.full((2,), 3.5, np.float32)
    ts = S.FluxSampler(cfg, R.SamplerConfig(num_steps_max=4), height=RES, width=RES,
                       text_len=TEXT_LEN, dtype=torch.float32, device="cpu")
    return (x, txt, pooled, tq, g), w, ts


def test_lora_blocks_forward_and_grads_match_jax(tiny):
    """``flux_forward`` with ``lora_blocks`` (each block merges its own
    factors) equals JAX's forward on ``apply_lora``, and the factors'
    gradients of sum(out * w) agree, with per-block recompute on the port's
    side."""
    cfg, np_params, factors = tiny
    jcfg = JM.FluxConfig.tiny()
    inputs, w, ts = _inputs(cfg)
    jparams = jax.tree.map(jnp.asarray, np_params)

    def jloss(f):
        out = JM.flux_forward(JL.apply_lora(jparams, {**_jlora(factors), "factors": f}), jcfg,
                              *map(jnp.asarray, inputs),
                              jnp.asarray(ts.rope_cos.numpy()), jnp.asarray(ts.rope_sin.numpy()),
                              dtype=jnp.float32, attn_impl="xla")
        return jnp.sum(out * w), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(_jlora(factors)["factors"])
    lora = _tlora(factors)
    leaves = [t.requires_grad_(True) for t in M.param_leaves(lora["factors"])]
    tree, merge_block = L.lora_blocks(from_jax_params(np_params, "cpu"), lora)
    out = M.flux_forward(tree, cfg, *map(torch.from_numpy, inputs), ts.rope_cos, ts.rope_sin,
                         dtype=torch.float32, attn_impl="eager", remat=True,
                         block_params=merge_block)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=0, atol=2e-4)
    for a, gj in zip(grads, jax.tree.leaves(jgrad)):
        scale = max(float(np.abs(np.asarray(gj)).max()), 1e-3)
        np.testing.assert_allclose(a.numpy() / scale, np.asarray(gj) / scale, rtol=0, atol=2e-4)
    with torch.no_grad():
        merged = M.flux_forward(L.apply_lora(from_jax_params(np_params, "cpu"), lora), cfg,
                                *map(torch.from_numpy, inputs), ts.rope_cos, ts.rope_sin,
                                dtype=torch.float32, attn_impl="eager")
    np.testing.assert_allclose(merged.numpy(), out.detach().numpy(), rtol=0, atol=1e-5)


def test_lora_blocks_merges_targets_outside_the_stacks(tiny):
    """A target outside the block stacks (``proj_out``) is merged into the
    tree ``lora_blocks`` returns, the stacks are left to the per-block merge,
    and the forward equals the one on ``apply_lora``."""
    cfg, np_params, _ = tiny
    params = from_jax_params(np_params, "cpu")
    lora = L.init_lora(torch.Generator().manual_seed(2), params, rank=4, alpha=8.0,
                       targets=L.DEFAULT_TARGETS + "|proj_out/w$")
    gb = torch.Generator().manual_seed(3)
    for f in lora["factors"].values():
        f["b"].normal_(0.0, 0.05, generator=gb)
    tree, merge_block = L.lora_blocks(params, lora)
    assert not torch.equal(tree["proj_out"]["w"], params["proj_out"]["w"])
    assert tree["double"]["img_qkv"]["w"] is params["double"]["img_qkv"]["w"]
    merged = L.apply_lora(params, lora)
    np.testing.assert_array_equal(tree["proj_out"]["w"].numpy(),
                                  merged["proj_out"]["w"].numpy())
    inputs, _, ts = _inputs(cfg)
    with torch.no_grad():
        got = M.flux_forward(tree, cfg, *map(torch.from_numpy, inputs), ts.rope_cos,
                             ts.rope_sin, dtype=torch.float32, attn_impl="eager",
                             block_params=merge_block)
        want = M.flux_forward(merged, cfg, *map(torch.from_numpy, inputs), ts.rope_cos,
                              ts.rope_sin, dtype=torch.float32, attn_impl="eager")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"),
                                           ("port", "port")])
def test_lora_files_interchange_with_jax(tmp_path, tiny, writer, reader):
    _, _, factors = tiny
    path = str(tmp_path / "adapter.safetensors")
    if writer == "jax":
        JL.save_lora(_jlora(factors), path)
    else:
        L.save_lora(_tlora(factors), path)
    got = JL.load_lora(path) if reader == "jax" else L.load_lora(path, device="cpu")
    assert (got["rank"], got["alpha"]) == (4, 8.0)
    assert sorted(got["factors"]) == sorted(factors)
    for p, f in factors.items():
        for k in ("a", "b"):
            np.testing.assert_array_equal(np.asarray(got["factors"][p][k]), f[k])


def test_lora_update_steps_match_jax(tiny):
    """Two LoRA update steps of 6 pairs (clip active): loss, grad_norm over
    the factors, and the factors after each AdamW step; the base tree is
    left bit for bit and gets no grad."""
    cfg, np_params, factors = tiny
    jcfg = JM.FluxConfig.tiny()
    kw = dict(height=RES, width=RES, text_len=TEXT_LEN, guidance_scale=3.5)
    js = JS.FluxSampler(jcfg, JR.SamplerConfig(num_steps_max=4, eta=0.7), dtype=jnp.float32,
                        attn_impl="xla", **kw)
    ts = S.FluxSampler(cfg, R.SamplerConfig(num_steps_max=4, eta=0.7), dtype=torch.float32,
                       attn_impl="eager", device="cpu", **kw)
    okw = dict(learning_rate=1e-4, weight_decay=1e-2, max_grad_norm=2e-5)
    jopt, opt = JT.make_optimizer(**okw), T.make_optimizer(**okw)
    jstep = JT.make_lora_update_fns(jcfg, js.sampler_cfg, JPPO(clip_range=0.2), jopt,
                                    js.rope_cos, js.rope_sin, dtype=jnp.float32,
                                    attn_impl="xla", remat=False)
    step = T.make_lora_update_fns(cfg, ts.sampler_cfg, PPOConfig(clip_range=0.2), opt,
                                  ts.rope_cos, ts.rope_sin, dtype=torch.float32,
                                  attn_impl="eager", remat=True)
    jbase = jax.tree.map(jnp.asarray, np_params)
    jf = _jlora(factors)["factors"]
    jstate = jopt.init(jf)
    base = from_jax_params(np_params, "cpu")
    before = [t.clone() for t in M.param_leaves(base)]
    tf = _tlora(factors)["factors"]
    state = opt.init(tf)
    meta = {"rank": 4, "alpha": 8.0}
    sig = sigma_schedule(4, 3.0)
    rng = np.random.default_rng(9)
    for it in range(2):
        N, Lt = 6, (RES // 16) ** 2
        lat = rng.standard_normal((N, Lt, cfg.in_channels)).astype(np.float32)
        b = dict(latents=lat,
                 next_latents=lat + 0.05 * rng.standard_normal(lat.shape).astype(np.float32),
                 t_index=np.arange(N) % 3, old_log_probs=rng.normal(0, 0.01, N).astype(np.float32),
                 advantages=rng.standard_normal(N).astype(np.float32),
                 txt=rng.standard_normal((N, TEXT_LEN, cfg.context_dim)).astype(np.float32),
                 pooled=rng.standard_normal((N, cfg.pooled_dim)).astype(np.float32))
        jf, jstate, jm = jstep(jf, jstate, meta, jbase,
                               JT.UpdateBatch(**{k: jnp.asarray(v) for k, v in b.items()}),
                               jnp.asarray(sig))
        tf, state, m = step(tf, state, meta, base,
                            T.UpdateBatch(**{k: torch.as_tensor(v) for k, v in b.items()}),
                            torch.from_numpy(sig))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        assert float(m["grad_norm"]) > 10 * okw["max_grad_norm"]  # the clip is active
        for a, w in zip(M.param_leaves(tf), jax.tree.leaves(jf)):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(w), rtol=0, atol=2e-5)
    assert state.param_groups[0]["count"] == 2
    assert all(torch.equal(a, b) and a.grad is None and not a.requires_grad
               for a, b in zip(M.param_leaves(base), before))

"""The port's whole training slice on a tiny fp32 FLUX + VAE.

``test_iteration_matches_jax``: one ``GRPOTrainer.train_one_step`` of the
port against the JAX functions that JAX's ``train_one_step`` calls, in the
same order (``chunked_rollout``, VAE decode, the reward, masked reward and
advantage mixing, ``build_update_batch``, ``update_step`` per accumulation
group), on the same weights and prompts, with JAX's initial noise and SDE
draws handed to the port.  Strategy "part" with no reordering ("null"), so no
host shuffle enters.  Tolerances: rollout latents and log-probs within 2e-4
(the model's matmuls sum in another order), images and rewards within 1e-4,
advantages within 1e-3 (they divide reward differences by the group's std),
grad_norm and the ratio within 1e-4 relative, the loss within 5e-5 absolute
(it is a mean of -A exp(new - old log-prob), and new - old is each side's
own ~1e-5 recompute noise), parameters after the iteration's two AdamW steps
within 2e-5 at a rate of 1e-4.  Both sides take the same weights, drawn by
the port's initializers (the trees have the JAX layout).

``test_two_iterations_checkpoint_resume_and_ema``: the port alone: two
iterations through ``train`` with EMA, a periodic background checkpoint and
the final one, a resume into a new trainer (parameters, optimizer count,
EMA, window and step restored) and one more iteration; and a rerun from the
same seeds repeats an iteration's metrics exactly.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixgrpo_tpu import sampler as JS
from mixgrpo_tpu import trainer as JT
from mixgrpo_tpu.models.flux import latents as JL
from mixgrpo_tpu.models.flux import model as JM
from mixgrpo_tpu.models.flux import vae as JV
from mixgrpo_tpu.rl import advantage as JA
from mixgrpo_tpu.rl.ppo import PPOConfig as JPPO
from mixgrpo_tpu.solvers import rollout as JR
from mixgrpo_tpu.solvers.schedule import deterministic_mask, sigma_schedule
from mixgrpo_tpu_torch.config import (
    DataConfig, GRPOConfig, OptimConfig, RunConfig, TrainConfig, WindowConfig,
)
from mixgrpo_tpu_torch.convert import from_jax_params
from mixgrpo_tpu_torch.data.dataset import EmbeddingCacheWriter, LatentDataset, PromptLoader
from mixgrpo_tpu_torch.models.flux import model as M
from mixgrpo_tpu_torch.models.flux.vae import VAEConfig, init_vae_decoder
from mixgrpo_tpu_torch.train import GRPOTrainer

RES, TEXT_LEN, T_STEPS, G = 32, 8, 6, 4


def _cfg(tmp_path, checkpointing_steps=100, **optim):
    return TrainConfig(
        data=DataConfig(train_batch_size=1),
        optim=OptimConfig(gradient_accumulation_steps=2, learning_rate=1e-4,
                          weight_decay=1e-2, **optim),
        grpo=GRPOConfig(h=RES, w=RES, sampling_steps=T_STEPS, num_generations=G,
                        rollout_chunk=2, clip_range=0.2, advantage_rerange_strategy="null",
                        timestep_fraction=0.5),
        window=WindowConfig(iters_per_group=2, group_size=2, prog_overlap=False),
        run=RunConfig(output_dir=str(tmp_path / "out"),
                      checkpointing_steps=checkpointing_steps, export_safetensors="off"))


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy(v) for v in tree)
    return tree.numpy()


@pytest.fixture(scope="module")
def weights():
    jcfg = JM.FluxConfig.tiny()
    jvcfg = JV.VAEConfig.tiny(latent_channels=jcfg.in_channels // 4)
    params = M.init_flux(M.FluxConfig.tiny(), generator=torch.Generator().manual_seed(0),
                         device="cpu")
    vae = init_vae_decoder(VAEConfig.tiny(latent_channels=jcfg.in_channels // 4),
                           generator=torch.Generator().manual_seed(5), device="cpu")
    return jcfg, jvcfg, _numpy(params), _numpy(vae)


def _brightness_torch(images01, captions):
    r = images01.float().mean(dim=(1, 2, 3)).cpu().numpy().astype(np.float64)
    return {"synthetic": r}, {"synthetic": np.ones_like(r)}


def _trainer(cfg, weights, **kw):
    jcfg, jvcfg, jparams, jvae = weights
    tr = GRPOTrainer(cfg, flux_cfg=M.FluxConfig.tiny(), params=from_jax_params(jparams, "cpu"),
                     vae_cfg=VAEConfig.tiny(latent_channels=jcfg.in_channels // 4),
                     vae_params=from_jax_params(jvae, "cpu"), reward_fn=_brightness_torch,
                     text_len=TEXT_LEN, attn_impl="eager", dtype=torch.float32, device="cpu",
                     **kw)
    tr.reward_weights = {"synthetic": 1.0}
    return tr


def _prompt(seed=0):
    rng = np.random.default_rng(seed)
    cfg = M.FluxConfig.tiny()
    return {"prompt_embed": rng.standard_normal((1, TEXT_LEN, cfg.context_dim)).astype(np.float32),
            "pooled": rng.standard_normal((1, cfg.pooled_dim)).astype(np.float32),
            "captions": ["a tiny prompt"]}


def test_iteration_matches_jax(tmp_path, weights):
    jcfg, jvcfg, jparams_np, jvae_np = weights
    cfg = _cfg(tmp_path)
    tr = _trainer(cfg, weights)
    batch = _prompt()
    ts = tr.window.get_current_timesteps()
    B = G

    # -- JAX, in the order of its train_one_step --------------------------------
    jparams = jax.tree.map(jnp.asarray, jparams_np)
    txt = jnp.asarray(np.repeat(batch["prompt_embed"], G, axis=0))
    pooled = jnp.asarray(np.repeat(batch["pooled"], G, axis=0))
    sig = sigma_schedule(T_STEPS, cfg.grpo.shift)
    det = deterministic_mask(T_STEPS, ts)
    k_noise, k_roll, _ = jax.random.split(
        jax.random.fold_in(jax.random.key(cfg.grpo.sampler_seed), 0), 3)
    js = JS.FluxSampler(jcfg, JR.SamplerConfig(num_steps_max=T_STEPS, eta=cfg.grpo.eta),
                        height=RES, width=RES, text_len=TEXT_LEN, dtype=jnp.float32,
                        attn_impl="xla")
    z0 = js.init_noise(k_noise, B, same_noise_groups=G)
    out = js.chunked_rollout(jparams, z0, txt, pooled, sig, det, T_STEPS, k_roll, chunk=2)
    lat = JL.denormalize_latents(JL.unpack_latents(out.final_latents, RES, RES))
    decode = jax.jit(lambda p, z: JV.vae_decode(p, jvcfg, z, dtype=jnp.float32))
    images = JV.postprocess_images(decode(jax.tree.map(jnp.asarray, jvae_np), lat))
    r = np.asarray(jnp.mean(images, axis=(1, 2, 3)), np.float64)
    rd, sd = {"synthetic": jnp.asarray(r)}, {"synthetic": jnp.ones(B)}
    rewards = JA.masked_mix_rewards(rd, sd, {"synthetic": 1.0})
    adv = JA.masked_mix_advantages(rd, sd, {"synthetic": 1.0}, G, 0.0)
    jopt = JT.make_optimizer(learning_rate=1e-4, weight_decay=1e-2)
    jstep, _, _ = JT.make_update_fns(jcfg, js.sampler_cfg, JPPO(clip_range=0.2), jopt,
                                     js.rope_cos, js.rope_sin, dtype=jnp.float32,
                                     attn_impl="xla", remat=False)  # remat changes no value
    jstate = jopt.init(jparams)
    jmetrics = []
    for gstart in range(0, B, 2):
        gidx = np.arange(B)[gstart:gstart + 2]
        ub = JT.build_update_batch(out.all_latents, out.all_log_probs, adv, txt, pooled,
                                   np.repeat(gidx, len(ts)), np.tile(np.asarray(ts), len(gidx)))
        jparams, jstate, m = jstep(jparams, jstate, ub, jnp.asarray(sig))
        jmetrics.append({k: float(v) for k, v in m.items()})

    # -- the port, with JAX's draws ----------------------------------------------
    seen = {}
    rollout, step = tr.sampler.chunked_rollout, tr.update_step
    tr.sampler.chunked_rollout = lambda *a, **k: seen.setdefault("out", rollout(*a, **k))
    tr.update_step = lambda p, s, ub, sg: (seen.setdefault("adv", []).append(ub.advantages)
                                           or step(p, s, ub, sg))

    def noise(j, i, shape):
        k = k_roll if j is None else jax.random.fold_in(k_roll, j)
        return np.array(jax.random.normal(jax.random.fold_in(k, i), shape, jnp.float32))

    metrics = tr.train_one_step(batch, ts, z0=np.array(z0), noise_fn=noise)

    got = seen["out"]
    np.testing.assert_allclose(got.all_latents.numpy(), np.asarray(out.all_latents),
                               rtol=0, atol=2e-4)
    np.testing.assert_allclose(got.all_log_probs.numpy(), np.asarray(out.all_log_probs),
                               rtol=1e-4, atol=2e-4)
    np.testing.assert_allclose(metrics["reward"], float(jnp.mean(rewards)), rtol=0, atol=1e-4)
    np.testing.assert_allclose(metrics["reward/synthetic"], r.mean(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(torch.cat(seen["adv"]).numpy(),
                               np.repeat(np.asarray(adv), len(ts)), rtol=0, atol=1e-3)
    for k in ("clip_frac", "ratio_mean", "grad_norm"):
        want = np.mean([m[k] for m in jmetrics])
        np.testing.assert_allclose(metrics[k], want, rtol=1e-4, atol=1e-6, err_msg=k)
    for k in ("loss", "policy_loss"):
        want = np.mean([m[k] for m in jmetrics])
        np.testing.assert_allclose(metrics[k], want, rtol=0, atol=5e-5, err_msg=k)
    for a, w in zip(M.param_leaves(tr.params), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(w), rtol=0, atol=2e-5)
    assert tr.opt_state.param_groups[0]["count"] == B // 2
    tr.close()


def _loader(tmp_path):
    cfg = M.FluxConfig.tiny()
    w = EmbeddingCacheWriter(str(tmp_path / "cache"))
    rng = np.random.default_rng(1)
    for i in range(4):
        w.add(rng.standard_normal((TEXT_LEN, cfg.context_dim)),
              rng.standard_normal(cfg.pooled_dim), f"p{i}")
    w.finish()
    return PromptLoader(LatentDataset(str(tmp_path / "cache")), 1, seed=0)


def test_two_iterations_checkpoint_resume_and_ema(tmp_path, weights):
    cfg = _cfg(tmp_path, checkpointing_steps=1, max_train_steps=2, ema_decay=0.9)
    tr = _trainer(cfg, weights)
    before = [t.detach().clone() for t in M.param_leaves(tr.params)]
    tr.train(_loader(tmp_path))
    assert tr.global_step == 2 and tr.window.cur_timestep == 2
    params = [t.detach().clone() for t in M.param_leaves(tr.params)]
    ema = [t.clone() for t in M.param_leaves(tr.ema_params)]
    assert not all(torch.equal(a, b) for a, b in zip(before, params))
    # the EMA lags the parameters: strictly between the start and the end
    moved = [(e - b).abs().sum() for e, b in zip(ema, before)]
    assert 0 < sum(moved) < sum((p - b).abs().sum() for p, b in zip(params, before))
    lines = [json.loads(x) for x in open(tr.metrics.path)]
    assert [x["step"] for x in lines] == [0, 1] and np.isfinite(lines[0]["loss"])
    rows = [json.loads(x) for x in open(os.path.join(tr.run_dir, "rewards_samples_rank0.jsonl"))]
    assert len(rows) == 2 * G and rows[0]["synthetic_ok"] == 1.0
    assert "step 1" in open(os.path.join(tr.run_dir, "rewards.txt")).read()
    assert tr.ckpt.all_steps() == [1, 2]  # step 1 written in the background

    # resume into a new trainer (built from other weights): everything restored
    cfg2 = _cfg(tmp_path, max_train_steps=3, ema_decay=0.9)
    cfg2.run.resume_from_checkpoint = "latest"
    jcfg, jvcfg, jparams, jvae = weights
    other = (jcfg, jvcfg, jax.tree.map(lambda x: x * 0.5, jparams), jvae)
    tr2 = _trainer(cfg2, other)
    assert tr2.global_step == 2 and tr2.window.to_dict() == tr.window.to_dict()
    assert tr2.wandb_run_id == tr.wandb_run_id
    assert all(torch.equal(a, b) for a, b in zip(M.param_leaves(tr2.params), params))
    assert all(torch.equal(a, b) for a, b in zip(M.param_leaves(tr2.ema_params), ema))
    assert tr2.opt_state.param_groups[0]["count"] == 2 * (G // 2)
    tr2.train(_loader(tmp_path))
    assert tr2.global_step == 3 and tr2.ckpt.latest_step() == 3

    # the same seeds and state repeat an iteration exactly
    cfg3 = _cfg(tmp_path / "again")
    runs = []
    for _ in range(2):
        t = _trainer(cfg3, weights)
        runs.append(t.train_one_step(_prompt()))
        t.close()
    for k in ("loss", "grad_norm", "reward"):
        assert runs[0][k] == runs[1][k]

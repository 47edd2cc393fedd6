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

``test_lora_flash_iteration_matches_jax``: the same for LoRA over a frozen
base with MixGRPO-Flash "post" (DPM-Solver++ on the compressed tail), JAX's
adapter copied into the port's; the factors after the two AdamW steps within
2e-5, the base left bit for bit.

``test_two_iterations_checkpoint_resume_and_ema``: the port alone: two
iterations through ``train`` with EMA, a periodic background checkpoint and
the final one, a resume into a new trainer (parameters, optimizer count,
EMA, window and step restored) and one more iteration; and a rerun from the
same seeds repeats an iteration's metrics exactly.
``test_lora_flash_train_resume_and_profile`` does the same under LoRA and
Flash, with a profiler trace of the second iteration.
"""

import dataclasses
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixgrpo_tpu import lora as JLoRA
from mixgrpo_tpu import train as JTrain
from mixgrpo_tpu import sampler as JS
from mixgrpo_tpu import trainer as JT
from mixgrpo_tpu.models.flux import latents as JL
from mixgrpo_tpu.models.flux import model as JM
from mixgrpo_tpu.models.flux import vae as JV
from mixgrpo_tpu.ops import quant as JQ
from mixgrpo_tpu.rl import advantage as JA
from mixgrpo_tpu.rl.ppo import PPOConfig as JPPO
from mixgrpo_tpu.solvers import rollout as JR
from mixgrpo_tpu.solvers.schedule import (
    deterministic_mask, flash_post_schedule, sigma_schedule,
)
from mixgrpo_tpu_torch.config import (
    DataConfig, DPMConfig, GRPOConfig, MeshConfig, OptimConfig, RunConfig, TrainConfig,
    WindowConfig,
)
from mixgrpo_tpu_torch.convert import from_jax_params
from mixgrpo_tpu_torch.data.dataset import EmbeddingCacheWriter, LatentDataset, PromptLoader
from mixgrpo_tpu_torch.models.flux import model as M
from mixgrpo_tpu_torch.models.flux.load import load_flux_params
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


_JAX_FNS = {}


def _jax_fns(jcfg, jvcfg, scfg, lora):
    """JAX's sampler, jitted decode, optimizer and update step (the LoRA one
    when ``lora``) for ``scfg``, built once per module: iterations on one
    schedule share their compiled programs."""
    key = (repr(scfg), lora)
    if key not in _JAX_FNS:
        js = JS.FluxSampler(jcfg, scfg, height=RES, width=RES, text_len=TEXT_LEN,
                            dtype=jnp.float32, attn_impl="xla")
        decode = jax.jit(lambda p, z: JV.vae_decode(p, jvcfg, z, dtype=jnp.float32))
        jopt = JT.make_optimizer(learning_rate=1e-4, weight_decay=1e-2)
        kw = dict(dtype=jnp.float32, attn_impl="xla", remat=False)  # remat changes no value
        if lora:
            step = JT.make_lora_update_fns(jcfg, scfg, JPPO(clip_range=0.2), jopt, js.rope_cos,
                                           js.rope_sin, **kw)
        else:
            step = JT.make_update_fns(jcfg, scfg, JPPO(clip_range=0.2), jopt, js.rope_cos,
                                      js.rope_sin, **kw)[0]
        _JAX_FNS[key] = (js, decode, jopt, step)
    return _JAX_FNS[key]


def _jax_iteration(cfg, weights, batch, ts, factors=None, reward_models=None):
    """JAX's ``train_one_step``, function by function: the schedule (Flash
    "post" when ``cfg.dpm`` names a DPM-Solver), the rollout (on
    ``apply_lora`` of the base when LoRA ``factors``, numpy, are given), the
    decode, the reward (JAX's ``GRPOTrainer._compute_rewards`` over
    ``reward_models`` with ``cfg.reward``'s weights, else the brightness),
    the advantages and one update per accumulation group
    (``make_lora_update_fns`` under LoRA).  Returns what the port is held to,
    with JAX's initial noise and SDE draws for the port to take."""
    jcfg, jvcfg, jparams_np, jvae_np = weights
    B, T = G, cfg.grpo.sampling_steps
    jparams = jax.tree.map(jnp.asarray, jparams_np)
    txt = jnp.asarray(np.repeat(batch["prompt_embed"], G, axis=0))
    pooled = jnp.asarray(np.repeat(batch["pooled"], G, axis=0))
    sig, det, n = sigma_schedule(T, cfg.grpo.shift), deterministic_mask(T, ts), T
    if "dpmsolver" in cfg.dpm.dpm_algorithm_type:
        sig, n, det = flash_post_schedule(sig, det, cfg.grpo.shift,
                                          cfg.dpm.dpm_post_compress_ratio, pad_to=T)
    k_noise, k_roll, _ = jax.random.split(
        jax.random.fold_in(jax.random.key(cfg.grpo.sampler_seed), 0), 3)
    scfg = JR.SamplerConfig(**dataclasses.asdict(cfg.sampler_config()))
    js, decode, jopt, make_step = _jax_fns(jcfg, jvcfg, scfg, factors is not None)
    z0 = js.init_noise(k_noise, B, same_noise_groups=G)
    lora = None if factors is None else {"factors": jax.tree.map(jnp.asarray, factors),
                                         "rank": 4, "alpha": 8.0}
    rollout_params = jparams if lora is None else JLoRA.apply_lora(jparams, lora)
    if cfg.grpo.rollout_quant == "int8":  # op by op, as tests/test_torch_quant.py says
        rollout_params = JQ.quantize_flux_params(rollout_params)
    out = js.chunked_rollout(rollout_params, z0, txt, pooled, sig, det, n, k_roll, chunk=2)
    lat = JL.denormalize_latents(JL.unpack_latents(out.final_latents, RES, RES))
    images = JV.postprocess_images(decode(jax.tree.map(jnp.asarray, jvae_np), lat))
    if reward_models is None:
        r = np.asarray(jnp.mean(images, axis=(1, 2, 3)), np.float64)
        rd_np, sd_np, w = {"synthetic": r}, {"synthetic": np.ones(B)}, {"synthetic": 1.0}
    else:
        w = cfg.reward.weights()
        ns = SimpleNamespace(reward_fn=None, reward_models=reward_models, reward_weights=w)
        captions = [c for c in batch["captions"] for _ in range(G)]
        rd_np, sd_np = JTrain.GRPOTrainer._compute_rewards(ns, np.asarray(images), captions)
    rd = {k: jnp.asarray(v) for k, v in rd_np.items()}
    sd = {k: jnp.asarray(v) for k, v in sd_np.items()}
    rewards = JA.masked_mix_rewards(rd, sd, w)
    adv = JA.masked_mix_advantages(rd, sd, w, G, 0.0)
    if lora is None:
        trained, step = jparams, lambda t, s, ub: make_step(t, s, ub, jnp.asarray(sig))
    else:
        meta = {"rank": 4, "alpha": 8.0}
        trained = lora["factors"]
        step = lambda t, s, ub: make_step(t, s, meta, jparams, ub, jnp.asarray(sig))
    jstate = jopt.init(trained)
    jmetrics = []
    for gstart in range(0, B, 2):
        gidx = np.arange(B)[gstart:gstart + 2]
        ub = JT.build_update_batch(out.all_latents, out.all_log_probs, adv, txt, pooled,
                                   np.repeat(gidx, len(ts)), np.tile(np.asarray(ts), len(gidx)))
        trained, jstate, m = step(trained, jstate, ub)
        jmetrics.append({k: float(v) for k, v in m.items()})

    def noise(j, i, shape):
        k = k_roll if j is None else jax.random.fold_in(k_roll, j)
        return np.array(jax.random.normal(jax.random.fold_in(k, i), shape, jnp.float32))

    return dict(out=out, n=n, rewards=rewards, rd=rd_np, adv=adv, metrics=jmetrics,
                trained=trained, z0=np.array(z0), noise=noise)


def _check_port_iteration(tr, want, batch, ts, update_name):
    """The port's ``train_one_step`` with JAX's draws, held to ``want`` (the
    tolerances of the module docstring); returns the port's metrics."""
    seen = {}
    rollout, step = tr.sampler.chunked_rollout, getattr(tr, update_name)
    tr.sampler.chunked_rollout = lambda *a, **k: seen.setdefault("out", rollout(*a, **k))
    setattr(tr, update_name, lambda *a: (seen.setdefault("adv", []).append(a[-2].advantages)
                                         or step(*a)))
    metrics = tr.train_one_step(batch, ts, z0=want["z0"], noise_fn=want["noise"])

    got, out = seen["out"], want["out"]
    assert metrics["num_steps"] == want["n"]
    np.testing.assert_allclose(got.all_latents.numpy(), np.asarray(out.all_latents),
                               rtol=0, atol=2e-4)
    np.testing.assert_allclose(got.all_log_probs.numpy(), np.asarray(out.all_log_probs),
                               rtol=1e-4, atol=2e-4)
    np.testing.assert_allclose(metrics["reward"], float(jnp.mean(want["rewards"])), rtol=0,
                               atol=1e-4)
    for name, r in want["rd"].items():
        np.testing.assert_allclose(metrics[f"reward/{name}"], np.mean(r), rtol=0, atol=1e-4)
    np.testing.assert_allclose(torch.cat(seen["adv"]).numpy(),
                               np.repeat(np.asarray(want["adv"]), len(ts)), rtol=0, atol=1e-3)
    for k in ("clip_frac", "ratio_mean", "grad_norm"):
        w = np.mean([m[k] for m in want["metrics"]])
        np.testing.assert_allclose(metrics[k], w, rtol=1e-4, atol=1e-6, err_msg=k)
    for k in ("loss", "policy_loss"):
        w = np.mean([m[k] for m in want["metrics"]])
        np.testing.assert_allclose(metrics[k], w, rtol=0, atol=5e-5, err_msg=k)
    assert tr.opt_state.param_groups[0]["count"] == G // 2
    return metrics


def test_iteration_matches_jax(tmp_path, weights):
    cfg = _cfg(tmp_path)
    tr = _trainer(cfg, weights)
    batch = _prompt()
    ts = tr.window.get_current_timesteps()
    want = _jax_iteration(cfg, weights, batch, ts)
    _check_port_iteration(tr, want, batch, ts, "update_step")
    for a, w in zip(M.param_leaves(tr.params), jax.tree.leaves(want["trained"])):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(w), rtol=0, atol=2e-5)
    tr.close()


def test_iteration_with_reward_models_matches_jax(tmp_path, weights):
    """The whole slice with the reward zoo in place of the brightness: HPS,
    PickScore and CLIP-score from files (``from_checkpoint`` in both
    packages) and a tiny ImageReward (the port's ``from_checkpoint``; JAX's
    constructor, as its ``from_checkpoint`` hard-codes ViT-L), weighted
    unevenly, mixed by ``advantage_aggr``; no ``reward_fn``.  The per-model
    rewards of every sample, the advantages and the loss against JAX's."""
    from mixgrpo_tpu.rewards import clip_family as JCF
    from mixgrpo_tpu_torch.rewards import clip_family as CF
    from mixgrpo_tpu_torch.rewards.image_reward import ImageRewardModel
    from tests.test_torch_blip import VCFG, jax_image_reward, write_image_reward
    from tests.test_torch_rewards import write_clip_ckpts

    ck = write_clip_ckpts(str(tmp_path / "clip"))
    ir_dir = str(tmp_path / "ir")
    ir_path, med, _ = write_image_reward(ir_dir)
    cfg = _cfg(tmp_path)
    cfg.reward.hps_weight, cfg.reward.pick_score_weight = 2.0, 0.5
    classes = {"hpsv2": (CF.HPSReward, JCF.HPSReward, "hps"),
               "pick_score": (CF.PickScoreReward, JCF.PickScoreReward, "pick_score"),
               "clip_score": (CF.CLIPScoreReward, JCF.CLIPScoreReward, "clip_score")}
    mine = {n: c.from_checkpoint(ck[f], ck["merges"], device="cpu")
            for n, (c, _, f) in classes.items()}
    mine["image_reward"] = ImageRewardModel.from_checkpoint(ir_path, med, ir_dir,
                                                            vision_cfg=VCFG, device="cpu")
    ref = {n: c.from_checkpoint(ck[f], ck["merges"], dtype=jnp.float32)
           for n, (_, c, f) in classes.items()}
    ref["image_reward"] = jax_image_reward(ir_path, ir_dir)

    jcfg, jvcfg, jparams, jvae = weights
    tr = GRPOTrainer(cfg, flux_cfg=M.FluxConfig.tiny(), params=from_jax_params(jparams, "cpu"),
                     vae_cfg=VAEConfig.tiny(latent_channels=jcfg.in_channels // 4),
                     vae_params=from_jax_params(jvae, "cpu"), reward_models=mine,
                     text_len=TEXT_LEN, attn_impl="eager", dtype=torch.float32, device="cpu")
    batch = _prompt()
    batch["captions"] = ["the cat on a mat, a tiny prompt"]
    ts = tr.window.get_current_timesteps()
    want = _jax_iteration(cfg, weights, batch, ts, reward_models=ref)
    assert sorted(want["rd"]) == sorted(mine)
    _check_port_iteration(tr, want, batch, ts, "update_step")
    rows = [json.loads(x) for x in open(os.path.join(tr.run_dir, "rewards_samples_rank0.jsonl"))]
    for name, r in want["rd"].items():
        np.testing.assert_allclose([row[name] for row in rows], r, rtol=0, atol=1e-4)
        assert all(row[f"{name}_ok"] == 1.0 for row in rows)
    np.testing.assert_allclose([row["reward"] for row in rows], np.asarray(want["rewards"]),
                               rtol=0, atol=1e-4)
    tr.close()


def _flash(cfg):
    """MixGRPO-Flash: DPM-Solver++ order 2 (midpoint) on the tail after the
    window, compressed by 0.8."""
    cfg.dpm = DPMConfig(dpm_algorithm_type="dpmsolver++", dpm_apply_strategy="post",
                        dpm_post_compress_ratio=0.8, dpm_solver_order=2,
                        dpm_solver_type="midpoint")
    return cfg


def _lora_factors(weights):
    """JAX's rank-4 adapter over the tiny weights, its ``b`` factors made
    nonzero so the merged policy differs from the base (numpy)."""
    lora = JLoRA.init_lora(jax.random.key(3), jax.tree.map(jnp.asarray, weights[2]), rank=4,
                           alpha=8.0)
    rng = np.random.default_rng(4)
    return {p: {"a": np.asarray(f["a"]),
                "b": 0.05 * rng.standard_normal(f["b"].shape).astype(np.float32)}
            for p, f in lora["factors"].items()}


def test_lora_flash_iteration_matches_jax(tmp_path, weights):
    """The whole slice: LoRA over a frozen base, MixGRPO-Flash "post" with the
    window mid-trajectory (steps 1-2 of 6; the tail of 3 compressed steps
    starts second order on the window's last x0), against JAX's functions on
    JAX's factors, copied into the port's in place."""
    cfg = _flash(_cfg(tmp_path))
    tr = _trainer(cfg, weights, use_lora=True, lora_rank=4, lora_alpha=8.0)
    factors = _lora_factors(weights)
    assert sorted(tr.lora_factors) == sorted(factors)
    with torch.no_grad():
        for dst, src in zip(M.param_leaves(tr.lora_factors), jax.tree.leaves(factors)):
            dst.copy_(torch.tensor(src))
    base = [t.clone() for t in M.param_leaves(tr.params)]
    batch, ts = _prompt(), [1, 2]
    want = _jax_iteration(cfg, weights, batch, ts, factors=factors)
    assert want["n"] == 5
    _check_port_iteration(tr, want, batch, ts, "lora_update")
    for a, w in zip(M.param_leaves(tr.lora_factors), jax.tree.leaves(want["trained"])):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(w), rtol=0, atol=2e-5)
    assert all(torch.equal(a, b) and not a.requires_grad and a.grad is None
               for a, b in zip(M.param_leaves(tr.params), base))
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


def test_lora_flash_train_resume_and_profile(tmp_path, weights):
    """Two LoRA + Flash iterations through ``train`` with ``profile_steps=1``:
    the second iteration is traced into ``<run_dir>/profile``, the base stays
    bit for bit, the factors move, EMA is off; a resume restores the factors,
    the optimizer count, the window and the step, and runs one more."""
    cfg = _flash(_cfg(tmp_path, max_train_steps=2, ema_decay=0.9))
    cfg.run.profile_steps = 1
    lkw = dict(use_lora=True, lora_rank=4, lora_alpha=8.0)
    tr = _trainer(cfg, weights, **lkw)
    assert tr.ema_params is None
    base = [t.clone() for t in M.param_leaves(tr.params)]
    b0 = [f["b"].clone() for f in tr.lora_factors.values()]
    tr.train(_loader(tmp_path))
    assert tr.global_step == 2
    assert os.path.dirname(tr.profile_trace.path) == os.path.join(tr.run_dir, "profile")
    with open(tr.profile_trace.path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"rollout", "decode", "update"} <= names
    assert all(torch.equal(a, b) and not a.requires_grad
               for a, b in zip(M.param_leaves(tr.params), base))
    assert any(not torch.equal(f["b"], b) for f, b in zip(tr.lora_factors.values(), b0))
    lines = [json.loads(x) for x in open(tr.metrics.path)]
    assert all(np.isfinite(x["loss"]) and x["num_steps"] < T_STEPS for x in lines)
    factors = {p: {k: v.detach().clone() for k, v in f.items()}
               for p, f in tr.lora_factors.items()}

    cfg2 = _flash(_cfg(tmp_path, max_train_steps=3))
    cfg2.run.resume_from_checkpoint = "latest"
    tr2 = _trainer(cfg2, weights, **lkw)
    assert tr2.global_step == 2 and tr2.window.to_dict() == tr.window.to_dict()
    assert sorted(tr2.lora_factors) == sorted(factors)
    assert all(torch.equal(tr2.lora_factors[p][k], factors[p][k])
               for p in factors for k in ("a", "b"))
    assert tr2.opt_state.param_groups[0]["count"] == 2 * (G // 2)
    tr2.train(_loader(tmp_path))
    assert tr2.global_step == 3 and tr2.profile_trace is None


@pytest.mark.parametrize("what", ["reward_zoo", "int8", "export_required", "mesh"])
def test_trainer_refuses_what_is_not_ported(tmp_path, weights, what):
    """The trainer refuses to start with no reward (neither ``reward_models``
    nor a ``reward_fn``: case "reward_zoo"), a mesh of more devices than
    there are processes (case "mesh": fsdp=2 in one process), and an unknown
    ``rollout_quant``.  The diffusers export is ported: with
    ``export_safetensors="required"`` a checkpoint writes it, and it reads
    back to the parameters exactly.  So are int8 rollouts: one iteration
    with ``rollout_quant="int8"`` against JAX's on the same draws, within
    ``test_iteration_matches_jax``'s tolerances (the int8 products and the
    per-token quantisation agree to f32 rounding on these inputs)."""
    cfg, kw = _cfg(tmp_path), {}
    if what == "int8":
        cfg.grpo.rollout_quant = "int8"
        tr = _trainer(cfg, weights)
        batch = _prompt()
        ts = tr.window.get_current_timesteps()
        want = _jax_iteration(cfg, weights, batch, ts)
        m = _check_port_iteration(tr, want, batch, ts, "update_step")
        assert all(np.isfinite(m[k]) for k in ("loss", "reward", "clip_frac"))
        tr.close()
        cfg.grpo.rollout_quant = "int4"
    if what == "export_required":
        cfg.run.export_safetensors = "required"
        tr = _trainer(cfg, weights)
        tr.save_checkpoint()
        tr.close()
        path = os.path.join(tr.run_dir, "export_0", "diffusion_pytorch_model.safetensors")
        back = load_flux_params(path, M.FluxConfig.tiny(), device="cpu")
        assert all(torch.equal(a, b.detach())
                   for a, b in zip(M.param_leaves(back), M.param_leaves(tr.params)))
        return
    if what == "reward_zoo":
        kw["reward_fn"] = None
    elif what == "mesh":
        cfg.mesh = MeshConfig(fsdp=2)
    jcfg, _, jparams, jvae = weights
    with pytest.raises((NotImplementedError, ValueError)):
        GRPOTrainer(cfg, flux_cfg=M.FluxConfig.tiny(), params=from_jax_params(jparams, "cpu"),
                    reward_fn=kw.get("reward_fn", _brightness_torch), text_len=TEXT_LEN,
                    attn_impl="eager", dtype=torch.float32, device="cpu")


def test_trainer_reads_lora_from_runtime_config(tmp_path, weights):
    """With no LoRA keywords the trainer takes ``cfg.runtime``'s fields; a
    keyword given wins over its field."""
    cfg = _cfg(tmp_path)
    cfg.runtime.use_lora, cfg.runtime.lora_rank, cfg.runtime.lora_alpha = True, 4, 8.0
    tr = _trainer(cfg, weights)
    assert tr.use_lora and tr.lora_meta == {"rank": 4, "alpha": 8.0}
    assert tr.lora_factors["double/img_qkv/w"]["a"].shape[-1] == 4
    assert all(not t.requires_grad for t in M.param_leaves(tr.params))
    tr.close()
    tr = _trainer(cfg, weights, use_lora=False)
    assert not tr.use_lora and all(t.requires_grad for t in M.param_leaves(tr.params))
    tr.close()

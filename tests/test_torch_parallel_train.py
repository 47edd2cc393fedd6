"""Multi-rank training, checkpoints and CLIs of the port on ``gloo`` ranks
spawned on the CPU (``tests/torch_parallel_worker.py``), against JAX on the
virtual CPU devices of ``tests/conftest.py`` or against one rank.

- One ``update_step`` (tiny FLUX, f32) under fsdp=2, dp=2 and dp=2 x fsdp=2
  (4 ranks) against
  JAX's ``make_update_fns`` on the same mesh: the parameters after the
  update within 1e-5 relative, elementwise, or ``ADAM_ATOL`` absolute, and
  the same ``grad_norm`` and loss (1e-5 relative).
- ``train_one_step`` on 2 ranks (fsdp=2, one prompt each, accumulation 2)
  against 1 rank on the same 2 prompts (accumulation 4: each update group
  then holds the same global rows) with the same injected noise: rewards,
  loss, grad_norm and the parameters after it (1e-5).  The 2-rank run then
  writes a sharded checkpoint and the export: a resume on 2 ranks restores
  the shards and the optimizer exactly, a resume on 1 rank raises, and the
  export equals the gathered parameters.
- The same under LoRA (base and factors whole on every rank): the factors
  after the step on both ranks against 1 rank, and the export written by
  rank 0 alone.
- ``sample.main`` and ``eval_rewards.main`` on 2 ranks: JAX's file names
  (``img_p<pi>_<i>.png``, ``metadata_<pi>.json``, ``rewards_<pi>.json``),
  seeds ``seed + pi * 100000 + i``, and rank 0's summary equal to JAX's
  ``summarize`` over every shard.
- ``PromptLoader`` refuses process counts that leave unequal batch counts;
  ``GRPOTrainer`` refuses ``tp > 1`` naming ROADMAP item 8b.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixgrpo_tpu import trainer as JT
from mixgrpo_tpu.data.dataset import PromptLoader as JPromptLoader
from mixgrpo_tpu.models.flux import model as JM
from mixgrpo_tpu.parallel import mesh as JMesh
from mixgrpo_tpu.parallel import sharding as JSh
from mixgrpo_tpu.rl.ppo import PPOConfig as JPPO
from mixgrpo_tpu.solvers import rollout as JR
from mixgrpo_tpu_torch.config import MeshConfig
from mixgrpo_tpu_torch.data.dataset import EmbeddingCacheWriter, LatentDataset, PromptLoader
from mixgrpo_tpu_torch.models.flux import model as M
from mixgrpo_tpu_torch.sampler import FluxSampler
from mixgrpo_tpu_torch.solvers.rollout import SamplerConfig
from mixgrpo_tpu_torch.trainer import UpdateBatch
from tests.torch_parallel_worker import _trainer, load_tree, run_train_step, save_tree, spawn_ranks

RES, TEXT_LEN, T_STEPS = 32, 8, 4
# AdamW's first step moves an entry by lr * g / (|g| + eps), whose slope at
# g = 0 is lr / eps = 1e4 at lr 1e-4: an entry whose gradient is near eps
# moves by an amount that f32 rounding of the gradient (~2e-10 here) changes
# by up to 2e-6
ADAM_ATOL = 2e-6


def _numpy_tree(tree):
    return {k: _numpy_tree(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else tree.detach().numpy()


@pytest.fixture(scope="module")
def weights():
    params = M.init_flux(M.FluxConfig.tiny(), generator=torch.Generator().manual_seed(0),
                         device="cpu")
    return _numpy_tree(params)


# ----------------------------------------------------------------------------
# update_step under a mesh against JAX's
# ----------------------------------------------------------------------------


def _update_inputs(jparams):
    """An update group of 4 rows (two per batch rank) whose old log-probs are
    JAX's recomputed ones plus a little noise, so the PPO ratio is near 1."""
    rng = np.random.default_rng(3)
    cfg = M.FluxConfig.tiny()
    scfg = SamplerConfig(num_steps_max=T_STEPS, eta=0.7)
    sm = FluxSampler(cfg, scfg, height=RES, width=RES, text_len=TEXT_LEN, dtype=torch.float32,
                     device="cpu")
    N, L, C = 4, sm.num_image_tokens, cfg.in_channels
    sig = np.linspace(1.0, 0.0, T_STEPS + 1).astype(np.float32)
    b = dict(latents=rng.standard_normal((N, L, C)).astype(np.float32),
             next_latents=rng.standard_normal((N, L, C)).astype(np.float32) * 0.5,
             t_index=np.array([0, 1, 2, 1], np.int32),
             advantages=rng.standard_normal(N).astype(np.float32),
             txt=rng.standard_normal((N, TEXT_LEN, cfg.context_dim)).astype(np.float32),
             pooled=rng.standard_normal((N, cfg.pooled_dim)).astype(np.float32))
    jscfg = JR.SamplerConfig(**dataclasses.asdict(scfg))
    jcfg = JM.FluxConfig.tiny()
    t = jnp.floor(jnp.asarray(sig)[b["t_index"]] * 1000.0) / 1000.0
    pred = JM.flux_forward(jax.tree.map(jnp.asarray, jparams), jcfg, jnp.asarray(b["latents"]),
                           jnp.asarray(b["txt"]), jnp.asarray(b["pooled"]), t,
                           jnp.full((N,), 3.5), jnp.asarray(sm.rope_cos.numpy()),
                           jnp.asarray(sm.rope_sin.numpy()), dtype=jnp.float32,
                           attn_impl="xla")
    lp = JT.recompute_log_prob(jscfg, pred, jnp.asarray(b["latents"]),
                               jnp.asarray(b["next_latents"]), jnp.asarray(sig),
                               jnp.asarray(b["t_index"]))
    b["old_log_probs"] = (np.asarray(lp) + rng.standard_normal(N) * 0.02).astype(np.float32)
    return b, sig, sm.rope_cos.numpy(), sm.rope_sin.numpy(), scfg


@pytest.mark.parametrize("mesh", [dict(dp=1, fsdp=2), dict(dp=2, fsdp=1), dict(dp=2, fsdp=2)])
def test_update_step_matches_jax_on_mesh(mesh, weights, tmp_path):
    jparams = weights
    b, sig, cos, sin, scfg = _update_inputs(jparams)
    hp = dict(lr=1e-4, wd=1e-2, max_grad_norm=1.0)
    z = dict(sigmas=sig, rope_cos=cos, rope_sin=sin,
             **{f"b_{k}": v for k, v in b.items()})
    save_tree("p", jparams, z)
    np.savez(tmp_path / "in.npz", **z)
    (tmp_path / "in.json").write_text(json.dumps(dict(
        mesh=mesh, sampler=dataclasses.asdict(scfg), remat=True, **hp)))
    n = mesh["dp"] * mesh["fsdp"]
    ranks = spawn_ranks("update", n, str(tmp_path))

    jm = JMesh.make_mesh(JMesh.MeshConfig(**mesh), devices=jax.devices()[:n])
    JSh.set_activation_mesh(jm)
    try:
        jopt = JT.make_optimizer(learning_rate=hp["lr"], weight_decay=hp["wd"],
                                 max_grad_norm=hp["max_grad_norm"])
        step = JT.make_update_fns(JM.FluxConfig.tiny(), JR.SamplerConfig(
            **dataclasses.asdict(scfg)), JPPO(clip_range=0.2), jopt, jnp.asarray(cos),
            jnp.asarray(sin), dtype=jnp.float32, attn_impl="xla", remat=False)[0]
        params = JSh.shard_params(jax.tree.map(jnp.asarray, jparams), jm)
        ub = JT.UpdateBatch(**{k: jax.device_put(jnp.asarray(b[k]),
                                                 JSh.data_spec(jm, b[k].ndim))
                               for k in UpdateBatch._fields})
        with jm:
            state = JSh.shard_opt_state(jopt.init(params), jm)
            want, _, wm = step(params, state, ub, jnp.asarray(sig))
    finally:
        JSh.set_activation_mesh(None)
    got = load_tree("p", ranks[0][0])
    flat, _ = jax.tree_util.tree_flatten_with_path(want)
    for path, w in flat:
        t = got
        for k in path:
            t = t[k.key]
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-5, atol=ADAM_ATOL,
                                   err_msg=str(path))
    for r in ranks:
        m = r[1]["metrics"]
        assert m["grad_norm"] == pytest.approx(float(wm["grad_norm"]), rel=1e-5)
        assert m["loss"] == pytest.approx(float(wm["loss"]), rel=1e-5, abs=1e-7)
        assert m["grad_norm"] == ranks[0][1]["metrics"]["grad_norm"]  # one clip decision


# ----------------------------------------------------------------------------
# train_one_step on 2 ranks against 1 rank; checkpoint, resume, export
# ----------------------------------------------------------------------------


def _train_inputs(weights, out_dir, mesh, accum):
    jparams = weights
    rng = np.random.default_rng(7)
    cfg = M.FluxConfig.tiny()
    G, chunk = 2, 2
    L = (RES // 16) ** 2
    z = dict(prompt_embed=rng.standard_normal((2, TEXT_LEN, cfg.context_dim)).astype(np.float32),
             pooled=rng.standard_normal((2, cfg.pooled_dim)).astype(np.float32),
             z0=rng.standard_normal((2 * G, L, cfg.in_channels)).astype(np.float32),
             noise=rng.standard_normal((2 * G // chunk, T_STEPS, chunk, L, cfg.in_channels))
             .astype(np.float32))
    save_tree("p", jparams, z)
    info = dict(mesh=mesh, accum=accum, res=RES, steps=T_STEPS, G=G, chunk=chunk,
                text_len=TEXT_LEN, captions=["a red cube", "a blue sphere"], window=[0, 1],
                out_dir=out_dir)
    return z, info


def test_train_step_two_ranks_matches_one_rank_and_resumes(weights, tmp_path):
    d2 = tmp_path / "two"
    d2.mkdir()
    z, info = _train_inputs(weights, str(d2 / "run"), dict(dp=1, fsdp=2), accum=2)
    np.savez(d2 / "in.npz", **z)
    (d2 / "in.json").write_text(json.dumps(info))
    ranks = spawn_ranks("train", 2, str(d2))

    z1, info1 = _train_inputs(weights, str(tmp_path / "one"), dict(dp=1), accum=4)
    tr = _trainer(MeshConfig(1, 1, 1, 1), z1, info1, info1["out_dir"])
    m1 = run_train_step(tr, tr.mesh, z1, info1)
    tr.close()
    for _, j in ranks:
        m2 = j["metrics"]
        for k in ("reward", "loss", "grad_norm", "reward/synthetic"):
            assert m2[k] == pytest.approx(m1[k], rel=1e-5, abs=1e-7), k
    got = load_tree("p", ranks[0][0])
    for a, b in zip(M.param_leaves(got), M.param_leaves(tr.params)):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(), rtol=1e-5, atol=ADAM_ATOL)

    res = ranks[0][1]["resumed"]
    assert res == {"step": 1, "params_equal": True, "opt_equal": True,
                   "shard_shape": [2, 128 // 2, 3 * 128]}
    ck = d2 / "run" / "part_test" / "checkpoints" / "1"
    assert sorted(os.listdir(ck)) == ["manifest.json", "shard0of2.pt", "shard1of2.pt"]
    assert json.load(open(ck / "manifest.json"))["mesh"] == {"dp": 1, "fsdp": 2, "sp": 1,
                                                             "tp": 1}
    with pytest.raises(ValueError, match="mesh"):
        _trainer(MeshConfig(1, 1, 1, 1), z, info, info["out_dir"], resume=True)

    from mixgrpo_tpu_torch.models.flux.load import load_flux_params

    exp = load_flux_params(str(d2 / "run" / "part_test" / "export_1"), M.FluxConfig.tiny(),
                           dtype=torch.float32, device="cpu")
    for a, b in zip(M.param_leaves(exp), M.param_leaves(got)):
        assert torch.equal(a, b)


def test_lora_train_step_two_ranks_matches_one_rank(weights, tmp_path):
    """LoRA on a mesh keeps the base and the factors whole on every rank: 2
    ranks (one prompt each) against 1 rank on the same global batch and
    noise, and the export written by rank 0 alone."""
    d2 = tmp_path / "two"
    d2.mkdir()
    z, info = _train_inputs(weights, str(d2 / "run"), dict(dp=1, fsdp=2), accum=2)
    info["lora"] = True
    np.savez(d2 / "in.npz", **z)
    (d2 / "in.json").write_text(json.dumps(info))
    ranks = spawn_ranks("train_lora", 2, str(d2))

    z1, info1 = _train_inputs(weights, str(tmp_path / "one"), dict(dp=1), accum=4)
    info1["lora"] = True
    tr = _trainer(MeshConfig(1, 1, 1, 1), z1, info1, info1["out_dir"])
    m1 = run_train_step(tr, tr.mesh, z1, info1)
    tr.close()
    want = [t.detach().numpy() for t in M.param_leaves(tr.lora_factors)]
    assert any(np.abs(w).max() > 0 for w in want)  # the step moved the factors
    for r, (got, j) in enumerate(ranks):
        for k in ("reward", "loss", "grad_norm", "reward/synthetic"):
            assert j["metrics"][k] == pytest.approx(m1[k], rel=1e-5, abs=1e-7), k
        for i, w in enumerate(want):
            np.testing.assert_allclose(got[f"f{i}"], w, rtol=1e-5, atol=ADAM_ATOL)
        assert j["export_writes"] == (1 if r == 0 else 0)
    from mixgrpo_tpu_torch.models.flux.load import load_flux_params

    exp = load_flux_params(str(d2 / "run" / "part_test" / "export_1"), M.FluxConfig.tiny(),
                           dtype=torch.float32, device="cpu")
    for a, b in zip(M.param_leaves(exp), M.param_leaves(load_tree("p", z))):
        assert torch.equal(a, b)  # the frozen base, whole


# ----------------------------------------------------------------------------
# the CLIs on 2 ranks
# ----------------------------------------------------------------------------


def test_sample_and_eval_rewards_main_on_two_ranks(tmp_path):
    from mixgrpo_tpu import eval_rewards as JE
    from tests.test_torch_load import write_rehearsal_tree
    from tests.test_torch_rewards import write_clip_ckpts

    tree = write_rehearsal_tree(tmp_path / "ck")
    ck = write_clip_ckpts(str(tmp_path / "clip"))
    prompts = ["a corgi", "a red fox in snow", "a city at night", "café crème"]
    (tmp_path / "prompts.txt").write_text("\n".join(prompts) + "\n")
    out, ev = str(tmp_path / "out"), str(tmp_path / "eval")
    np.savez(tmp_path / "in.npz")
    (tmp_path / "in.json").write_text(json.dumps(dict(
        mesh={"dp": 2}, tree=tree, prompts=str(tmp_path / "prompts.txt"), out=out, eval=ev,
        hps=ck["hps"], merges=ck["merges"])))
    ranks = spawn_ranks("cli", 2, str(tmp_path))
    # JAX's names: every rank's images numbered per batch from 0, its metadata
    # and its reward shard
    assert sorted(os.listdir(out)) == ["img_p0_00000.png", "img_p0_00001.png",
                                       "img_p1_00000.png", "img_p1_00001.png",
                                       "metadata_0.json", "metadata_1.json"]
    for pi in range(2):
        meta = json.load(open(os.path.join(out, f"metadata_{pi}.json")))
        assert [m["prompt"] for m in meta] == prompts[pi::2]
        assert [m["seed"] for m in meta] == [7 + pi * 100000 + j for j in range(2)]
    assert sorted(os.listdir(ev)) == ["reward_means.txt", "rewards_0.json", "rewards_1.json"]
    summary = ranks[0][1]["summary"]
    assert ranks[1][1]["summary"] is None  # rank 1 returns after the barrier
    assert summary == JE.summarize(JE.gather_result_shards(ev))
    assert summary["hpsv2_count"] == 4  # rank 0's summary covers every image


# ----------------------------------------------------------------------------
# refusals
# ----------------------------------------------------------------------------


def _dataset(tmp_path, n):
    w = EmbeddingCacheWriter(str(tmp_path / "cache"))
    for i in range(n):
        w.add(np.zeros((2, 4), np.float32), np.zeros(3, np.float32), f"p{i}")
    w.finish()
    return LatentDataset(str(tmp_path / "cache"))


@pytest.mark.parametrize("n,count,batch,refused", [
    (1, 4, 1, True),  # the head pads once: ranks 2 and 3 get nothing
    (2, 8, 1, True),
    (5, 2, 2, False),
    (3, 4, 1, False),  # padded to 4: one sample each
])
def test_prompt_loader_refuses_unequal_batches(tmp_path, n, count, batch, refused):
    ds = _dataset(tmp_path, n)
    jcounts = {len(list(JPromptLoader(ds, batch, process_index=r, process_count=count)
                        .epoch(0))) for r in range(count)}
    assert (len(jcounts) > 1) == refused  # JAX yields them unequal all the same
    if refused:
        with pytest.raises(ValueError, match="unequal"):
            PromptLoader(ds, batch, process_index=0, process_count=count)
    else:
        got = {len(list(PromptLoader(ds, batch, process_index=r, process_count=count)
                        .epoch(0))) for r in range(count)}
        assert got == jcounts


def test_trainer_refuses_tensor_parallelism(weights, tmp_path):
    z, info = _train_inputs(weights, str(tmp_path), dict(dp=1, tp=2), accum=2)
    with pytest.raises(ValueError, match="8b"):
        _trainer(MeshConfig(1, 1, 1, 2), z, info, str(tmp_path))

"""Multi-rank training, checkpoints and CLIs of the port on ``gloo`` ranks
spawned on the CPU (``tests/torch_parallel_worker.py``), against JAX on the
virtual CPU devices of ``tests/conftest.py`` or against one rank.

- One ``update_step`` (tiny FLUX, f32) under fsdp=2, dp=2, dp=2 x fsdp=2
  (4 ranks), tp=2, fsdp=2 x tp=2 and sp=2 x tp=2 (Ulysses on the tp-local
  heads) against JAX's ``make_update_fns`` on the same mesh: the parameters
  after the update within 1e-5 relative, elementwise, or ``ADAM_ATOL``
  absolute, and the same ``grad_norm`` and loss (1e-5 relative).
- ``flux_forward`` on tp=2 slices of a tree with drawn biases against JAX's
  forward (f32), and its int8 forward against one rank's bit for bit.
- ``train_one_step`` on 2 ranks (fsdp=2, one prompt each, accumulation 2)
  against 1 rank on the same 2 prompts (accumulation 4: each update group
  then holds the same global rows) with the same injected noise: rewards,
  loss, grad_norm and the parameters after it (1e-5).  The 2-rank run then
  writes a sharded checkpoint and the export: a resume on 2 ranks restores
  the shards and the optimizer exactly, a restore on 1 rank gives the whole
  parameters and AdamW moments bit for bit, and the export equals the
  gathered parameters.
- The same on fsdp=2 x tp=2 (4 ranks): one file per (fsdp, tp) shard, the
  resume on the same mesh, the restore on 1 rank and on fsdp=2 bit for bit
  (JAX's ``tests/test_checkpoint.py::test_mesh_migration_restore``).
- An int8 rollout on tp=2 equals one rank's bit for bit, and the iteration
  on it one rank's.
- The same under LoRA (the frozen base sharded as the trained tree is, the
  factors whole on every rank), on fsdp=2 and on tp=2: the factors after the
  step on both ranks against 1 rank, each rank holding 1/fsdp (and 1/tp) of
  every sharded base leaf, and the export, written by rank 0 alone, equal
  to the whole base.
- One LoRA ``update_step`` over the sharded base at fsdp=2 and at tp=2
  against JAX's ``make_lora_update_fns`` over ``shard_params`` of the base
  on the same mesh (what JAX's ``GRPOTrainer(use_lora=True)`` runs): the
  factors after it within 1e-5 relative or ``ADAM_ATOL``, grad_norm and loss
  (1e-5 relative).
- ``sample.main`` and ``eval_rewards.main`` on 2 ranks: JAX's file names
  (``img_p<pi>_<i>.png``, ``metadata_<pi>.json``, ``rewards_<pi>.json``),
  seeds ``seed + pi * 100000 + i``, and rank 0's summary equal to JAX's
  ``summarize`` over every shard.
- ``PromptLoader`` refuses process counts that leave unequal batch counts;
  ``GRPOTrainer`` refuses a tp that does not divide the heads.
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


def _with_biases(tree, rng):
    """``tree`` with every bias drawn: ``init_flux``'s are zero, and a bias
    that the tp ranks add more than once shows only when it is not."""
    return {k: (_with_biases(v, rng) if isinstance(v, dict) else
                (rng.standard_normal(v.shape).astype(np.float32) * 0.02 if k == "b" else v))
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def biased_weights(weights):
    return _with_biases(weights, np.random.default_rng(11))


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


@pytest.mark.parametrize("mesh", [dict(dp=1, fsdp=2), dict(dp=2, fsdp=1), dict(dp=2, fsdp=2),
                                  dict(dp=1, tp=2), dict(dp=1, fsdp=2, tp=2),
                                  dict(dp=1, sp=2, tp=2)])
def test_update_step_matches_jax_on_mesh(mesh, weights, tmp_path):
    jparams = weights
    b, sig, cos, sin, scfg = _update_inputs(jparams)
    hp = dict(lr=1e-4, wd=1e-2, max_grad_norm=1.0)
    z = dict(sigmas=sig, rope_cos=cos, rope_sin=sin,
             **{f"b_{k}": v for k, v in b.items()})
    save_tree("p", jparams, z)
    np.savez(tmp_path / "in.npz", **z)
    # on an sp mesh the port's attention is Ulysses over the tp-local heads
    (tmp_path / "in.json").write_text(json.dumps(dict(
        mesh=mesh, sampler=dataclasses.asdict(scfg), remat=True,
        attn="ulysses" if mesh.get("sp", 1) > 1 else "eager", **hp)))
    n = int(np.prod([mesh.get(a, 1) for a in ("dp", "fsdp", "sp", "tp")]))
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

    tr, m1 = _one_rank(weights, tmp_path)
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
    # the fsdp=2 checkpoint restores on one rank, the leaves whole, bit for bit
    _check_restored(_restore_one_rank(z, info), got, ranks[0][0])
    _check_export(d2, got)


def _restore_one_rank(z, info):
    """A one-rank trainer resumed from the checkpoint of ``info``'s run."""
    one = dict(info, mesh=dict(dp=1))
    tr = _trainer(MeshConfig(1, 1, 1, 1), z, one, info["out_dir"], resume=True)
    tr.close()
    assert tr.global_step == 1
    opt = tr.opt_state
    moments = {f"m.{k}.{i}": opt.state[p][k].numpy()
               for i, p in enumerate(opt.param_groups[0]["params"])
               for k in ("exp_avg", "exp_avg_sq")}
    return tr.params, moments


def _check_restored(restored, params, moments):
    """Restored parameters and AdamW moments equal the saving run's whole
    ones bit for bit."""
    got_p, got_m = restored
    for a, b in zip(M.param_leaves(got_p), M.param_leaves(params)):
        assert torch.equal(a.detach(), b.detach())
    want_m = {k: v for k, v in moments.items() if k.startswith("m.")}
    assert len(want_m) == 2 * len(M.param_leaves(params))
    for k, v in want_m.items():
        np.testing.assert_array_equal(got_m[k], v, err_msg=k)


def _check_export(d, params):
    from mixgrpo_tpu_torch.models.flux.load import load_flux_params

    exp = load_flux_params(str(d / "run" / "part_test" / "export_1"), M.FluxConfig.tiny(),
                           dtype=torch.float32, device="cpu")
    for a, b in zip(M.param_leaves(exp), M.param_leaves(params)):
        assert torch.equal(a, b)


def _one_rank(weights, tmp_path, **flags):
    """The one-rank run of ``_train_inputs`` (both prompts, accumulation 4),
    on one thread, as each spawned rank runs: the f32 GEMMs then sum in the
    ranks' order.  (The loss is a near-zero mean of advantage x (ratio - 1),
    whose rounding moves with that order: with drawn biases or an int8
    behaviour policy, one rank reads 1.2e-5 on eight threads and -8e-6 or
    1.2e-6 on one.)"""
    z1, info1 = _train_inputs(weights, str(tmp_path / "one"), dict(dp=1), accum=4)
    info1.update(flags)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tr = _trainer(MeshConfig(1, 1, 1, 1), z1, info1, info1["out_dir"])
        m1 = run_train_step(tr, tr.mesh, z1, info1)
    finally:
        torch.set_num_threads(threads)
    tr.close()
    return tr, m1


def test_forward_tp_matches_jax_and_one_rank_with_biases(biased_weights, tmp_path):
    """``flux_forward`` on the tp = 2 slices of a tree whose biases are drawn
    (``init_flux``'s are zero, which would hide a bias added on every tp
    rank) against JAX's forward on the whole tree (f32); its int8 forward
    (scales over tp, int32 sums over tp) against one rank's, bit for bit."""
    from mixgrpo_tpu_torch.ops.quant import quantize_flux_params

    rng = np.random.default_rng(5)
    cfg = M.FluxConfig.tiny()
    sm = FluxSampler(cfg, SamplerConfig(num_steps_max=T_STEPS), height=RES, width=RES,
                     text_len=TEXT_LEN, dtype=torch.float32, device="cpu")
    N, L = 2, sm.num_image_tokens
    x = dict(img=rng.standard_normal((N, L, cfg.in_channels)).astype(np.float32),
             txt=rng.standard_normal((N, TEXT_LEN, cfg.context_dim)).astype(np.float32),
             pooled=rng.standard_normal((N, cfg.pooled_dim)).astype(np.float32),
             t=np.array([0.7, 0.2], np.float32), g=np.full(N, 3.5, np.float32),
             rope_cos=sm.rope_cos.numpy(), rope_sin=sm.rope_sin.numpy())
    z = dict(x)
    save_tree("p", biased_weights, z)
    np.savez(tmp_path / "in.npz", **z)
    (tmp_path / "in.json").write_text(json.dumps(dict(mesh=dict(dp=1, tp=2))))
    ranks = spawn_ranks("forward", 2, str(tmp_path))

    want = np.asarray(JM.flux_forward(
        jax.tree.map(jnp.asarray, biased_weights), JM.FluxConfig.tiny(),
        *(jnp.asarray(x[k]) for k in ("img", "txt", "pooled", "t", "g", "rope_cos",
                                      "rope_sin")), dtype=jnp.float32, attn_impl="xla"))
    whole = load_tree("p", z)
    args = [torch.as_tensor(x[k]) for k in ("img", "txt", "pooled", "t", "g", "rope_cos",
                                            "rope_sin")]
    one_int8 = M.flux_forward(quantize_flux_params(whole), cfg, *args, dtype=torch.float32,
                              attn_impl="eager").numpy()
    for got, _ in ranks:
        np.testing.assert_allclose(got["out"], want, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got["out_int8"], one_int8)


def test_train_step_tp_matches_one_rank_and_restores_on_any_mesh(weights, tmp_path):
    """fsdp 2 x tp 2 (4 ranks, one prompt per batch rank, the tp ranks of a
    batch rank on the same rows) against one rank with the same noise; then
    its checkpoint (one file per (fsdp, tp) shard) resumed on the same mesh,
    restored bit for bit on one rank and on fsdp = 2, and the export (JAX's
    ``tests/test_checkpoint.py::test_mesh_migration_restore``)."""
    d4 = tmp_path / "four"
    d4.mkdir()
    z, info = _train_inputs(weights, str(d4 / "run"), dict(dp=1, fsdp=2, tp=2), accum=2)
    np.savez(d4 / "in.npz", **z)
    (d4 / "in.json").write_text(json.dumps(info))
    ranks = spawn_ranks("train", 4, str(d4))

    tr, m1 = _one_rank(weights, tmp_path)
    for _, j in ranks:
        for k in ("reward", "loss", "grad_norm", "reward/synthetic"):
            assert j["metrics"][k] == pytest.approx(m1[k], rel=1e-5, abs=1e-7), k
    got = load_tree("p", ranks[0][0])
    for a, b in zip(M.param_leaves(got), M.param_leaves(tr.params)):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(), rtol=1e-5, atol=ADAM_ATOL)

    for _, j in ranks:  # each rank resumed its own shard on the same mesh
        assert j["resumed"] == {"step": 1, "params_equal": True, "opt_equal": True,
                                "shard_shape": [2, 128 // 2, 3 * 128 // 2]}
    ck = d4 / "run" / "part_test" / "checkpoints" / "1"
    files = [f"shard{f}of2_tp{t}of2.pt" for f in range(2) for t in range(2)]
    assert sorted(os.listdir(ck)) == sorted(["manifest.json"] + files)
    manifest = json.load(open(ck / "manifest.json"))
    assert manifest["files"] == files
    assert manifest["specs"]["single/linear1/w"] == [[None, "fsdp", "tp"],
                                                     [128, 128, 128, 512]]
    _check_restored(_restore_one_rank(z, info), got, ranks[0][0])

    dr = tmp_path / "restore_fsdp2"
    dr.mkdir()
    np.savez(dr / "in.npz", **z)
    (dr / "in.json").write_text(json.dumps(dict(info, mesh=dict(dp=1, fsdp=2))))
    restored = spawn_ranks("restore", 2, str(dr))
    assert [j["step"] for _, j in restored] == [1, 1]
    assert restored[0][1]["shard_shape"] == [4, 128 // 2, 3 * 128 + 512]
    _check_restored((load_tree("p", restored[0][0]), restored[0][0]), got, ranks[0][0])
    _check_export(d4, got)


def test_int8_rollout_tp_matches_one_rank(weights, tmp_path):
    """An int8 rollout on tp = 2 (the row-parallel scales taken over tp, the
    int32 products summed over tp) equals one rank's bit for bit; the
    iteration on it gives one rank's rewards, grad norm and update.  (Its
    loss is not compared: with int8 behaviour log-probs it is a near-zero
    mean of advantage x log-prob differences that moves with the f32
    GEMMs' summation order, on one rank too.)"""
    from mixgrpo_tpu_torch.parallel.mesh import make_mesh
    from tests.torch_parallel_worker import case_rollout_int8

    d2 = tmp_path / "two"
    d2.mkdir()
    z, info = _train_inputs(weights, str(d2 / "run"), dict(dp=1, tp=2), accum=4)
    info["int8"] = True
    np.savez(d2 / "in.npz", **z)
    (d2 / "in.json").write_text(json.dumps(info))
    rolled = spawn_ranks("rollout_int8", 2, str(d2))
    one = {}
    case_rollout_int8(make_mesh(MeshConfig(dp=1), device="cpu"), z,
                      dict(info, mesh=dict(dp=1), out_dir=str(tmp_path / "one_roll")), one, {})
    for got, _ in rolled:
        for k in ("log_probs", "latents"):
            np.testing.assert_array_equal(got[k], one[k], err_msg=k)

    ranks = spawn_ranks("train", 2, str(d2))
    tr, m1 = _one_rank(weights, tmp_path, int8=True)
    for _, j in ranks:
        assert j["metrics"]["reward"] == m1["reward"]
        assert j["metrics"]["grad_norm"] == pytest.approx(m1["grad_norm"], rel=1e-5)
    got = load_tree("p", ranks[0][0])
    for a, b in zip(M.param_leaves(got), M.param_leaves(tr.params)):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(), rtol=1e-5, atol=ADAM_ATOL)


def _check_base_shards(shards, whole, mesh):
    """Every sharded base leaf holds 1/n of the whole leaf, n the product of
    the sizes of the mesh axes in its spec, and some leaf is cut by each
    axis of more than one rank."""
    cut_by = set()
    for path, (shape, spec) in shards.items():
        t = whole
        for k in path.split("/"):
            t = t[k]
        n = int(np.prod([mesh.get(a, 1) for a in spec if a is not None]))
        assert n > 1 and int(np.prod(shape)) * n == t.numel(), path
        cut_by |= {a for a in spec if a is not None}
    assert cut_by == {a for a in ("fsdp", "tp") if mesh.get(a, 1) > 1}


def _lora_matches_one_rank(weights, tmp_path, mesh):
    d2 = tmp_path / "two"
    d2.mkdir()
    z, info = _train_inputs(weights, str(d2 / "run"), mesh, accum=4 // mesh.get("fsdp", 1))
    info["lora"] = True
    np.savez(d2 / "in.npz", **z)
    (d2 / "in.json").write_text(json.dumps(info))
    ranks = spawn_ranks("train_lora", 2, str(d2))

    tr, m1 = _one_rank(weights, tmp_path, lora=True)
    want = [t.detach().numpy() for t in M.param_leaves(tr.lora_factors)]
    assert any(np.abs(w).max() > 0 for w in want)  # the step moved the factors
    for r, (got, j) in enumerate(ranks):
        for k in ("reward", "loss", "grad_norm", "reward/synthetic"):
            assert j["metrics"][k] == pytest.approx(m1[k], rel=1e-5, abs=1e-7), k
        for i, w in enumerate(want):
            np.testing.assert_allclose(got[f"f{i}"], w, rtol=1e-5, atol=ADAM_ATOL)
        assert j["export_writes"] == (1 if r == 0 else 0)
        _check_base_shards(j["base_shards"], load_tree("p", z), mesh)
    from mixgrpo_tpu_torch.models.flux.load import load_flux_params

    exp = load_flux_params(str(d2 / "run" / "part_test" / "export_1"), M.FluxConfig.tiny(),
                           dtype=torch.float32, device="cpu")
    for a, b in zip(M.param_leaves(exp), M.param_leaves(load_tree("p", z))):
        assert torch.equal(a, b)  # the frozen base, whole


def test_lora_train_step_two_ranks_matches_one_rank(weights, tmp_path):
    """LoRA on fsdp = 2: each rank holds half of the frozen base, the
    factors whole; 2 ranks (one prompt each) against 1 rank on the same
    global batch and noise, and the export written by rank 0 alone."""
    _lora_matches_one_rank(weights, tmp_path, dict(dp=1, fsdp=2))


def test_lora_train_step_tp_matches_one_rank(weights, tmp_path):
    """LoRA on tp = 2: the base cut into its tp slices, the blocks split,
    the factors whole and cut where they merge, both ranks on every row:
    each equals one rank."""
    _lora_matches_one_rank(weights, tmp_path, dict(dp=1, tp=2))


@pytest.mark.parametrize("mesh", [dict(dp=1, fsdp=2), dict(dp=1, tp=2)])
def test_lora_update_step_matches_jax_on_mesh(mesh, weights, tmp_path):
    from mixgrpo_tpu import lora as JLoRA

    jparams = weights
    b, sig, cos, sin, scfg = _update_inputs(jparams)
    hp = dict(lr=1e-4, wd=1e-2, max_grad_norm=1.0)
    meta = {"rank": 4, "alpha": 8.0}
    rng = np.random.default_rng(9)
    lora = JLoRA.init_lora(jax.random.key(3), jax.tree.map(jnp.asarray, jparams), rank=4,
                           alpha=8.0)
    # b drawn too, so that a's gradient and the row-parallel cut of a count
    factors = {p: {"a": np.asarray(f["a"]),
                   "b": (0.05 * rng.standard_normal(f["b"].shape)).astype(np.float32)}
               for p, f in lora["factors"].items()}
    z = dict(sigmas=sig, rope_cos=cos, rope_sin=sin, **{f"b_{k}": v for k, v in b.items()},
             **{f"f.{p.replace('/', '|')}.{k}": v for p, f in factors.items()
                for k, v in f.items()})
    save_tree("p", jparams, z)
    np.savez(tmp_path / "in.npz", **z)
    (tmp_path / "in.json").write_text(json.dumps(dict(
        mesh=mesh, sampler=dataclasses.asdict(scfg), meta=meta, **hp)))
    ranks = spawn_ranks("update_lora", 2, str(tmp_path))

    jm = JMesh.make_mesh(JMesh.MeshConfig(**mesh), devices=jax.devices()[:2])
    JSh.set_activation_mesh(jm)
    try:
        jopt = JT.make_optimizer(learning_rate=hp["lr"], weight_decay=hp["wd"],
                                 max_grad_norm=hp["max_grad_norm"])
        step = JT.make_lora_update_fns(
            JM.FluxConfig.tiny(), JR.SamplerConfig(**dataclasses.asdict(scfg)),
            JPPO(clip_range=0.2), jopt, jnp.asarray(cos), jnp.asarray(sin),
            dtype=jnp.float32, attn_impl="xla", remat=False)
        base = JSh.shard_params(jax.tree.map(jnp.asarray, jparams), jm)
        ub = JT.UpdateBatch(**{k: jax.device_put(jnp.asarray(b[k]),
                                                 JSh.data_spec(jm, b[k].ndim))
                               for k in UpdateBatch._fields})
        jf = jax.tree.map(jnp.asarray, factors)
        with jm:
            want, _, wm = step(jf, jopt.init(jf), meta, base, ub, jnp.asarray(sig))
    finally:
        JSh.set_activation_mesh(None)
    moved = 0.0
    for got, j in ranks:
        _check_base_shards(j["base_shards"], load_tree("p", z), mesh)
        for p, f in want.items():
            for k in ("a", "b"):
                w = np.asarray(f[k])
                np.testing.assert_allclose(got[f"f.{p.replace('/', '|')}.{k}"], w, rtol=1e-5,
                                           atol=ADAM_ATOL, err_msg=f"{p} {k}")
                moved = max(moved, float(np.abs(w - factors[p][k]).max()))
        assert j["metrics"]["grad_norm"] == pytest.approx(float(wm["grad_norm"]), rel=1e-5)
        assert j["metrics"]["loss"] == pytest.approx(float(wm["loss"]), rel=1e-5, abs=1e-7)
    assert moved > 1e-5  # the step moved the factors


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


def test_train_main_mesh_tp_on_two_ranks(tmp_path):
    """``train.main --mesh_dp 1 --mesh_tp 2`` under torchrun's environment
    on the rehearsal tree: both ranks step, one file per tp shard, and one
    rank (tp index 0) writes the per-sample rewards."""
    from mixgrpo_tpu_torch import preprocess as Pre
    from mixgrpo_tpu_torch import presets as P
    from tests.test_torch_load import write_rehearsal_tree

    tree = write_rehearsal_tree(tmp_path / "ck")
    (tmp_path / "ck" / "prompts.txt").write_text("a red cube\na blue sphere\n")
    cache = str(tmp_path / "cache")
    Pre.main(["--prompt_dir", str(tmp_path / "ck" / "prompts.txt"), "--output_dir", cache,
              "--model_path", tree, "--device", "cpu"], family=P.flux_family("tiny"))
    argv = ["--pretrained_model_name_or_path", tree, "--data_json_path", cache,
            "--output_dir", str(tmp_path / "out"), "--h", "32", "--w", "32",
            "--sampling_steps", "4", "--num_generations", "2", "--rollout_chunk", "2",
            "--gradient_accumulation_steps", "2", "--reward_model", "hpsv2",
            "--hps_path", str(tmp_path / "ck" / "HPS_v2.1_compressed.pt"), "--max_train_steps", "1",
            "--checkpointing_steps", "100", "--export_safetensors", "off",
            "--mesh_dp", "1", "--mesh_tp", "2", "--device", "cpu"]
    np.savez(tmp_path / "in.npz")
    (tmp_path / "in.json").write_text(json.dumps(dict(mesh={"dp": 1, "tp": 2}, argv=argv)))
    ranks = spawn_ranks("train_main", 2, str(tmp_path))
    for _, j in ranks:
        assert j["step"] == 1 and j["mesh"] == {"dp": 1, "fsdp": 1, "sp": 1, "tp": 2}
        assert j["files"] == ["manifest.json", "shard0of1_tp0of2.pt", "shard0of1_tp1of2.pt"]
        assert j["qkv_shape"] == [2, 128, 3 * 128 // 2]
    samples = [f for f in ranks[0][1]["run_files"] if f.startswith("rewards_samples")]
    assert samples == ["rewards_samples_rank0.jsonl"]


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


def test_trainer_refuses_tp_that_does_not_divide_the_heads(weights, tmp_path):
    """tp = 3 splits neither the tiny model's 4 heads nor its 512 MLP units."""
    from mixgrpo_tpu_torch.models.flux.model import FluxConfig
    from mixgrpo_tpu_torch.train import _check_tp

    _check_tp(FluxConfig.tiny(), 2)
    with pytest.raises(ValueError, match="tp=3"):
        _check_tp(FluxConfig.tiny(), 3)

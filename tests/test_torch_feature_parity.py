"""Arguments of the JAX package's entry points that the port carries with
JAX's meaning, and the port's refusal to fall back to the CPU.

- ``run_preprocess(process_index=1, process_count=2)`` against JAX's on a
  stand-in encoder: the same prompts (every second from the second), the
  same ``host_1`` file layout and equal embeddings; ``preprocess.main`` on
  two ``gloo`` ranks writes ``host_0`` and ``host_1``, each equal to the
  one-process cache's rows (f16 storage: within 1e-3).
- ``CheckpointManager(max_to_keep=2)`` after four saves (blocking and in
  the background) keeps the last two steps, as JAX's Orbax manager does,
  and restores the newest.
- ``DualFluxPipeline(virtual_depth=(3, 1))`` against JAX's (atol 1e-4),
  and different from the pipeline at its own depth.
- ``sampler.make_model_fn(remat=True)`` against JAX's (atol 1e-4), its
  gradient equal to ``remat=False``'s.
- Without a card, ``default_device()``, ``make_mesh(device=None)``,
  ``init_distributed(device=None)`` and the CLIs ``train.main``,
  ``sample.main``, ``eval_rewards.main`` and ``preprocess.main`` at their
  default ``--device cuda`` raise (skipped where a card is present).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixgrpo_tpu import preprocess as JPre
from mixgrpo_tpu import sample as JSa
from mixgrpo_tpu.data.dataset import LatentDataset as JLatentDataset
from mixgrpo_tpu.models.flux import model as JM
from mixgrpo_tpu.models.flux import vae as JV
from mixgrpo_tpu.utils.checkpoint import CheckpointManager as JCheckpointManager
from mixgrpo_tpu_torch import preprocess as Pre
from mixgrpo_tpu_torch import sample as Sa
from mixgrpo_tpu_torch.convert import from_jax_params
from mixgrpo_tpu_torch.data.dataset import LatentDataset
from mixgrpo_tpu_torch.models.flux import model as M
from mixgrpo_tpu_torch.models.flux import vae as V
from mixgrpo_tpu_torch.utils.checkpoint import CheckpointManager
from tests.torch_parallel_worker import spawn_ranks

PROMPTS = [f"prompt number {i}" for i in range(7)]


class StubEncoder:
    """Embeddings drawn from each prompt's bytes: (B, 5, 4) and (B, 3)."""

    def __call__(self, prompts):
        rows = [np.random.default_rng(list(p.encode())) for p in prompts]
        emb = np.stack([r.standard_normal((5, 4)) for r in rows]).astype(np.float32)
        pooled = np.stack([r.standard_normal(3) for r in rows]).astype(np.float32)
        return emb, pooled


def _rows(ds):
    return [(ds.get(i)["prompt_embed"], ds.get(i)["pooled"]) for i in range(len(ds))]


def test_run_preprocess_host_shard_matches_jax(tmp_path):
    got = Pre.run_preprocess(PROMPTS, StubEncoder(), str(tmp_path / "port"), batch_size=2,
                             process_index=1, process_count=2)
    want = JPre.run_preprocess(PROMPTS, StubEncoder(), str(tmp_path / "jax"), batch_size=2,
                               process_index=1, process_count=2)
    assert os.path.relpath(got, tmp_path / "port") == os.path.relpath(want, tmp_path / "jax")
    assert os.listdir(tmp_path / "port") == os.listdir(tmp_path / "jax") == ["host_1"]
    assert sorted(os.listdir(tmp_path / "port" / "host_1")) == \
        sorted(os.listdir(tmp_path / "jax" / "host_1"))
    mine = LatentDataset(str(tmp_path / "port" / "host_1"))
    ref = JLatentDataset(str(tmp_path / "jax" / "host_1"))
    assert mine.captions == list(ref.captions) == PROMPTS[1::2]
    for (e, p), (je, jp) in zip(_rows(mine), _rows(ref)):
        np.testing.assert_array_equal(e, je)
        np.testing.assert_array_equal(p, jp)
    # one process writes the cache at output_dir itself
    one = Pre.run_preprocess(PROMPTS, StubEncoder(), str(tmp_path / "one"), batch_size=3)
    assert os.path.dirname(one) == str(tmp_path / "one")
    assert LatentDataset(str(tmp_path / "one")).captions == PROMPTS


def test_preprocess_main_on_two_ranks(tmp_path):
    from mixgrpo_tpu_torch import presets as P
    from tests.test_torch_load import write_rehearsal_tree

    tree = write_rehearsal_tree(tmp_path / "ck")
    prompts = ["a red cube", "a blue sphere", "a green cone"]
    (tmp_path / "prompts.txt").write_text("\n".join(prompts) + "\n")
    argv = ["--prompt_dir", str(tmp_path / "prompts.txt"), "--model_path", tree,
            "--batch_size", "2", "--device", "cpu"]
    Pre.main(argv + ["--output_dir", str(tmp_path / "one")], family=P.flux_family("tiny"))
    np.savez(tmp_path / "in.npz")
    (tmp_path / "in.json").write_text(json.dumps(dict(
        mesh={"dp": 2}, argv=argv + ["--output_dir", str(tmp_path / "two")])))
    ranks = spawn_ranks("preprocess", 2, str(tmp_path))
    assert sorted(os.listdir(tmp_path / "two")) == ["host_0", "host_1"]
    one = LatentDataset(str(tmp_path / "one"))
    for r, (_, info) in enumerate(ranks):
        assert os.path.dirname(info["manifest"]) == str(tmp_path / "two" / f"host_{r}")
        ds = LatentDataset(str(tmp_path / "two" / f"host_{r}"))
        assert ds.captions == prompts[r::2]
        for j, (e, p) in enumerate(_rows(ds)):
            we, wp = one.get(r + 2 * j)["prompt_embed"], one.get(r + 2 * j)["pooled"]
            np.testing.assert_allclose(e, we, rtol=0, atol=1e-3)
            np.testing.assert_allclose(p, wp, rtol=0, atol=1e-3)


@pytest.mark.parametrize("blocking", [True, False])
def test_checkpoint_max_to_keep_matches_jax(tmp_path, blocking):
    mgr = CheckpointManager(str(tmp_path / "port"), max_to_keep=2)
    jmgr = JCheckpointManager(str(tmp_path / "jax"), max_to_keep=2)
    for step in range(4):
        params = {"w": torch.full((3,), float(step))}
        mgr.save(step, params, window_state={"step": step}, blocking=blocking)
        jmgr.save(step, {"w": jnp.full((3,), float(step))}, window_state={"step": step})
    mgr.wait()
    assert mgr.all_steps() == [2, 3]
    assert sorted(os.listdir(tmp_path / "port")) == ["2", "3"]
    assert jmgr._mgr.all_steps() == [2, 3]
    params, _, window, step = mgr.restore()
    assert step == jmgr.latest_step() == 3 and window == {"step": 3}
    assert torch.equal(params["w"], torch.full((3,), 3.0))
    mgr.close()
    jmgr._mgr.close()
    with pytest.raises(ValueError, match="max_to_keep"):
        CheckpointManager(str(tmp_path / "bad"), max_to_keep=0)


def test_dual_pipeline_virtual_depth_matches_jax():
    jcfg = JM.FluxConfig.tiny()
    jvcfg = JV.VAEConfig.tiny(latent_channels=jcfg.in_channels // 4)
    init = jax.jit(lambda k: JM.init_flux(k, jcfg))
    jbase, jtuned = init(jax.random.key(0)), init(jax.random.key(1))
    jvae = jax.jit(lambda k: JV.init_vae_decoder(k, jvcfg))(jax.random.key(2))
    port = lambda t: from_jax_params(jax.tree.map(np.asarray, t), "cpu")
    cfg = M.FluxConfig.tiny()
    vcfg = V.VAEConfig.tiny(latent_channels=cfg.in_channels // 4)
    kw = dict(height=32, width=32, num_steps=3, mix_sampling_steps=2, text_len=8)
    rng = np.random.default_rng(0)
    z0 = rng.standard_normal((2, 4, jcfg.in_channels)).astype(np.float32)
    txt = rng.standard_normal((2, 8, jcfg.context_dim)).astype(np.float32)
    pooled = rng.standard_normal((2, jcfg.pooled_dim)).astype(np.float32)
    outs = {}
    for vd in ((3, 1), None):
        pipe = Sa.DualFluxPipeline(cfg, port(jbase), port(jtuned), vae_cfg=vcfg,
                                   vae_params=port(jvae), dtype=torch.float32, device="cpu",
                                   virtual_depth=vd, **kw)
        outs[vd] = pipe(torch.from_numpy(txt), torch.from_numpy(pooled),
                        z0=torch.from_numpy(z0)).numpy()
    jpipe = JSa.DualFluxPipeline(jcfg, jbase, jtuned, vae_cfg=jvcfg, vae_params=jvae,
                                 dtype=jnp.float32, attn_impl="xla", virtual_depth=(3, 1), **kw)
    want = np.asarray(jpipe(jnp.asarray(txt), jnp.asarray(pooled), jax.random.key(0),
                            z0=jnp.asarray(z0)))
    np.testing.assert_allclose(outs[(3, 1)], want, rtol=0, atol=1e-4)
    assert np.abs(outs[(3, 1)] - outs[None]).max() > 1e-3


needs_no_card = pytest.mark.skipif(torch.cuda.is_available(),
                                   reason="a card is present: the default device works")


@needs_no_card
def test_mesh_defaults_raise_without_a_card():
    from mixgrpo_tpu_torch.parallel import mesh as Mesh

    with pytest.raises(RuntimeError, match="device='cpu'"):
        Mesh.default_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Mesh.make_mesh(Mesh.MeshConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Mesh.init_distributed()
    assert Mesh.make_mesh(Mesh.MeshConfig(), device="cpu").device == torch.device("cpu")
    assert Mesh.resolve_device("cpu") == torch.device("cpu")


def _cli_argv(tmp_path):
    d = str(tmp_path)
    return {
        "train": ["--output_dir", d],
        "sample": ["--model_path", d, "--prompt_path", d, "--output_dir", d],
        "eval_rewards": ["--metadata", d, "--image_dir", d, "--output_dir", d],
        "preprocess": ["--prompt_dir", d, "--output_dir", d, "--model_path", d],
    }


@needs_no_card
@pytest.mark.parametrize("cli", ["train", "sample", "eval_rewards", "preprocess"])
def test_cli_at_its_default_device_raises_without_a_card(tmp_path, cli):
    import importlib

    main = importlib.import_module(f"mixgrpo_tpu_torch.{cli}").main
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(_cli_argv(tmp_path)[cli])
    assert not os.listdir(tmp_path)  # nothing was written before the refusal


def test_make_model_fn_remat_matches_jax():
    """``sampler.make_model_fn(remat=True)``: the velocity equals JAX's
    ``make_model_fn(remat=True)`` (f32, atol 1e-4), and its gradient with
    respect to the latents, through the recomputed blocks, equals the one
    without recomputation."""
    from mixgrpo_tpu import sampler as JS
    from mixgrpo_tpu_torch import sampler as S
    from mixgrpo_tpu_torch.models.flux.rope import make_image_ids, make_text_ids, rope_tables

    jcfg, cfg = JM.FluxConfig.tiny(), M.FluxConfig.tiny()
    jparams = jax.jit(lambda k: JM.init_flux(k, jcfg))(jax.random.key(4))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(5)
    z = rng.standard_normal((2, 16, jcfg.in_channels)).astype(np.float32)
    txt = rng.standard_normal((2, 4, jcfg.context_dim)).astype(np.float32)
    pooled = rng.standard_normal((2, jcfg.pooled_dim)).astype(np.float32)
    ids = np.concatenate([make_text_ids(4), make_image_ids(8, 8)])
    cos, sin = (t.float() for t in rope_tables(ids, cfg.axes_dims, cfg.theta, device="cpu"))
    want = JS.make_model_fn(jparams, jcfg, jnp.asarray(txt), jnp.asarray(pooled), 3.5,
                            jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy()),
                            dtype=jnp.float32, attn_impl="xla", remat=True)(
        jnp.asarray(z), jnp.float32(0.6))
    grads = {}
    for remat in (True, False):
        fn = S.make_model_fn(params, cfg, torch.from_numpy(txt), torch.from_numpy(pooled), 3.5,
                             cos, sin, dtype=torch.float32, attn_impl="eager", remat=remat)
        zz = torch.from_numpy(z).requires_grad_(True)
        out = fn(zz, 0.6)
        out.square().sum().backward()
        grads[remat] = zz.grad
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=0, atol=1e-4)
    torch.testing.assert_close(grads[True], grads[False], rtol=0, atol=0)

"""The port's HunyuanVideo DiT, loader, pipeline and sampler against the JAX
package on the same numpy inputs, at ``HunyuanVideoConfig.tiny()`` in f32.

The weights are the port's ``init_hunyuan_video`` and
``init_causal_vae_decoder`` draws (their tree structure and shapes checked
against JAX's inits), with each all-zero leaf (the refiner's gates, every
bias) redrawn (normal, std 0.05), so the refiner's attention, the biases
and the final layer's (shift, scale) order all reach the output; JAX runs
on the same numpy tree.

- ``make_video_ids`` and the scheduler: equal (atol 0).
- the token refiner, with a mask whose first token is padding (JAX forces
  query row 0's key valid): atol 1e-5.
- ``hunyuan_video_forward`` with and without a text mask: atol 2e-4 (the
  matmul sums run in another order over 3 blocks, as in
  tests/test_torch_flux_model.py); the port's padded forward (S = 6 + 1024
  padded to 1152, the pad keys False in the key mask) against JAX's unpadded
  one: atol 2e-4.
- ``load_hunyuan_video`` on a released-layout ``.pt`` against JAX's
  ``convert_hunyuan_state_dict``, leaf for leaf (equal), the inferred
  config, and ``export_hunyuan_state_dict`` back to the same tensors.
- the pipeline fed JAX's initial noise (``z0``): latents atol 2e-4, the
  decoded video (plain and tiled) atol 1e-4 after clipping to [0, 1].
- ``HunyuanVideoSampler.predict``: the seed fan-out against JAX's
  ``_resolve_seeds``, the result dict, per-video generators, and the input
  checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixgrpo_tpu.models.hunyuan import load as JLd
from mixgrpo_tpu.models.hunyuan import model as JM
from mixgrpo_tpu.models.hunyuan import pipeline as JP
from mixgrpo_tpu.models.hunyuan import sampler as JSa
from mixgrpo_tpu.models.hunyuan import scheduler as JSc
from mixgrpo_tpu.models.hunyuan import vae3d as JV
from mixgrpo_tpu_torch.convert import from_jax_params
from mixgrpo_tpu_torch.models.hunyuan import load as Ld
from mixgrpo_tpu_torch.models.hunyuan import model as M
from mixgrpo_tpu_torch.models.hunyuan import pipeline as P
from mixgrpo_tpu_torch.models.hunyuan import sampler as Sa
from mixgrpo_tpu_torch.models.hunyuan import scheduler as Sc
from mixgrpo_tpu_torch.models.hunyuan import vae3d as V

ATOL = 2e-4
CFG, JCFG = M.HunyuanVideoConfig.tiny(), JM.HunyuanVideoConfig.tiny()
VCFG, JVCFG = V.CausalVAEConfig.tiny(), JV.CausalVAEConfig.tiny()


def _np_tree(init, cfg, jinit, jcfg, seed):
    """The port's init as numpy, each all-zero leaf redrawn (normal, std
    0.05); its structure and shapes are JAX's init's."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda t: t.numpy(), init(
        cfg, generator=torch.Generator().manual_seed(seed), device="cpu"))
    tree = jax.tree.map(lambda a: a if a.any() else
                        (rng.standard_normal(a.shape) * 0.05).astype(np.float32), tree)
    want = jax.eval_shape(lambda: jinit(jax.random.key(0), jcfg))
    assert jax.tree.structure(want) == jax.tree.structure(tree)
    assert [w.shape for w in jax.tree.leaves(want)] == [a.shape for a in jax.tree.leaves(tree)]
    return tree


@pytest.fixture(scope="module")
def weights():
    """(numpy tree, JAX tree, torch tree) of the tiny DiT."""
    tree = _np_tree(M.init_hunyuan_video, CFG, JM.init_hunyuan_video, JCFG, 0)
    return tree, jax.tree.map(jnp.asarray, tree), from_jax_params(tree, "cpu")


@pytest.fixture(scope="module")
def vae():
    tree = _np_tree(V.init_causal_vae_decoder, VCFG, JV.init_causal_vae_decoder, JVCFG, 1)
    return jax.tree.map(jnp.asarray, tree), from_jax_params(tree, "cpu")


def _inputs(B=2, T=2, H=8, W=8, L=6, seed=3):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    mask = np.ones((B, L), np.int32)
    mask[0, 4:] = 0
    return dict(z=f(B, T, H, W, CFG.in_channels), txt=f(B, L, CFG.text_states_dim),
                pooled=f(B, CFG.text_states_dim_2), t=np.array([0.7, 0.2][:B], np.float32),
                g=np.full((B,), 6.0, np.float32), mask=mask)


def test_video_ids_and_scheduler_match_jax():
    np.testing.assert_array_equal(M.make_video_ids(3, 8, 6), JM.make_video_ids(3, 8, 6))
    for shift, steps, reverse in ((7.0, 50, True), (1.0, 4, True), (3.0, 5, False)):
        s, js = Sc.FlowMatchDiscreteScheduler(shift=shift, reverse=reverse), \
            JSc.FlowMatchDiscreteScheduler(shift=shift, reverse=reverse)
        np.testing.assert_array_equal(s.set_timesteps(steps), js.set_timesteps(steps))
        np.testing.assert_array_equal(s.sigmas, js.sigmas)
        assert s.sigmas.dtype == np.float32
        x = np.random.default_rng(0).standard_normal((2, 3)).astype(np.float32)
        v = np.ones_like(x)
        np.testing.assert_array_equal(s.step(torch.from_numpy(v), 1, torch.from_numpy(x)).numpy(),
                                      np.asarray(js.step(v, 1, jnp.asarray(x))))


def test_refiner_matches_jax(weights):
    tree, jp, tp = weights
    x = _inputs()
    mask = x["mask"].copy()
    mask[1, 0] = 0  # padding in front: query row 0 keeps key 0 all the same
    want = JM._refine_text(jp["txt_in"], JCFG, jnp.asarray(x["txt"]), jnp.asarray(x["t"] * 1000),
                           jnp.asarray(mask), jnp.float32)
    got = M._refine_text(tp["txt_in"], CFG, torch.from_numpy(x["txt"]),
                         torch.from_numpy(x["t"] * 1000), torch.from_numpy(mask),
                         torch.float32, "bhsd")
    assert np.abs(np.asarray(want)).max() > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


_JAX_FORWARD = jax.jit(lambda p, *a: JM.hunyuan_video_forward(
    p, JCFG, *a, dtype=jnp.float32, attn_impl="xla", remat=False))


def _jax_forward(jp, x, mask=True):
    return np.asarray(_JAX_FORWARD(
        jp, jnp.asarray(x["z"]), jnp.asarray(x["txt"]), jnp.asarray(x["pooled"]),
        jnp.asarray(x["t"]), jnp.asarray(x["g"]), jnp.asarray(x["mask"]) if mask else None))


def _forward(tp, x, mask=True, **kw):
    t = torch.from_numpy
    with torch.no_grad():
        return M.hunyuan_video_forward(
            tp, CFG, t(x["z"]), t(x["txt"]), t(x["pooled"]), t(x["t"]), t(x["g"]),
            t(x["mask"]) if mask else None, dtype=torch.float32, attn_impl="eager", **kw).numpy()


@pytest.mark.parametrize("mask", [True, False], ids=["text_mask", "no_mask"])
def test_forward_matches_jax(weights, mask):
    _, jp, tp = weights
    x = _inputs()
    want = _jax_forward(jp, x, mask)
    got = _forward(tp, x, mask)
    assert got.shape == x["z"].shape and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if mask:  # the mask reaches the output
        assert np.abs(got - _forward(tp, x, False)).max() > 1e-3


def test_padded_masked_forward_matches_unpadded_jax(weights):
    """S = 6 + 4*16*16 = 1030 runs as 1152: the 122 pad keys join the text
    mask as False keys (identity RoPE), and are sliced off again."""
    _, jp, tp = weights
    x = _inputs(B=2, T=4, H=32, W=32)
    want = _jax_forward(jp, x)
    got = _forward(tp, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(_forward(tp, x, pad_seq_multiple=0), want, rtol=0, atol=ATOL)
    # without a text mask the pad tail is the kv_valid prefix
    np.testing.assert_allclose(_forward(tp, x, mask=False), _jax_forward(jp, x, mask=False),
                               rtol=0, atol=ATOL)


def test_load_and_export_match_jax(weights, tmp_path):
    tree, jp, _ = weights
    sd = JLd.export_hunyuan_state_dict(jp, JCFG)
    path = tmp_path / "ckpt"
    path.mkdir()
    torch.save({"module": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}},
               path / "pytorch_model_module.pt")
    want, jcfg = JLd.convert_hunyuan_state_dict(sd)
    inferred = Ld.infer_hunyuan_config(sd)
    assert inferred == M.HunyuanVideoConfig(**vars(jcfg))
    # the tiny config's RoPE split (8, 8, 8) is not the one inferred from D = 24
    assert inferred.rope_dim_list == (6, 9, 9)
    assert inferred == M.HunyuanVideoConfig(**{**vars(CFG), "rope_dim_list": (6, 9, 9)})
    assert Ld.resolve_checkpoint_path(str(path)) == str(path / "pytorch_model_module.pt")
    got, cfg = Ld.load_hunyuan_video(str(path), device="cpu", dtype=torch.float32)
    assert cfg == inferred
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [k for k, _ in flat_w] == [k for k, _ in flat_g]
    for (k, w), (_, g) in zip(flat_w, flat_g):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=str(k))
    # the leaves equal the tree they were exported from
    for (k, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(tree)[0], flat_g):
        np.testing.assert_array_equal(b.numpy(), a, err_msg=str(k))
    back = Ld.export_hunyuan_state_dict(got, cfg)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
        assert back[k].is_contiguous()
    bf = Ld.load_hunyuan_video(str(path / "pytorch_model_module.pt"), device="cpu")[0]
    assert bf["double"]["img_qkv"]["w"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="cannot resolve"):
        Ld.resolve_checkpoint_path(str(tmp_path))


def _pipelines(weights, vae, **kw):
    _, jp, tp = weights
    jv, tv = vae if vae else (None, None)
    j = JP.HunyuanVideoPipeline(JCFG, jp, vae_cfg=JVCFG if vae else None, vae_params=jv,
                                num_steps=3, dtype=jnp.float32, attn_impl="xla", **kw)
    p = P.HunyuanVideoPipeline(CFG, tp, vae_cfg=VCFG if vae else None, vae_params=tv,
                               num_steps=3, dtype=torch.float32, attn_impl="eager",
                               device="cpu", **kw)
    return j, p


@pytest.mark.parametrize("tiling", ["off", "on"])
def test_pipeline_matches_jax(weights, vae, tiling):
    """5 frames at 32x32 (latents (2, 4, 4)): the latents, then the decoded
    video, plain and in tiles (``on`` tiles even one tile's worth)."""
    x = _inputs(B=1)
    rng = jax.random.key(4)
    z0 = np.array(jax.random.normal(rng, (1, 2, 4, 4, CFG.in_channels), jnp.float32))
    kw = dict(video_length=5, height=32, width=32)
    j, p = _pipelines(weights, None)
    want = np.asarray(j(jnp.asarray(x["txt"]), jnp.asarray(x["pooled"]), rng=rng,
                        text_mask=jnp.asarray(x["mask"]), **kw))
    got = p(torch.from_numpy(x["txt"]), torch.from_numpy(x["pooled"]),
            text_mask=torch.from_numpy(x["mask"]), z0=torch.from_numpy(z0), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    j, p = _pipelines(weights, vae, vae_tiling=tiling)
    want = np.asarray(j(jnp.asarray(x["txt"]), jnp.asarray(x["pooled"]), rng=rng, **kw))
    got = p(torch.from_numpy(x["txt"]), torch.from_numpy(x["pooled"]),
            z0=torch.from_numpy(z0), **kw).numpy()
    assert got.shape == (1, 5, 32, 32, 3) and 0 <= got.min() and got.max() <= 1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert p.tiles((1, 18, 4, 4, 4)) == (tiling != "off")


class _Encoder:
    """A stand-in text encoder: a fixed draw per prompt."""

    def __call__(self, prompts, data_type="video"):
        assert data_type == "video"
        rng = [np.random.default_rng(len(p)) for p in prompts]
        txt = np.stack([r.standard_normal((6, CFG.text_states_dim)) for r in rng])
        mask = np.ones((len(prompts), 6), np.int64)
        mask[:, 5:] = 0
        return torch.from_numpy(txt.astype(np.float32)), torch.from_numpy(mask)


def test_predict_seeds_outputs_and_checks(weights, vae):
    for seed, b, n in ((None, 2, 2), (5, 2, 2), ([3, 9], 2, 2), ([1, 2, 3, 4], 2, 2),
                       (7, 1, 3)):
        got = Sa._resolve_seeds(seed, b, n)
        assert len(got) == b * n
        if seed is not None:
            assert got == JSa._resolve_seeds(seed, b, n)
    with pytest.raises(ValueError, match="Length of seed"):
        Sa._resolve_seeds([1, 2, 3], 2, 2)

    _, p = _pipelines(weights, vae)
    p.text_encoder = _Encoder()
    sampler = Sa.HunyuanVideoSampler(p)
    out = sampler.predict(["a cat", "a red dog"], height=32, width=32, video_length=5, seed=11,
                          num_videos_per_prompt=2)
    assert sorted(out) == ["negative_prompt", "prompts", "samples", "seeds"]
    assert out["seeds"] == [11, 12, 11, 12] and out["prompts"] == ["a cat", "a red dog"]
    assert out["negative_prompt"] == JSa.NEGATIVE_PROMPT
    assert len(out["samples"]) == 4
    for s in out["samples"]:
        assert s.shape == (5, 32, 32, 3) and s.dtype == np.float32
        assert np.isfinite(s).all() and 0 <= s.min() and s.max() <= 1
    # each video is its own batch-1 call, seeded with its seed
    txt, mask = _Encoder()(["a red dog"])
    one = p(txt, torch.zeros((1, CFG.text_states_dim_2)), text_mask=mask, video_length=5,
            height=32, width=32, generator=torch.Generator().manual_seed(12))
    np.testing.assert_array_equal(out["samples"][3], one[0].numpy())
    assert not np.array_equal(out["samples"][2], out["samples"][3])
    for kw, msg in ((dict(video_length=6), "multiple of 4"), (dict(height=0), "positive"),
                    (dict(seed=[1, 2, 3]), "Length of seed")):
        with pytest.raises(ValueError, match=msg):
            sampler.predict(["a", "b"], **{"height": 32, "width": 32, "video_length": 5, **kw})
    p.text_encoder = None
    with pytest.raises(ValueError, match="text_encoder"):
        sampler.predict("a cat", height=32, width=32, video_length=5)

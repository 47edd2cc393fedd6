"""The port's Mochi DiT, loaders, export, CLI and CFG pipeline against the JAX
package on the same numpy inputs, at ``MochiConfig.tiny()``.

The weights are the port's ``init_mochi`` draw (its tree structure and shapes
checked against JAX's ``init_mochi``), with every bias and every RMS-norm
scale moved off its init (normal, std 0.05), so each reaches the output;
JAX runs on the same numpy tree.

- ``mochi_positions``: equal; ``mochi_rope`` and the adjacent-pair
  rotation: atol 1e-6.
- the attention pool, with padded tokens (finfo(f32).min fill): atol 1e-5;
  the mask changes it.
- ``mochi_forward`` in f32, with and without a text mask, through ``flash``
  (the kernel's plain version on the CPU) and ``eager``: atol 2e-4 (matmul sums in another order over 2 blocks, as the FLUX and
  HunyuanVideo tests); in bf16: within 2% of max |JAX| elementwise and rel
  L2 1e-2 (bf16 rounding of the residual stream, placed differently by the
  two compilers); the caption and the mask change the output, the padded
  tokens' features change no bit of it.  The port keeps padded text out of
  the joint attention as the published model does, where JAX masks the
  pooler only: with a mask, each row is held against JAX fed that row's
  valid tokens and an all-ones mask (exact for JAX's pooler, whose masked
  keys get zero weight).
- the gradient of a loss through ``mochi_forward`` (remat on) with respect
  to the latents and every weight, ``flash`` and ``eager``: atol 1e-4
  relative to each gradient's max.
- the final block attends with Sq = visual tokens and Sk = visual + the
  valid text, and leaves the text stream as it was.
- the loader and the export against JAX's, leaf for leaf (equal); the
  convert CLI round trip (equal); the inferred config.
- the pipeline with CFG fed JAX's ``z0`` (a masked prompt: JAX fed its
  valid tokens, and the port's unmasked negative prompt): latents atol
  2e-4; the decoded
  video plain, and tiled by ``"auto"`` (a 34 x 34 latent): atol 1e-4.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixgrpo_tpu.models.mochi import convert as JC
from mixgrpo_tpu.models.mochi import latents as JLat
from mixgrpo_tpu.models.mochi import load as JLd
from mixgrpo_tpu.models.mochi import model as JM
from mixgrpo_tpu.models.mochi import pipeline as JP
from mixgrpo_tpu.models.mochi import vae as JV
from mixgrpo_tpu_torch.convert import from_jax_params
from mixgrpo_tpu_torch.models.flux.model import param_count
from mixgrpo_tpu_torch.models.mochi import convert as C
from mixgrpo_tpu_torch.models.mochi import latents as Lat
from mixgrpo_tpu_torch.models.mochi import load as Ld
from mixgrpo_tpu_torch.models.mochi import model as M
from mixgrpo_tpu_torch.models.mochi import pipeline as P
from mixgrpo_tpu_torch.models.mochi import vae as V
from mixgrpo_tpu_torch.utils.safetensors_io import SafetensorsDir, save_file

ATOL = 2e-4
CFG, JCFG = M.MochiConfig.tiny(), JM.MochiConfig.tiny()


def _np_tree(init, cfg, jinit, jcfg, seed):
    """The port's init as numpy, each constant leaf (biases, norm scales)
    moved off its init value; the structure and shapes are JAX's init's."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda t: t.numpy(), init(
        cfg, generator=torch.Generator().manual_seed(seed), device="cpu"))
    tree = jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)
                        if np.ptp(a) == 0 else a, tree)
    want = jax.eval_shape(lambda: jinit(jax.random.key(0), jcfg))
    assert jax.tree.structure(want) == jax.tree.structure(tree)
    assert [w.shape for w in jax.tree.leaves(want)] == [a.shape for a in jax.tree.leaves(tree)]
    return tree


def _weights(cfg, jcfg, seed):
    tree = _np_tree(M.init_mochi, cfg, JM.init_mochi, jcfg, seed)
    return tree, jax.tree.map(jnp.asarray, tree), from_jax_params(tree, "cpu")


@pytest.fixture(scope="module")
def weights():
    """(numpy tree, JAX tree, torch tree) of the tiny DiT."""
    return _weights(CFG, JCFG, 0)


def _inputs(B=2, T=2, H=8, W=6, L=6, seed=3):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    mask = np.ones((B, L), np.int32)
    mask[0, 4:] = 0
    return dict(z=f(B, T, H, W, CFG.in_channels), txt=f(B, L, CFG.text_embed_dim),
                t=np.array([0.7, 0.2][:B], np.float32), mask=mask)


_JAX_FORWARD = jax.jit(lambda p, z, txt, t, mask, dtype: JM.mochi_forward(
    p, JCFG, z, txt, t, mask, dtype=dtype, attn_impl="xla", remat=False),
    static_argnames="dtype")


def _jax_forward(jp, x, mask=True, dtype=jnp.float32):
    """JAX's forward; with ``mask`` each row fed its valid tokens and an
    all-ones mask."""
    if not mask:
        return np.asarray(_JAX_FORWARD(jp, jnp.asarray(x["z"]), jnp.asarray(x["txt"]),
                                       jnp.asarray(x["t"]), None, dtype=dtype), np.float32)
    rows = []
    for b, keep in enumerate(x["mask"].astype(bool)):
        rows.append(np.asarray(_JAX_FORWARD(
            jp, jnp.asarray(x["z"][b:b + 1]), jnp.asarray(x["txt"][b:b + 1, keep]),
            jnp.asarray(x["t"][b:b + 1]), jnp.ones((1, int(keep.sum())), jnp.int32),
            dtype=dtype), np.float32))
    return np.concatenate(rows)


def _forward(tp, x, mask=True, dtype=torch.float32, impl="flash", **kw):
    t = torch.from_numpy
    with torch.no_grad():
        return M.mochi_forward(tp, CFG, t(x["z"]), t(x["txt"]), t(x["t"]),
                               t(x["mask"]) if mask else None, dtype=dtype, attn_impl=impl,
                               **kw).float().numpy()


def test_config_and_param_count_match_jax():
    assert dataclasses.asdict(CFG) == dataclasses.asdict(JCFG)
    assert dataclasses.asdict(M.MochiConfig.mochi_preview()) == dataclasses.asdict(
        JM.MochiConfig.mochi_preview())
    n = param_count(M.init_mochi(M.MochiConfig.mochi_preview(), device="meta",
                                 dtype=torch.bfloat16))
    want = jax.eval_shape(lambda: JM.init_mochi(jax.random.key(0), JM.MochiConfig()))
    assert n == sum(x.size for x in jax.tree.leaves(want)) == 10_027_459_504


def test_positions_rope_and_latent_stats_match_jax():
    for t, h, w in ((3, 4, 5), (2, 30, 53)):
        np.testing.assert_array_equal(M.mochi_positions(t, h, w, 192 * 192),
                                      JM.mochi_positions(t, h, w, 192 * 192))
    pos = M.mochi_positions(3, 4, 5, 192 * 192)
    freqs = np.random.default_rng(0).standard_normal((3, 2, 8)).astype(np.float32) * 0.3
    jc, js = JM.mochi_rope(jnp.asarray(freqs), pos)
    c, s = M.mochi_rope(torch.from_numpy(freqs), pos)
    assert tuple(c.shape) == (60, 2, 8)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    x = np.random.default_rng(1).standard_normal((2, 2, 60, 16)).astype(np.float32)
    want = np.asarray(JM._apply_mochi_rope(jnp.asarray(x), jc, js))
    got = M._apply_mochi_rope(torch.from_numpy(x), c, s)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # the pairs are adjacent channels: (0, 1) rotate together, not (0, D/2)
    assert not np.allclose(want[..., 0], x[..., 0])
    lat = np.random.default_rng(2).standard_normal((1, 2, 3, 3, 12)).astype(np.float32)
    for f, jf in ((Lat.normalize_dit_input, JLat.normalize_dit_input),
                  (Lat.denormalize_dit_output, JLat.denormalize_dit_output)):
        np.testing.assert_allclose(f(torch.from_numpy(lat)).numpy(),
                                   np.asarray(jf(jnp.asarray(lat))), rtol=0, atol=1e-6)


def test_attention_pool_matches_jax(weights):
    _, jp, tp = weights
    x = _inputs()
    want = np.asarray(JM._attention_pool(jp["pooler"], jnp.asarray(x["txt"]),
                                         jnp.asarray(x["mask"]), 8, jnp.float32))
    got = M._attention_pool(tp["pooler"], torch.from_numpy(x["txt"]),
                            torch.from_numpy(x["mask"]), 8, torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    unmasked = M._attention_pool(tp["pooler"], torch.from_numpy(x["txt"]), None, 8,
                                 torch.float32).numpy()
    assert np.abs(unmasked[0] - got[0]).max() > 1e-3  # row 0 has padding
    np.testing.assert_allclose(unmasked[1], got[1], rtol=0, atol=1e-6)  # row 1 has none


@pytest.mark.parametrize("impl", ["flash", "eager"])
@pytest.mark.parametrize("mask", [True, False], ids=["text_mask", "no_mask"])
def test_forward_matches_jax(weights, mask, impl):
    _, jp, tp = weights
    x = _inputs()
    want = _jax_forward(jp, x, mask)
    got = _forward(tp, x, mask, impl=impl)
    assert got.shape == x["z"].shape and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_forward_bf16_matches_jax(weights):
    _, jp, tp = weights
    x = _inputs()
    want = _jax_forward(jp, x, dtype=jnp.bfloat16)
    got = _forward(tp, x, dtype=torch.bfloat16)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 0.02 * scale
    assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)


def test_caption_and_pooler_mask_change_the_output(weights):
    """The caption reaches the output, and the text mask does too; the
    padded tokens' features do not, through the pooler or the joint
    attention (JAX's joint attention would read them: it is fed the valid
    tokens)."""
    _, jp, tp = weights
    x = _inputs()
    other = dict(x, txt=x["txt"] + 1.0)
    assert np.abs(_forward(tp, x) - _forward(tp, other)).max() > 1e-3
    assert np.abs(_forward(tp, x) - _forward(tp, x, mask=False))[0].max() > 1e-3
    pad = dict(x, txt=x["txt"].copy())
    pad["txt"][0, 4:] += 1.0  # row 0's padded tokens
    got = _forward(tp, pad)
    np.testing.assert_array_equal(got, _forward(tp, x))
    np.testing.assert_allclose(got, _jax_forward(jp, pad), rtol=0, atol=ATOL)


def test_final_block_attends_visual_queries_over_joint_keys(weights, monkeypatch):
    _, jp, tp = weights
    x = _inputs(B=1)
    seen = []
    attention = M.attention

    def spy(q, k, v, **kw):
        seen.append((q.shape[2], k.shape[2]))
        return attention(q, k, v, **kw)

    monkeypatch.setattr(M, "attention", spy)
    _forward(tp, x)
    n_vis, n_txt = 2 * (8 // 2) * (6 // 2), int(x["mask"].sum())  # the text cut to its valid tokens
    assert seen == [(n_vis + n_txt, n_vis + n_txt)] * (CFG.num_layers - 1) + [
        (n_vis, n_vis + n_txt)]
    # the final block alone, against JAX's: the text stream comes out as it went in
    rng = np.random.default_rng(5)
    xs, cs = rng.standard_normal((1, n_vis, CFG.dim)), rng.standard_normal((1, n_txt,
                                                                            CFG.text_dim))
    temb = rng.standard_normal((1, CFG.dim))
    pos = M.mochi_positions(2, 4, 3, 192 * 192)
    cos, sin = M.mochi_rope(tp["pos_frequencies"], pos)
    jcos, jsin = JM.mochi_rope(jp["pos_frequencies"], pos)
    a = [v.astype(np.float32) for v in (xs, cs, temb)]
    gx, gc = M._mochi_block(tp["final_block"], CFG, *map(torch.from_numpy, a), cos, sin, True,
                            "flash", torch.float32)
    wx, wc = JM._mochi_block(jp["final_block"], JCFG, *map(jnp.asarray, a), jcos, jsin, True,
                             "xla", jnp.float32)
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(gc.numpy(), a[1])
    np.testing.assert_array_equal(np.asarray(wc), a[1])


def _loss_weights(shape):
    return np.random.default_rng(11).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("impl", ["flash", "eager"])
def test_gradient_matches_jax(weights, impl):
    tree, jp, _ = weights
    x = _inputs()
    w = _loss_weights(x["z"].shape)

    def jloss(p, z):  # each row on its valid tokens
        loss = 0.0
        for b, keep in enumerate(x["mask"].astype(bool)):
            out = JM.mochi_forward(p, JCFG, z[b:b + 1], jnp.asarray(x["txt"][b:b + 1, keep]),
                                   jnp.asarray(x["t"][b:b + 1]),
                                   jnp.ones((1, int(keep.sum())), jnp.int32), dtype=jnp.float32,
                                   attn_impl="xla", remat=True)
            loss = loss + jnp.sum(out * w[b:b + 1])
        return loss

    jg_p, jg_z = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x["z"]))
    tp = from_jax_params(tree, "cpu")
    leaves = jax.tree.leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    z = torch.from_numpy(x["z"]).requires_grad_(True)
    out = M.mochi_forward(tp, CFG, z, torch.from_numpy(x["txt"]), torch.from_numpy(x["t"]),
                          torch.from_numpy(x["mask"]), dtype=torch.float32, attn_impl=impl)
    (out * torch.from_numpy(w)).sum().backward()
    pairs = [(z.grad, jg_z)] + list(zip([t.grad for t in leaves], jax.tree.leaves(jg_p)))
    for got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * max(np.abs(want).max(), 1e-3))
    assert np.abs(np.asarray(jg_p["blocks"]["qkv"]["w"])).max() > 1e-2


def test_load_export_and_cli_match_jax(weights, tmp_path):
    tree, jp, tp = weights
    st = JC.export_mochi_diffusers(jp, JCFG)
    mine = C.export_mochi_diffusers(tp, CFG)
    assert sorted(mine) == sorted(st)
    for k, v in st.items():
        np.testing.assert_array_equal(mine[k].numpy(), v, err_msg=k)
        assert mine[k].is_contiguous() and mine[k].dtype == torch.float32
    d = str(tmp_path / "transformer")
    C.save_mochi_diffusers(tp, CFG, d)
    want = JLd.load_mochi_checkpoint(d, JCFG)
    got = Ld.load_mochi_checkpoint(d, device="cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [k for k, _ in flat_w] == [k for k, _ in flat_g]
    for (k, a), (_, b) in zip(flat_w, flat_g):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=str(k))
    for (k, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(tree)[0], flat_g):
        np.testing.assert_array_equal(b.numpy(), a, err_msg=str(k))
    # the config is read from the tensors; what the weights do not hold stays default
    assert Ld.infer_mochi_config(SafetensorsDir(d)) == dataclasses.replace(CFG, max_text_len=256)
    assert Ld.infer_mochi_config(st) == Ld.infer_mochi_config(SafetensorsDir(d))
    bf = Ld.load_mochi_checkpoint(d, CFG, device="cpu", dtype=torch.bfloat16)
    assert bf["blocks"]["qkv"]["w"].dtype == torch.bfloat16
    # the CLI round trip: every tensor back as it was written
    out = str(tmp_path / "round_trip")
    assert C.main(["--in", d, "--out", out, "--device", "cpu"]) == os.path.join(
        out, "diffusion_pytorch_model.safetensors")
    a, b = SafetensorsDir(d), SafetensorsDir(out)
    assert sorted(a) == sorted(b) == sorted(st)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # JAX's loader reads a file the port's writer wrote from JAX's own export
    save_file({k: np.array(v) for k, v in st.items()},
              str(tmp_path / "jax_export" / "diffusion_pytorch_model.safetensors"))
    again = Ld.load_mochi_checkpoint(str(tmp_path / "jax_export"), CFG, device="cpu")
    for (k, a), (_, b) in zip(flat_g, jax.tree_util.tree_flatten_with_path(again)[0]):
        assert torch.equal(a, b), k


PCFG = dataclasses.replace(CFG, in_channels=12)  # the published latent statistics apply
JPCFG = dataclasses.replace(JCFG, in_channels=12)
VCFG = dataclasses.replace(V.MochiVAEConfig.tiny(), latent_channels=12)
JVCFG = dataclasses.replace(JV.MochiVAEConfig.tiny(), latent_channels=12)


def _pipelines(jp, tp, vae, **kw):
    jv, tv = vae if vae else (None, None)
    j = JP.MochiPipeline(JPCFG, jp, num_steps=3, dtype=jnp.float32, attn_impl="xla",
                         vae_cfg=JVCFG if vae else None, vae_params=jv, **kw)
    p = P.MochiPipeline(PCFG, tp, num_steps=3, dtype=torch.float32, attn_impl="eager",
                        vae_cfg=VCFG if vae else None, vae_params=tv, device="cpu", **kw)
    return j, p


@pytest.mark.parametrize("size", [(16, 16), (272, 272)], ids=["whole", "tiled"])
def test_pipeline_matches_jax(size):
    """7 frames (2 latent frames), CFG 4.5 over 3 linear-quadratic steps with
    JAX's ``z0``: the latents without a VAE, then the decoded video, whole
    at 16 x 16 and in 2 x 2 tiles at 272 x 272 (a 34 x 34 latent)."""
    from mixgrpo_tpu_torch.solvers.distill import linear_quadratic_schedule

    _, jp, tp = _weights(PCFG, JPCFG, 7)
    vtree = _np_tree(V.init_mochi_vae_decoder, VCFG, JV.init_mochi_vae_decoder, JVCFG, 8)
    vae = (jax.tree.map(jnp.asarray, vtree), from_jax_params(vtree, "cpu"))
    h, w = size
    x = _inputs(B=1)
    txt = np.random.default_rng(9).standard_normal((1, 6, CFG.text_embed_dim)).astype(
        np.float32)
    rng = jax.random.key(4)
    z0 = np.array(jax.random.normal(rng, (1, 2, h // 8, w // 8, 12), jnp.float32))
    kw = dict(num_frames=7, height=h, width=w)
    j, p = _pipelines(jp, tp, None)
    np.testing.assert_array_equal(p.sigmas, j.sigmas)
    np.testing.assert_array_equal(p.sigmas[:-1], linear_quadratic_schedule(3, 0.025, 1))
    if size == (16, 16):  # JAX fed the prompt's valid tokens and the port's negative prompt
        keep = x["mask"][0].astype(bool)
        want = np.asarray(j(jnp.asarray(txt[:, keep]), rng=rng,
                            neg_txt=jnp.zeros(txt.shape, jnp.float32),
                            neg_mask=jnp.ones(txt.shape[:2], jnp.int32), **kw))
        got = p(torch.from_numpy(txt), text_mask=torch.from_numpy(x["mask"]),
                z0=torch.from_numpy(z0), **kw)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
        # guidance moves the trajectory
        j1, p1 = _pipelines(jp, tp, None, guidance_scale=1.0)
        one = p1(torch.from_numpy(txt), z0=torch.from_numpy(z0), **kw).numpy()
        np.testing.assert_allclose(one, np.asarray(j1(jnp.asarray(txt), rng=rng, **kw)),
                                   rtol=0, atol=ATOL)
        assert np.abs(one - got.numpy()).max() > 1e-3
    j, p = _pipelines(jp, tp, vae)
    want = np.asarray(j(jnp.asarray(txt), rng=rng, **kw))
    got = p(torch.from_numpy(txt), z0=torch.from_numpy(z0), **kw).numpy()
    assert got.shape == (1, 7, h, w, 3) and 0 <= got.min() and got.max() <= 1
    assert p.tiles((1, 2, h // 8, w // 8, 12)) == (size != (16, 16))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # a generator draws the noise on the pipeline's device
    a = p(torch.from_numpy(txt), generator=torch.Generator().manual_seed(3), **kw)
    b = p(torch.from_numpy(txt), generator=torch.Generator().manual_seed(3), **kw)
    assert torch.equal(a, b)

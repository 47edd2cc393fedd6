"""The port's causal 3D VAE and tiled video decode against the JAX package on
the same numpy inputs, at ``CausalVAEConfig.tiny()`` in f32.

- the causal conv (replicate padding in time (k-1, 0) and in space, plain
  and strided), GroupNorm over (T, H, W, C/g), the nearest upsampling that
  never doubles the first frame, the mid block's frame attention: atol 1e-5.
- ``causal_vae_decode`` and ``causal_vae_encode`` (the posterior's mean):
  atol 1e-4 (convolutions summed in another order over ~20 layers).
- ``even_starts`` (equal) and ``ramp1d`` (atol 0); ``tiled_causal_decode``
  in time, in space and both, with a stand-in decoder that is linear in its
  input (exact up to f32 rounding: atol 1e-6) and with the real decoder
  (atol 1e-4).
- the loaders on released-name safetensors written by
  ``chip_smoke.causal_vae_state`` (decoder, encoder, ``quant_conv`` and
  ``post_quant_conv``): every leaf equal to JAX's loaders'.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
from mixgrpo_tpu.models import video_tiling as JT
from mixgrpo_tpu.models.hunyuan import vae3d as JV
from mixgrpo_tpu_torch.models import video_tiling as T
from mixgrpo_tpu_torch.models.hunyuan import vae3d as V
from mixgrpo_tpu_torch.utils.safetensors_io import save_file

CFG, JCFG = V.CausalVAEConfig.tiny(), JV.CausalVAEConfig.tiny()


def _tree(init, jinit, seed):
    """The port's random init as numpy (biases and GroupNorm affines redrawn
    so they reach the output), its shapes checked against JAX's init."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda t: t.numpy(), init(CFG, generator=torch.Generator().manual_seed(
        seed), device="cpu"))
    tree = jax.tree.map(lambda a: a if a.ndim > 1 else
                        (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32), tree)
    want = jax.eval_shape(lambda: jinit(jax.random.key(0), JCFG))
    assert jax.tree.structure(want) == jax.tree.structure(tree)
    assert [w.shape for w in jax.tree.leaves(want)] == [a.shape for a in jax.tree.leaves(tree)]
    return tree


@pytest.fixture(scope="module")
def dec():
    tree = _tree(V.init_causal_vae_decoder, JV.init_causal_vae_decoder, 0)
    return tree, jax.tree.map(jnp.asarray, tree), jax.tree.map(torch.from_numpy, tree)


@pytest.fixture(scope="module")
def enc():
    tree = _tree(V.init_causal_vae_encoder, JV.init_causal_vae_encoder, 1)
    return tree, jax.tree.map(jnp.asarray, tree), jax.tree.map(torch.from_numpy, tree)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _ncdhw(a):
    return torch.from_numpy(a).permute(0, 4, 1, 2, 3)


def _back(t):
    return t.permute(0, 2, 3, 4, 1).numpy()


@pytest.mark.parametrize("k, strides", [(3, (1, 1, 1)), (1, (1, 1, 1)), (3, (2, 2, 2)),
                                        (3, (1, 2, 2))])
def test_causal_conv_replicate_padding_matches_jax(k, strides):
    rng = np.random.default_rng(k)
    p = {"w": rng.standard_normal((k, k, k, 3, 5)).astype(np.float32),
         "b": rng.standard_normal((5,)).astype(np.float32)}
    x = _x(2, 5, 7, 6, 3, seed=k)
    want = np.asarray(JV._causal_conv3d(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                                        strides=strides))
    got = _back(V._causal_conv3d(jax.tree.map(torch.from_numpy, p), _ncdhw(x), strides=strides))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if k == 3 and strides == (1, 1, 1):
        # causal: frame t sees frames <= t only
        x2 = x.copy()
        x2[:, 3:] += 1.0
        got2 = _back(V._causal_conv3d(jax.tree.map(torch.from_numpy, p), _ncdhw(x2)))
        np.testing.assert_array_equal(got2[:, :3], got[:, :3])


def test_group_norm_upsample_and_frame_attention_match_jax(dec):
    _, jp, tp = dec
    x = _x(2, 3, 4, 5, 16, seed=1) * 3 + 1
    p = {"scale": _x(16, seed=2), "bias": _x(16, seed=3)}
    want = np.asarray(JV._group_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x), 4))
    got = _back(V._group_norm(jax.tree.map(torch.from_numpy, p), _ncdhw(x), 4))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for ft, fs, t in ((2, 2, 3), (2, 1, 3), (1, 2, 3), (2, 2, 1)):
        xx = x[:, :t]
        want = np.asarray(JV._upsample(jnp.asarray(xx), ft, fs))
        got = _back(V._upsample(_ncdhw(xx), ft, fs))
        assert got.shape == want.shape == (2, 1 + (t - 1) * ft if ft > 1 and t > 1 else t,
                                           4 * fs, 5 * fs, 16)
        np.testing.assert_array_equal(got, want)
    want = np.asarray(JV._frame_attn(jp["mid_attn"], jnp.asarray(x), 4, jnp.float32))
    got = _back(V._frame_attn(tp["mid_attn"], _ncdhw(x), 4))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_decode_and_encode_match_jax(dec, enc):
    _, jd, td = dec
    lat = _x(1, 3, 4, 5, CFG.latent_channels, seed=4)
    want = np.asarray(jax.jit(lambda p, z: JV.causal_vae_decode(p, JCFG, z, dtype=jnp.float32))(
        jd, jnp.asarray(lat)))
    got = V.causal_vae_decode(td, CFG, torch.from_numpy(lat), dtype=torch.float32).numpy()
    assert got.shape == (1, 9, 32, 40, 3) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    _, je, te = enc
    vid = np.tanh(_x(1, 5, 16, 24, 3, seed=5))
    want = np.asarray(jax.jit(lambda p, v: JV.causal_vae_encode(
        p, JCFG, v, sample=False, dtype=jnp.float32))(je, jnp.asarray(vid)))
    got = V.causal_vae_encode(te, CFG, torch.from_numpy(vid), sample=False,
                              dtype=torch.float32).numpy()
    assert got.shape == (1, 2, 2, 3, CFG.latent_channels)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    drawn = V.causal_vae_encode(te, CFG, torch.from_numpy(vid),
                                generator=torch.Generator().manual_seed(0), dtype=torch.float32)
    assert drawn.shape == got.shape and not np.allclose(drawn.numpy(), got)
    with pytest.raises(ValueError, match="generator"):
        V.causal_vae_encode(te, CFG, torch.from_numpy(vid))


def test_even_starts_and_ramps_match_jax():
    for size, tile, stride, lo in ((24, 32, 24, 0), (42, 32, 24, 0), (100, 32, 24, 0),
                                   (33, 16, 12, 1), (17, 16, 12, 1), (70, 16, 12, 1)):
        assert T.even_starts(size, tile, stride, lo) == JT.even_starts(size, tile, stride, lo)
    for n, blend, first, last in ((10, 3, True, False), (10, 3, False, True),
                                  (10, 3, False, False), (4, 6, False, False), (5, 2, True, True)):
        np.testing.assert_array_equal(T.ramp1d(n, blend, first, last).numpy(),
                                      np.asarray(JT.ramp1d(n, blend, first, last)))


def _linear_decode(lib, rt, rs):
    """A stand-in causal decoder, linear in its input: frame 0 from latent 0,
    frames 1 + rt*(k-1) .. rt*k from latent k, each pixel its latent's first
    three channels (times a fixed per-channel gain)."""
    gain = np.array([1.0, -2.0, 0.5], np.float32)

    def decode(z):
        first, rest = z[:, :1, ..., :3], z[:, 1:, ..., :3]
        if lib is torch:
            up = lambda a, f: a.repeat_interleave(f, dim=1)
            sp = lambda a: a.repeat_interleave(rs, dim=2).repeat_interleave(rs, dim=3)
            return sp(torch.cat([first, up(rest, rt)], dim=1)) * torch.from_numpy(gain)
        up = lambda a, f: jnp.repeat(a, f, axis=1)
        sp = lambda a: jnp.repeat(jnp.repeat(a, rs, axis=2), rs, axis=3)
        return sp(jnp.concatenate([first, up(rest, rt)], axis=1)) * gain
    return decode


@pytest.mark.parametrize("T_, h, w", [(12, 5, 5), (4, 9, 11), (11, 9, 7)],
                         ids=["temporal", "spatial", "both"])
def test_tiled_decode_matches_jax(T_, h, w):
    lat = _x(2, T_, h, w, 4, seed=6)
    kw = dict(rt=4, rs=2, tile_latent=4, tile_latent_t=4, overlap_factor=0.25)
    want = np.asarray(JT.tiled_causal_decode(_linear_decode(jnp, 4, 2), jnp.asarray(lat), **kw))
    got = T.tiled_causal_decode(_linear_decode(torch, 4, 2), torch.from_numpy(lat), **kw)
    assert got.shape == (2, 1 + (T_ - 1) * 4, 2 * h, 2 * w, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # the stand-in is per-latent: seams blend equal pieces back to the whole
    np.testing.assert_allclose(got.numpy(), _linear_decode(torch, 4, 2)(
        torch.from_numpy(lat)).numpy(), rtol=0, atol=1e-5)


def test_tiled_real_decode_matches_jax(dec):
    _, jd, td = dec
    lat = _x(1, 7, 6, 5, CFG.latent_channels, seed=7)
    kw = dict(tile_latent=4, tile_latent_t=4, overlap_factor=0.25)
    want = np.asarray(jax.jit(lambda p, z: JV.causal_vae_decode_tiled(
        p, JCFG, z, dtype=jnp.float32, **kw))(jd, jnp.asarray(lat)))
    got = V.causal_vae_decode_tiled(td, CFG, torch.from_numpy(lat), dtype=torch.float32,
                                    **kw).numpy()
    assert got.shape == (1, 25, 48, 40, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_loaders_match_jax(dec, enc, tmp_path):
    d_np, _, td = dec
    _, _, te = enc
    rng = np.random.default_rng(8)
    pq = {"w": torch.from_numpy(rng.standard_normal((1, 1, 1, 4, 4)).astype(np.float32)),
          "b": torch.from_numpy(rng.standard_normal((4,)).astype(np.float32))}
    path = str(tmp_path / "vae.safetensors")
    save_file(CS.causal_vae_state(dict(td, post_quant_conv=pq), te), path)
    for load, jload in ((V.load_causal_vae_decoder, JV.load_causal_vae_decoder),
                        (V.load_causal_vae_encoder, JV.load_causal_vae_encoder)):
        want = jload(path, JCFG)
        got = load(path, CFG, device="cpu")
        assert jax.tree.structure(want) == jax.tree.structure(got)
        for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got = V.load_causal_vae_decoder(path, CFG, device="cpu")
    np.testing.assert_array_equal(got["post_quant_conv"]["w"].numpy(), pq["w"].numpy())
    np.testing.assert_array_equal(got["up_blocks"][1]["upsample"]["w"].numpy(),
                                  d_np["up_blocks"][1]["upsample"]["w"])
    only_dec = str(tmp_path / "dec.safetensors")
    save_file(CS.causal_vae_state(td), only_dec)
    with pytest.raises(KeyError):
        V.load_causal_vae_encoder(only_dec, CFG, device="cpu")

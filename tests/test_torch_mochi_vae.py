"""The port's Mochi causal VAE decoder against the JAX package on the same
numpy inputs, at ``MochiVAEConfig.tiny()`` in f32.

- the causal conv (the first frame replicated k - 1 times in front, zero
  padding in space) and the per-frame GroupNorm (statistics over each
  frame's (H, W, C/g), eps 1e-5): atol 1e-5; ``_depth_to_spacetime``
  (channels split as (te, se_h, se_w, C), the first te - 1 frames dropped):
  equal.
- ``mochi_vae_decode``: the shapes (T_out = 1 + (T - 1) * 6, 8x space), a
  single latent frame, and against JAX: atol 1e-4 (convolutions summed in
  another order over ~15 layers); causality: a change to the last latent
  frame leaves frame 0 as it was, in both packages.
- ``mochi_vae_decode_tiled``: one tile's worth passes through (equal to the
  whole decode); 2 x 2 spatial tiles and 3 temporal chunks against JAX's
  tiled decode: atol 1e-4.
- ``load_mochi_vae_decoder`` on diffusers-name safetensors written by
  ``chip_smoke.mochi_vae_state``: every leaf equal to JAX's loader's, and
  the decode of the loaded weights equal to the original's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
from mixgrpo_tpu.models.mochi import vae as JV
from mixgrpo_tpu_torch.models.mochi import vae as V
from mixgrpo_tpu_torch.utils.safetensors_io import save_file

CFG, JCFG = V.MochiVAEConfig.tiny(), JV.MochiVAEConfig.tiny()


@pytest.fixture(scope="module")
def dec():
    """(JAX tree, torch tree) of the tiny decoder: the port's init as numpy,
    its biases and GroupNorm affines moved off their init values."""
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda t: t.numpy(), V.init_mochi_vae_decoder(
        CFG, generator=torch.Generator().manual_seed(0), device="cpu"))
    tree = jax.tree.map(lambda a: a if a.ndim > 1 else
                        (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32), tree)
    want = jax.eval_shape(lambda: JV.init_mochi_vae_decoder(jax.random.key(0), JCFG))
    assert jax.tree.structure(want) == jax.tree.structure(tree)
    assert [w.shape for w in jax.tree.leaves(want)] == [a.shape for a in jax.tree.leaves(tree)]
    return jax.tree.map(jnp.asarray, tree), jax.tree.map(torch.from_numpy, tree)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _ncdhw(a):
    return torch.from_numpy(a).permute(0, 4, 1, 2, 3)


def _back(t):
    return t.permute(0, 2, 3, 4, 1).numpy()


_JAX_DECODE = jax.jit(lambda p, z: JV.mochi_vae_decode(p, JCFG, z, dtype=jnp.float32))


def _decode(tp, lat):
    return V.mochi_vae_decode(tp, CFG, torch.from_numpy(lat), dtype=torch.float32).numpy()


@pytest.mark.parametrize("k", [3, 1])
def test_causal_conv_group_norm_and_depth_to_spacetime_match_jax(k):
    rng = np.random.default_rng(k)
    p = {"w": rng.standard_normal((k, k, k, 3, 5)).astype(np.float32),
         "b": rng.standard_normal((5,)).astype(np.float32)}
    x = _x(2, 5, 7, 6, 3, seed=k)
    want = np.asarray(JV._causal_conv(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    got = _back(V._causal_conv(jax.tree.map(torch.from_numpy, p), _ncdhw(x)))
    assert got.shape == want.shape == (2, 5, 7, 6, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if k == 3:  # zero padding in space: a constant input's border differs from its inside
        one = np.ones((1, 1, 5, 5, 3), np.float32)
        y = _back(V._causal_conv(jax.tree.map(torch.from_numpy, p), _ncdhw(one)))
        assert not np.allclose(y[0, 0, 0, 0], y[0, 0, 2, 2])
        x2 = x.copy()
        x2[:, 3:] += 1.0  # causal: frame t sees frames <= t only
        got2 = _back(V._causal_conv(jax.tree.map(torch.from_numpy, p), _ncdhw(x2)))
        np.testing.assert_array_equal(got2[:, :3], got[:, :3])
    x = _x(2, 3, 4, 5, 16, seed=1) * 3 + 1
    x[:, 1] *= 5.0  # frames of other scales: the statistics must stay per frame
    gn = {"scale": _x(16, seed=2), "bias": _x(16, seed=3)}
    want = np.asarray(JV._frame_group_norm(jax.tree.map(jnp.asarray, gn), jnp.asarray(x), 4))
    got = _back(V._frame_group_norm(jax.tree.map(torch.from_numpy, gn), _ncdhw(x), 4))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for te, se in ((3, 2), (2, 2), (1, 2)):
        y = _x(1, 3, 2, 4, te * se * se * 5, seed=te)
        want = np.asarray(JV._depth_to_spacetime(jnp.asarray(y), te, se, 5))
        got = _back(V._depth_to_spacetime(_ncdhw(y), te, se, 5))
        assert got.shape == want.shape == (1, 3 * te - (te - 1), 2 * se, 4 * se, 5)
        np.testing.assert_array_equal(got, want)


def test_decode_matches_jax_shapes_and_causality(dec):
    jp, tp = dec
    lat = _x(1, 3, 4, 4, CFG.latent_channels, seed=4)
    want = np.asarray(_JAX_DECODE(jp, jnp.asarray(lat)))
    got = _decode(tp, lat)
    # time: 1 + (3 - 1) * 6 = 13; space: 4 * 8 = 32
    assert got.shape == (1, 13, 32, 32, 3) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    one = _decode(tp, lat[:, :1, :2, :2])
    assert one.shape == (1, 1, 16, 16, 3) and np.isfinite(one).all()
    np.testing.assert_allclose(one, np.asarray(_JAX_DECODE(jp, jnp.asarray(lat[:, :1, :2, :2]))),
                               rtol=0, atol=1e-4)
    moved = lat.copy()
    moved[:, 2] += 5.0
    got2 = _decode(tp, moved)
    np.testing.assert_allclose(got2[:, 0], got[:, 0], rtol=0, atol=1e-5)
    assert not np.allclose(got2[:, -1], got[:, -1])
    np.testing.assert_allclose(got2, np.asarray(_JAX_DECODE(jp, jnp.asarray(moved))), rtol=0,
                               atol=1e-4)


def test_tiled_decode_matches_jax(dec):
    jp, tp = dec
    lat = _x(1, 3, 6, 6, CFG.latent_channels, seed=5) * 0.5
    whole = _decode(tp, lat)
    same = V.mochi_vae_decode_tiled(tp, CFG, torch.from_numpy(lat), dtype=torch.float32).numpy()
    np.testing.assert_array_equal(same, whole)  # one tile's worth: passed through
    lat = _x(1, 6, 8, 8, CFG.latent_channels, seed=6) * 0.5
    kw = dict(tile_latent=4, tile_latent_t=2)
    want = np.asarray(jax.jit(lambda p, z: JV.mochi_vae_decode_tiled(
        p, JCFG, z, dtype=jnp.float32, **kw))(jp, jnp.asarray(lat)))
    got = V.mochi_vae_decode_tiled(tp, CFG, torch.from_numpy(lat), dtype=torch.float32,
                                   **kw).numpy()
    assert got.shape == (1, 31, 64, 64, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_loader_matches_jax(dec, tmp_path):
    jp, tp = dec
    path = str(tmp_path / "vae" / "diffusion_pytorch_model.safetensors")
    save_file(CS.mochi_vae_state(tp), path)
    want = JV.load_mochi_vae_decoder(path, JCFG)
    got = V.load_mochi_vae_decoder(path, CFG, device="cpu")
    assert jax.tree.structure(want) == jax.tree.structure(got) == jax.tree.structure(tp)
    for w, g, o in zip(jax.tree.leaves(want), jax.tree.leaves(got), jax.tree.leaves(tp)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), o.numpy())
    lat = _x(1, 2, 2, 2, CFG.latent_channels, seed=7)
    np.testing.assert_array_equal(_decode(got, lat), _decode(tp, lat))
    bf = V.load_mochi_vae_decoder(str(tmp_path / "vae"), CFG, device="cpu", dtype=torch.bfloat16)
    assert bf["up_blocks"][0]["proj"]["w"].dtype == torch.bfloat16

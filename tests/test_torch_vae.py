"""Port's FLUX VAE decoder vs the JAX package (``VAEConfig.tiny``, fp32).

JAX's decoder weights are carried over with ``convert.from_jax_params``; the
port runs NCHW ``conv2d`` inside but takes and returns NHWC like JAX.  fp32
tolerance 1e-4: convolution and GroupNorm sums run in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixgrpo_tpu.models.flux import vae as JV
from mixgrpo_tpu_torch.convert import from_jax_params
from mixgrpo_tpu_torch.models.flux import vae as V

ATOL = 1e-4


@pytest.fixture(scope="module")
def tiny_vae():
    jcfg, cfg = JV.VAEConfig.tiny(), V.VAEConfig.tiny()
    jparams = jax.jit(lambda k: JV.init_vae_decoder(k, jcfg))(jax.random.key(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, cfg, params


def _latents(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_param_tree_matches_jax(tiny_vae):
    jcfg, jparams, cfg, _ = tiny_vae
    mine = V.init_vae_decoder(cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu")
    flat = lambda tree: {jax.tree_util.keystr(p): tuple(np.shape(x)) for p, x in
                         jax.tree_util.tree_leaves_with_path(tree)}
    assert flat(jax.tree.map(lambda x: np.zeros(x.shape), mine)) == flat(jparams)


def test_vae_decode_matches_jax(tiny_vae):
    jcfg, jparams, cfg, params = tiny_vae
    z = _latents((2, 6, 4, cfg.latent_channels))
    want = JV.vae_decode(jparams, jcfg, jnp.asarray(z), dtype=jnp.float32)
    got = V.vae_decode(params, cfg, torch.from_numpy(z), dtype=torch.float32)
    assert tuple(got.shape) == (2, 48, 32, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(V.postprocess_images(got).numpy(),
                               np.asarray(JV.postprocess_images(want)), rtol=0, atol=ATOL)


def test_vae_decode_tiled_matches_jax(tiny_vae):
    """12x10 latents in 8-latent tiles: a 2x2 grid of overlapping tiles with
    ramp-blended seams."""
    jcfg, jparams, cfg, params = tiny_vae
    z = _latents((1, 12, 10, cfg.latent_channels), seed=1)
    want = JV.vae_decode_tiled(jparams, jcfg, jnp.asarray(z), dtype=jnp.float32,
                               tile_latent=8)
    got = V.vae_decode_tiled(params, cfg, torch.from_numpy(z), dtype=torch.float32,
                             tile_latent=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("size,tile,stride", [(8, 8, 6), (12, 8, 6), (128, 64, 48),
                                              (90, 64, 48)])
def test_tile_grid_matches_jax(size, tile, stride):
    assert V._tile_starts(size, tile, stride) == JV._tile_starts(size, tile, stride)
    for first in (False, True):
        for last in (False, True):
            np.testing.assert_array_equal(
                V._ramp_weight(tile * 8, tile * 2, first, last).numpy(),
                np.asarray(JV._ramp_weight(tile * 8, tile * 2, first, last)))

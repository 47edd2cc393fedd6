"""Port's FLUX model pieces vs the JAX package on the same inputs.

Layers, RoPE and latent packing are compared at fp32 atol 1e-6 (elementwise
math in the same order); ``flux_forward`` on ``FluxConfig.tiny()`` with JAX's
``init_flux`` weights carried over by ``convert.from_jax_params`` is held at
fp32 atol 2e-4 (matmul sums run in another order over 6 blocks), with and
without ``pad_seq_multiple`` and in the bshd attention layout.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixgrpo_tpu.models.flux import layers as JL
from mixgrpo_tpu.models.flux import latents as JLat
from mixgrpo_tpu.models.flux import model as JM
from mixgrpo_tpu.models.flux import rope as JR
from mixgrpo_tpu_torch.convert import from_jax_params
from mixgrpo_tpu_torch.models.flux import layers as L
from mixgrpo_tpu_torch.models.flux import latents as Lat
from mixgrpo_tpu_torch.models.flux import model as M
from mixgrpo_tpu_torch.models.flux import rope as R

ATOL = 2e-4


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def test_rope_tables_and_apply_match_jax():
    ids = np.concatenate([R.make_text_ids(4), R.make_image_ids(8, 6)])
    np.testing.assert_array_equal(ids, np.concatenate(
        [JR.make_text_ids(4), JR.make_image_ids(8, 6)]))
    jc, js = JR.rope_tables(ids, (8, 12, 12))
    c, s = R.rope_tables(ids, (8, 12, 12), device="cpu")
    np.testing.assert_allclose(c.numpy(), _np(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(s.numpy(), _np(js), rtol=0, atol=1e-6)
    x = np.random.default_rng(0).standard_normal((2, 3, ids.shape[0], 32)).astype(np.float32)
    want = JR.apply_rope(jnp.asarray(x), jc, js)
    got = R.apply_rope(_t(x), _t(jc), _t(js))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-6)


def test_pack_unpack_match_jax():
    x = np.random.default_rng(1).standard_normal((2, 12, 10, 16)).astype(np.float32)
    packed = Lat.pack_latents(_t(x))
    np.testing.assert_array_equal(packed.numpy(), _np(JLat.pack_latents(jnp.asarray(x))))
    back = Lat.unpack_latents(packed, 12 * 8, 10 * 8)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_allclose(
        Lat.denormalize_latents(_t(x)).numpy(),
        _np(JLat.denormalize_latents(jnp.asarray(x))), rtol=0, atol=1e-6)


def _layer_cases():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    vec = rng.standard_normal((2, 16)).astype(np.float32)
    lin = {"w": rng.standard_normal((16, 24)).astype(np.float32),
           "b": rng.standard_normal((24,)).astype(np.float32)}
    emb = {"in": lin, "out": {"w": rng.standard_normal((24, 24)).astype(np.float32),
                              "b": rng.standard_normal((24,)).astype(np.float32)}}
    mod = {"lin": {"w": rng.standard_normal((16, 48)).astype(np.float32),
                   "b": rng.standard_normal((48,)).astype(np.float32)}}
    scale = rng.standard_normal((16,)).astype(np.float32)
    t = np.array([0.5, 0.013], np.float32) * 1000
    f32 = jnp.float32
    return {
        "linear": (lambda m, c, dt: m.linear(c(lin), c(x), dt)),
        "layer_norm": (lambda m, c, dt: m.layer_norm(c(x))),
        "rms_norm": (lambda m, c, dt: m.rms_norm(c(x), c(scale))),
        "gelu_tanh": (lambda m, c, dt: m.gelu_tanh(c(x))),
        "timestep_embedding": (lambda m, c, dt: m.timestep_embedding(c(t), 32)),
        "mlp_embedder": (lambda m, c, dt: m.mlp_embedder(emb, c(x), dt)
                         if m is JL else m.mlp_embedder(c(emb), c(x), dt)),
        "modulation": (lambda m, c, dt: (m.modulation(c(mod), c(vec), 3, dt))[1]),
        "modulate": (lambda m, c, dt: m.modulate(c(x), c(vec), c(vec) * 0.5)),
    }, f32


@pytest.mark.parametrize("name", ["linear", "layer_norm", "rms_norm", "gelu_tanh",
                                  "timestep_embedding", "mlp_embedder",
                                  "modulation", "modulate"])
def test_layers_match_jax(name):
    cases, f32 = _layer_cases()
    fn = cases[name]
    to_j = lambda tree: jax.tree.map(jnp.asarray, tree)
    want = fn(JL, to_j, f32)
    got = fn(L, lambda tree: from_jax_params(tree, "cpu"), torch.float32)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6, atol=1e-5)


def _tiny_inputs(B, lh, lw, lt, cfg, seed=1):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((B, (lh // 2) * (lw // 2), cfg.in_channels)).astype(np.float32)
    txt = rng.standard_normal((B, lt, cfg.context_dim)).astype(np.float32)
    pooled = rng.standard_normal((B, cfg.pooled_dim)).astype(np.float32)
    t = np.full((B,), 0.5, np.float32)
    g = np.full((B,), 3.5, np.float32)
    ids = np.concatenate([JR.make_text_ids(lt), JR.make_image_ids(lh, lw)])
    return (img, txt, pooled, t, g), ids


@pytest.fixture(scope="module")
def tiny_model():
    jcfg = JM.FluxConfig.tiny()
    jparams = JM.init_flux(jax.random.key(0), jcfg)
    cfg = M.FluxConfig.tiny()
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, cfg, params


def _both_forwards(tiny_model, B, lh, lw, lt, pad):
    jcfg, jparams, cfg, params = tiny_model
    args, ids = _tiny_inputs(B, lh, lw, lt, cfg)
    jc, js = JR.rope_tables(ids, jcfg.axes_dims, jcfg.theta)
    want = JM.flux_forward(jparams, jcfg, *map(jnp.asarray, args), jc, js,
                           dtype=jnp.float32, attn_impl="xla", remat=False,
                           pad_seq_multiple=pad)
    c, s = R.rope_tables(ids, cfg.axes_dims, cfg.theta, device="cpu")
    got = M.flux_forward(params, cfg, *map(_t, args), c, s, dtype=torch.float32,
                         pad_seq_multiple=pad)
    return got, want


def test_config_and_param_tree_match_jax(tiny_model):
    jcfg, jparams, cfg, params = tiny_model
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(M.FluxConfig.flux_dev()) == dataclasses.asdict(
        JM.FluxConfig.flux_dev())
    mine = M.init_flux(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    flat = lambda tree: {jax.tree_util.keystr(p): tuple(np.shape(x)) for p, x in
                         jax.tree_util.tree_leaves_with_path(tree)}
    as_np = lambda tree: jax.tree.map(lambda x: np.zeros(x.shape), tree)
    assert flat(as_np(mine)) == flat(jparams)
    assert M.param_count(params) == JM.param_count(jparams)


def test_flux_dev_param_count():
    """FLUX.1-dev is ~11.9B params; shapes only (meta device)."""
    n = M.param_count(M.init_flux(M.FluxConfig.flux_dev(), device="meta",
                                  dtype=torch.bfloat16))
    assert 11.0e9 < n < 12.5e9, n


def test_flux_forward_matches_jax(tiny_model):
    got, want = _both_forwards(tiny_model, 2, 8, 8, 6, pad=128)
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("pad", [128, 0])
def test_pad_seq_multiple_matches_jax(tiny_model, pad):
    """S = 20 text + 15x67 image = 1025 tokens: pad=128 runs 1152 tokens with
    the static kv_valid=1025 prefix, pad=0 runs the ragged sequence; both
    agree with JAX."""
    got, want = _both_forwards(tiny_model, 1, 30, 134, 20, pad=pad)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=ATOL)


def test_bshd_layout_matches_jax(tiny_model, monkeypatch):
    monkeypatch.setenv("MIXGRPO_ATTN_LAYOUT", "bshd")
    got, want = _both_forwards(tiny_model, 2, 8, 8, 6, pad=128)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=ATOL)

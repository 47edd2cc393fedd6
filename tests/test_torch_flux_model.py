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


def _old_qk_stage(kind, sources, qscales, kscales, cos, sin, eps, H, layout):
    """The blocks' QK-norm, RoPE and joint concatenation as written before
    ``ops/qk_rope.py`` (split heads, ``rms_norm``, ``cat``, ``apply_rope``)."""
    from mixgrpo_tpu_torch.ops.qk_rope import split_heads

    split = lambda x: (split_heads(t, H, layout) for t in x.chunk(3, dim=-1))
    if kind == "single":
        q, k, v = split(sources[0])
        q, k = L.rms_norm(q, qscales[0], eps), L.rms_norm(k, kscales[0], eps)
        return R.apply_rope(q, cos, sin), R.apply_rope(k, cos, sin), v
    tq, tk, tv = split(sources[0])
    iq, ik, iv = split(sources[1])
    iq, ik = L.rms_norm(iq, qscales[1], eps), L.rms_norm(ik, kscales[1], eps)
    tq, tk = L.rms_norm(tq, qscales[0], eps), L.rms_norm(tk, kscales[0], eps)
    seq = 1 if layout == "bshd" else 2
    return (R.apply_rope(torch.cat([tq, iq], dim=seq), cos, sin),
            R.apply_rope(torch.cat([tk, ik], dim=seq), cos, sin), torch.cat([tv, iv], dim=seq))


@pytest.mark.parametrize("case", [
    *[(kind, layout, pad, torch.float32) for kind in ("double", "single")
      for layout in ("bhsd", "bshd") for pad in (False, True)],
    ("double", "bhsd", True, torch.bfloat16), ("single", "bshd", True, torch.bfloat16),
    "head_dim_24",
])
def test_qk_rope_on_cpu_is_the_eager_composition(case):
    """On CPU tensors ``ops.qk_rope.qk_rope`` is the eager composition the
    FLUX blocks ran before the kernel, bit for bit, forward and gradient (of
    the sources and of trainable scales), for the double block's two streams
    and the single block's ``linear1`` view (row stride 3h + mlp), in both
    layouts, with and without ``_pad_joint``'s pad rows (identity RoPE); and
    the kernel wrapper refuses a head dim outside 32/64/128 before it looks
    at the device (the CPU path itself takes any head dim: the tiny
    HunyuanVideo runs D = 24)."""
    from mixgrpo_tpu_torch.ops import qk_rope as QR

    if case == "head_dim_24":
        x = torch.zeros((1, 4, 3 * 2 * 24))
        tab = torch.zeros((4, 24))
        with pytest.raises(ValueError, match="head dim"):
            QR.qk_rope_fwd([x], [torch.ones(24)], [torch.ones(24)], tab, tab, 1e-6, 2)
        x, tab = torch.zeros((1, 4, 3 * 2 * 32)), torch.zeros((4, 32))
        with pytest.raises(ValueError, match="CUDA"):
            QR.qk_rope_fwd([x], [torch.ones(32)], [torch.ones(32)], tab, tab, 1e-6, 2)
        got = QR.qk_rope([torch.randn((1, 4, 3 * 2 * 24))], [torch.ones(24)], [torch.ones(24)],
                         tab[:, :24], tab[:, :24], 1e-6, 2)
        assert [tuple(t.shape) for t in got] == [(1, 2, 4, 24)] * 3
        return
    kind, layout, pad, dtype = case
    g = torch.Generator().manual_seed(5)
    B, H, D, Lt, Li, mh = 2, 3, 32, 5, 48, 40
    ids = np.concatenate([R.make_text_ids(Lt), R.make_image_ids(12, 16)])
    cos, sin = R.rope_tables(ids, (8, 12, 12), device="cpu")
    img = torch.randn((B, Li, 3 * H * D), generator=g)
    if pad:  # a multiple of 4 over 8 x 4 tokens: 53 -> 56, as flux_forward pads
        img, cos, sin, npad = M._pad_joint(img, cos, sin, Lt + Li, 4)
        assert npad == 3 and float(cos[-1].min()) == 1.0 and float(sin[-1].abs().max()) == 0.0
    if kind == "double":
        sources = [torch.randn((B, Lt, 3 * H * D), generator=g), img]
    else:  # the single block's [qkv | mlp] projection, read through a view
        S = Lt + img.shape[1]
        proj = torch.randn((B, S, 3 * H * D + mh), generator=g)
        sources = [proj[..., : 3 * H * D]]
    sources = [x.to(dtype).requires_grad_() for x in sources]
    qscales = [(1 + 0.1 * torch.randn(D, generator=g)).requires_grad_() for _ in sources]
    kscales = [(1 + 0.1 * torch.randn(D, generator=g)).requires_grad_() for _ in sources]
    if layout == "bshd":
        cos, sin = cos[:, None, :], sin[:, None, :]
    got = QR.qk_rope(sources, qscales, kscales, cos, sin, 1e-6, H, layout)
    want = _old_qk_stage(kind, sources, qscales, kscales, cos, sin, 1e-6, H, layout)
    S = sum(x.shape[1] for x in sources)
    for a, b in zip(got, want):
        assert a.dtype == dtype and tuple(a.shape) == ((B, S, H, D) if layout == "bshd"
                                                       else (B, H, S, D))
        assert torch.equal(a, b)
    leaves = [*sources, *qscales, *kscales]
    w = [torch.randn(t.shape, generator=g).to(dtype) for t in got]
    dgot = torch.autograd.grad(sum((t * c).sum() for t, c in zip(got, w)), leaves)
    dwant = torch.autograd.grad(sum((t * c).sum() for t, c in zip(want, w)), leaves)
    for a, b in zip(dgot, dwant):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rows,D,itemsize,sms,blocks", [
    (2 * 2560 * 24, 128, 2, 132, 1056),  # FLUX at 720px: 16 rows a block, capped at 8 an SM
    (2 * 2560 * 24, 128, 4, 132, 1056),
    (100, 32, 2, 132, 2),  # 64 rows a block at bf16 D = 32
    (1, 128, 4, 132, 1),
])
def test_qk_rope_grid(rows, D, itemsize, sms, blocks):
    """The kernels' grid: one row per lane group of 16-byte vectors, 256
    threads a block, at most 8 blocks a streaming multiprocessor."""
    from mixgrpo_tpu_torch.ops import qk_rope as QR

    assert QR._grid(rows, D, itemsize, sms) == blocks

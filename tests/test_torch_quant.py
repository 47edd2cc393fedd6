"""The port's int8 path (``ops/quant.py``) against the JAX package's.

- ``quantize_weight``: JAX's int8 values exactly and its scales to f32
  rounding, for stacked and 2-D weights and a column of zeros; the port's
  int8 tensor is column-major with JAX's logical shape.
- ``qlinear`` on the same int8 weights and scales and the same inputs:
  within 1e-6 in f32 (the per-token quantisation is the same f32 division
  and half-to-even rounding, the int32 sums are exact).
- ``quantize_flux_params`` on the tiny FLUX: the same quantised leaves as
  JAX's run op by op (under ``jax.jit`` XLA's compiled division by the
  scale, likely a product with its reciprocal, rounds 1 of the tiny model's
  458,752 values of ``double.img_qkv`` to the neighbouring step), every
  other leaf the input's own tensor; the quantised ``flux_forward``
  against JAX's quantised forward within the larger of the f32 forward
  parity's 2e-4 and one quantisation step (1/127) of the largest output
  element, since a sum that differs in its last bit can round an activation
  to the neighbouring step; and against the unquantised forward within JAX's
  own bounds (``tests/test_quant.py``: relative L2 < 0.05, cosine > 0.995).
- ``layers.linear`` dispatches on ``w_q``.
- ``DualFluxPipeline(quant="int8")`` quantises both trees; an unknown
  ``quant`` raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixgrpo_tpu.models.flux import model as JM
from mixgrpo_tpu.models.flux import rope as JR
from mixgrpo_tpu.ops import quant as JQ
from mixgrpo_tpu_torch.convert import from_jax_params
from mixgrpo_tpu_torch.models.flux import layers as L
from mixgrpo_tpu_torch.models.flux import model as M
from mixgrpo_tpu_torch.models.flux import rope as R
from mixgrpo_tpu_torch.ops import quant as Q


@pytest.mark.parametrize("shape", [(64, 96), (3, 64, 96), (2, 2, 40, 24)])
def test_quantize_weight_matches_jax(shape):
    w = (np.random.default_rng(0).standard_normal(shape) * 0.07).astype(np.float32)
    w[..., 5] = 0.0  # an all-zero output channel takes the scale 1/127
    jq, js = JQ.quantize_weight(jnp.asarray(w))
    q, s = Q.quantize_weight(torch.from_numpy(w))
    assert q.dtype == torch.int8 and tuple(q.shape) == shape
    assert q.transpose(-1, -2).is_contiguous()  # column-major (in, out)
    assert tuple(s.shape) == (*shape[:-2], 1, shape[-1]) and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7, atol=0)
    err = np.abs(q.numpy() * s.numpy() - w)
    assert err.max() <= np.abs(w).max() / 127 * 0.51  # half a step


@pytest.mark.parametrize("bias", [True, False])
def test_qlinear_matches_jax_on_the_same_int8_inputs(bias):
    rng = np.random.default_rng(1)
    p = {"w": (rng.standard_normal((256, 512)) * 0.05).astype(np.float32)}
    if bias:
        p["b"] = (rng.standard_normal((512,)) * 0.01).astype(np.float32)
    x = rng.standard_normal((4, 32, 256)).astype(np.float32)
    x[1, 3] = 0.0  # a token of zeros
    jp = JQ.quantize_linear_params(jax.tree.map(jnp.asarray, p))
    want = JQ.qlinear(jp, jnp.asarray(x), jnp.float32)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    assert tp["w_q"].dtype == torch.int8
    got = Q.qlinear(tp, torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    # the port's own quantisation gives the same product
    mine = Q.quantize_linear_params({k: torch.from_numpy(v) for k, v in p.items()})
    np.testing.assert_allclose(Q.qlinear(mine, torch.from_numpy(x), torch.float32).numpy(),
                               got.numpy(), rtol=0, atol=1e-6)
    assert not bias or mine["b"] is not None


def test_linear_dispatches_on_quantized_params():
    rng = np.random.default_rng(3)
    p = {"w": torch.from_numpy((rng.standard_normal((32, 48)) * 0.1).astype(np.float32))}
    x = torch.from_numpy(rng.standard_normal((2, 8, 32)).astype(np.float32))
    pq = Q.quantize_linear_params(p)
    assert sorted(pq) == ["w_q", "w_s"]
    np.testing.assert_array_equal(L.linear(pq, x, torch.float32).numpy(),
                                  Q.qlinear(pq, x, torch.float32).numpy())
    y = L.linear(p, x, torch.float32)
    assert ((L.linear(pq, x, torch.float32) - y).norm() / y.norm()).item() < 0.02


@pytest.fixture(scope="module")
def tiny():
    jcfg = JM.FluxConfig.tiny()
    jparams = JM.init_flux(jax.random.key(0), jcfg)
    jq = JQ.quantize_flux_params(jparams)  # op by op: see the module docstring
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, jq, M.FluxConfig.tiny(), params


def test_quantize_flux_params_matches_jax(tiny):
    jcfg, _, jq, cfg, params = tiny
    q = Q.quantize_flux_params(params)
    for stack, keys in (("double", Q.DOUBLE_QUANT_KEYS), ("single", Q.SINGLE_QUANT_KEYS)):
        assert keys == getattr(JQ, f"{stack.upper()}_QUANT_KEYS")
        for k in keys:
            np.testing.assert_array_equal(q[stack][k]["w_q"].numpy(),
                                          np.asarray(jq[stack][k]["w_q"]))
            np.testing.assert_allclose(q[stack][k]["w_s"].numpy(), np.asarray(jq[stack][k]["w_s"]),
                                       rtol=1e-7, atol=0)
            assert q[stack][k]["b"] is params[stack][k]["b"] and "w" not in q[stack][k]
        for k in params[stack]:
            if k not in keys:
                assert q[stack][k] is params[stack][k]
    assert q["double"]["img_qkv"]["w_s"].shape == (jcfg.depth_double, 1, 3 * jcfg.hidden_size)
    for k in params:
        if k not in ("double", "single"):
            assert q[k] is params[k]  # embedders and the final layer stay the same tensors


def test_quantized_flux_forward_matches_jax(tiny):
    jcfg, jparams, jq, cfg, params = tiny
    rng = np.random.default_rng(1)
    lh = lw = 8
    B, lt = 2, 6
    img = rng.standard_normal((B, (lh // 2) * (lw // 2), cfg.in_channels)).astype(np.float32)
    txt = rng.standard_normal((B, lt, cfg.context_dim)).astype(np.float32)
    pooled = rng.standard_normal((B, cfg.pooled_dim)).astype(np.float32)
    t, g = np.full((B,), 0.5, np.float32), np.full((B,), 3.5, np.float32)
    ids = np.concatenate([JR.make_text_ids(lt), JR.make_image_ids(lh, lw)])
    jc, js = JR.rope_tables(ids, jcfg.axes_dims, jcfg.theta)
    jargs = (jcfg, *map(jnp.asarray, (img, txt, pooled, t, g)), jc, js)
    want = np.asarray(JM.flux_forward(jq, *jargs, dtype=jnp.float32, attn_impl="xla",
                                      remat=False))
    c, s = R.rope_tables(ids, cfg.axes_dims, cfg.theta, device="cpu")
    targs = (cfg, *map(torch.from_numpy, (img, txt, pooled, t, g)), c, s)
    got = M.flux_forward(Q.quantize_flux_params(params), *targs, dtype=torch.float32).numpy()
    tol = max(2e-4, np.abs(want).max() / 127)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    y = M.flux_forward(params, *targs, dtype=torch.float32).numpy()
    rel = np.linalg.norm(got - y) / np.linalg.norm(y)
    cos = np.vdot(y, got) / (np.linalg.norm(y) * np.linalg.norm(got))
    assert rel < 0.05 and cos > 0.995, (rel, cos)


def test_pipeline_quantizes_both_trees(tiny):
    from mixgrpo_tpu_torch import sample as Sa

    _, _, _, cfg, params = tiny
    tuned = {**params, "double": {**params["double"]}}
    pipe = Sa.DualFluxPipeline(cfg, params, tuned, height=32, width=32, num_steps=3,
                               mix_sampling_steps=2, text_len=8, dtype=torch.float32,
                               device="cpu", quant="int8")
    for tree in (pipe.base_params, pipe.tuned_params):
        assert tree["single"]["linear1"]["w_q"].dtype == torch.int8
        assert tree["final_mod"] is params["final_mod"]
    with pytest.raises(ValueError, match="quant"):
        Sa.DualFluxPipeline(cfg, params, height=32, width=32, num_steps=2, text_len=8,
                            dtype=torch.float32, device="cpu", quant="int4")

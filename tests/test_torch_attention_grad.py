"""Port's attention gradients vs the JAX package's Pallas backward.

The same numpy q, k, v and output gradient go through ``jax.grad`` of JAX's
``flash_attention`` (its Pallas kernels in interpret mode on the CPU, as its
own tests run them) and through the port's ``flash_attention`` under
autograd, whose ``torch.autograd.Function`` runs the plain forward-with-lse
and the plain backward on CPU tensors (the same recompute formulas the CUDA
kernels implement).  JAX is driven down both of its backward paths: the
fused kernel (default blocks, one key block) and the split dkv + dq kernels
(a small ``block_k``).  Tolerances: fp32 within 1e-5 (the sums run in
another order), bf16 within 2e-2 (bf16 rounds at other points in the two
frameworks), as in tests/test_torch_flash_attention.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixgrpo_tpu.ops import flash_attention as JFA
from mixgrpo_tpu_torch.ops import flash_attention as FA

ATOL32, ATOL16 = 1e-5, 2e-2


def _inputs(seed, B, H, S, Sk, D, layout):
    rng = np.random.default_rng(seed)
    shp = (lambda s: (B, s, H, D)) if layout == "bshd" else (lambda s: (B, H, s, D))
    q, k, v = (rng.standard_normal(shp(s)).astype(np.float32) for s in (S, Sk, Sk))
    do = rng.standard_normal(shp(S)).astype(np.float32)
    return q, k, v, do


def _jax_grads(q, k, v, do, dtype, **kw):
    def f(q, k, v):
        o = JFA.flash_attention(q, k, v, **kw)
        return jnp.sum(o.astype(jnp.float32) * do), o

    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    (_, o), g = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(*args)
    return [np.asarray(x, np.float32) for x in (o, *g)]


def _torch_grads(q, k, v, do, dtype, bwd, **kw):
    qt, kt, vt = (torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v))
    o = FA.flash_attention(qt, kt, vt, bwd=bwd, **kw)
    (o.float() * torch.from_numpy(do)).sum().backward()
    return [x.detach().float().numpy() for x in (o, qt.grad, kt.grad, vt.grad)]


CASES = [
    # (B, H, S, Sk, D, layout, extra); every Sk > 128, so a 128-key block
    # splits; both layouts, ragged S != Sk, kv_valid and a key mask
    (1, 2, 100, 177, 64, "bshd", {}),
    (2, 3, 130, 200, 32, "bhsd", {"kv_valid": 150}),
    (2, 2, 80, 150, 64, "bshd", {"mask": "random"}),
]


def _kwargs(extra, B, Sk):
    kw = dict(extra)
    if kw.get("mask") == "random":
        m = np.random.default_rng(9).random((B, Sk)) > 0.3
        m[:, 0] = True
        kw["mask"] = m
    return kw


@pytest.mark.parametrize("jax_path", ["fused", "split"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[5]}-S{c[2]}-Sk{c[3]}-{list(c[6])}")
def test_gradients_match_jax_fp32(case, jax_path):
    """fp32 dq, dk, dv (and o) against JAX's fused or split Pallas backward;
    the port's plain backward is the same for both of its kernel modes."""
    B, H, S, Sk, D, layout, extra = case
    q, k, v, do = _inputs(0, B, H, S, Sk, D, layout)
    kw = _kwargs(extra, B, Sk)
    jkw = dict(kw, layout=layout)
    if jax_path == "split":
        jkw["block_k"] = 128  # Sk > 128: several key blocks, dkv + dq kernels
    want = _jax_grads(q, k, v, do, jnp.float32, **jkw)
    tkw = dict(kw, layout=layout)
    if "mask" in tkw:
        tkw["mask"] = torch.from_numpy(tkw["mask"])
    got = _torch_grads(q, k, v, do, torch.float32, "fused" if jax_path == "fused" else "split",
                       **tkw)
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL32, err_msg=name)


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_gradients_match_jax_bf16(layout):
    """bf16 inputs, kv_valid, ragged S != Sk: within the bf16 tolerance."""
    q, k, v, do = _inputs(1, 1, 2, 70, 130, 64, layout)
    want = _jax_grads(q, k, v, do, jnp.bfloat16, layout=layout, kv_valid=100)
    got = _torch_grads(q, k, v, do, torch.bfloat16, None, layout=layout, kv_valid=100)
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL16, err_msg=name)


@pytest.mark.parametrize("layout,extra", [("bhsd", {}), ("bshd", {"kv_valid": 90}),
                                          ("bhsd", {"mask": "random"})])
def test_lse_matches_jax(layout, extra):
    """The port's lse, (B, H, S), against JAX's lane-broadcast
    (B*H, S, 128) lse[..., 0] from ``_fwd_impl``; fp32 within 1e-5."""
    B, H, S, Sk, D = 2, 3, 100, 120, 32
    q, k, v, _ = _inputs(2, B, H, S, Sk, D, layout)
    kw = _kwargs(extra, B, Sk)
    scale = 1.0 / D ** 0.5
    kbias = np.zeros((B, Sk), np.float32)
    if "mask" in kw:
        kbias = np.where(kw["mask"], 0.0, FA.NEG_INF).astype(np.float32)
    _, lse_j = JFA._fwd_impl(jnp.asarray(q * scale), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(kbias), 512, 512, layout,
                             kv_valid=kw.get("kv_valid"), has_bias="mask" in kw)
    want = np.asarray(lse_j)[..., 0].reshape(B, H, S)
    o, lse = FA.flash_attention_fwd_lse_reference(
        torch.from_numpy(q * scale), torch.from_numpy(k), torch.from_numpy(v),
        kbias=torch.from_numpy(kbias) if "mask" in kw else None,
        kv_len=kw.get("kv_valid"), layout=layout)
    assert tuple(lse.shape) == (B, H, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, rtol=0, atol=ATOL32)


def test_backward_takes_jax_default_path():
    """At its default shapes the port's backward makes the fused-or-split
    choice JAX's wrapper makes: 720px (S = 2560) fused, 1024px (S = 4608)
    split, and small sequences fused."""
    assert FA.default_bwd(2560, 2560) == "fused"
    assert FA.default_bwd(4608, 4608) == "split"
    assert FA.default_bwd(130, 200) == "fused"
    assert FA.default_bwd(8192, 8192) == "split"


def test_lse_forward_only_under_grad():
    """The sampling path (no grad) never enters the autograd function; the
    update path (grad on, an input requiring grad) does."""
    q, k, v, _ = _inputs(3, 1, 2, 40, 40, 32, "bhsd")
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    assert FA.flash_attention(qt, kt, vt).grad_fn is None
    qg = qt.clone().requires_grad_()
    assert FA.flash_attention(qg, kt, vt).grad_fn is not None
    with torch.no_grad():
        assert FA.flash_attention(qg, kt, vt).grad_fn is None


def test_bias_gets_no_gradient_and_bwd_is_checked():
    q, k, v, _ = _inputs(4, 1, 2, 40, 40, 32, "bhsd")
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    with pytest.raises(ValueError):
        FA.flash_attention(qt, kt, vt, bwd="sideways")
    mask = torch.ones((1, 40), dtype=torch.bool)
    mask[0, 30:] = False
    FA.flash_attention(qt, kt, vt, mask=mask).sum().backward()
    assert mask.grad is None and torch.isfinite(kt.grad).all()
    # keys masked out get no gradient at all
    assert (kt.grad[..., 30:, :] == 0).all() and (vt.grad[..., 30:, :] == 0).all()

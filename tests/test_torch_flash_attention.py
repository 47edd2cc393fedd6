"""Port's attention: plain flash version and eager path vs the JAX package.

The same numpy inputs go through JAX's ``_xla_attention`` / ``attention``
(and once through the Pallas kernel in interpret mode) and through
``mixgrpo_tpu_torch.ops``.  fp32 is held at atol 1e-5; bf16 at the loose
2e-2 of tests/test_flash_attention.py (bf16 rounds at other points in the two
frameworks).  The CUDA kernel itself is compared with the plain version in
tests/test_torch_cuda.py, on a card only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixgrpo_tpu.ops.attention import _xla_attention
from mixgrpo_tpu.ops.attention import attention as jax_attention
from mixgrpo_tpu_torch.ops import flash_attention as FA
from mixgrpo_tpu_torch.ops.attention import attention

ATOL32 = 1e-5


def _qkv(seed, B, H, S, Sk, D, layout="bhsd"):
    rng = np.random.default_rng(seed)
    shp = (lambda s: (B, s, H, D)) if layout == "bshd" else (lambda s: (B, H, s, D))
    return tuple(rng.standard_normal(shp(s)).astype(np.float32) for s in (S, Sk, Sk))


def _t(*xs, dtype=torch.float32):
    return tuple(torch.from_numpy(x).to(dtype) for x in xs)


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("S,Sk,D", [(64, 64, 32), (100, 77, 64), (33, 130, 128)])
def test_reference_matches_jax(layout, S, Sk, D):
    q, k, v = _qkv(0, 2, 3, S, Sk, D, layout)
    want = _xla_attention(*map(jnp.asarray, (q, k, v)), layout=layout)
    got = FA.flash_attention_reference(*_t(q, k, v), layout=layout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL32)


@pytest.mark.parametrize("mask_ndim", [2, 4])
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_key_mask_matches_jax(mask_ndim, layout):
    B, H, S, Sk, D = 2, 2, 96, 80, 32
    q, k, v = _qkv(1, B, H, S, Sk, D, layout)
    mask = np.ones((B, Sk), bool)
    mask[0, 10:20] = False
    mask[1, 50:] = False
    m4 = mask[:, None, None, :]
    want = _xla_attention(*map(jnp.asarray, (q, k, v)), mask=jnp.asarray(m4),
                          layout=layout)
    m = torch.from_numpy(mask if mask_ndim == 2 else m4)
    got = FA.flash_attention(*_t(q, k, v), mask=m, layout=layout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL32)


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("kv_valid", [37, 70, 90])
def test_kv_valid_matches_jax(layout, kv_valid):
    """kv_valid < Sk masks the key tail; kv_valid >= Sk is dropped."""
    q, k, v = _qkv(2, 1, 2, 70, 70, 64, layout)
    want = jax_attention(*map(jnp.asarray, (q, k, v)), impl="xla", layout=layout,
                         kv_valid=kv_valid)
    for impl in ("eager", "flash"):
        got = attention(*_t(q, k, v), impl=impl, layout=layout, kv_valid=kv_valid)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL32, err_msg=impl)
    if kv_valid <= 70:
        direct = FA.flash_attention(*_t(q, k, v), layout=layout, kv_valid=kv_valid)
        np.testing.assert_allclose(direct.numpy(), np.asarray(want), rtol=0, atol=ATOL32)


def test_bf16_reference_close_to_jax():
    q, k, v = _qkv(3, 1, 2, 128, 128, 64)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(_xla_attention(jq, jk, jv).astype(jnp.float32))
    got = FA.flash_attention_reference(*_t(q, k, v, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2, atol=2e-2)


def test_reference_matches_pallas_interpret():
    """One small case against the Pallas kernel itself (interpret mode on the
    CPU), at an unaligned S with kv_valid: the kernel's own masking."""
    from mixgrpo_tpu.ops.flash_attention import flash_attention as pallas_flash

    q, k, v = _qkv(4, 1, 2, 100, 100, 32)
    want = pallas_flash(*map(jnp.asarray, (q, k, v)), block_q=64, block_k=64,
                        kv_valid=83)
    got = FA.flash_attention(*_t(q, k, v), kv_valid=83)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL32)


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_eager_attention_matches_jax(layout):
    q, k, v = _qkv(5, 2, 2, 40, 40, 32, layout)
    want = jax_attention(*map(jnp.asarray, (q, k, v)), impl="xla", layout=layout)
    got = attention(*_t(q, k, v), impl="eager", layout=layout)
    auto = attention(*_t(q, k, v), layout=layout)  # CPU tensors -> eager
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL32)
    np.testing.assert_array_equal(auto.numpy(), got.numpy())


def test_dispatch_contract():
    q, k, v = _t(*_qkv(6, 1, 1, 8, 8, 32))
    m = torch.ones((1, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="mutually exclusive"):
        attention(q, k, v, mask=m, kv_valid=4)
    with pytest.raises(ValueError, match="mutually exclusive"):
        FA.flash_attention(q, k, v, mask=m, kv_valid=4)
    with pytest.raises(ValueError, match="unknown attention impl"):
        attention(q, k, v, impl="xla")
    with pytest.raises(NotImplementedError):
        attention(q, k, v, impl="ring")
    with pytest.raises(ValueError, match="key-side"):
        FA.flash_attention(q, k, v, mask=torch.ones((1, 1, 8, 8), dtype=torch.bool))
    with pytest.raises(ValueError, match="kv_valid"):
        FA.flash_attention(q, k, v, kv_valid=9)


def test_no_fallback_off_cpu():
    """A tensor that is neither on the CPU nor on a card is refused: the plain
    version runs only for CPU tensors, and the kernel path raises instead of
    giving way to it."""
    q = torch.empty((1, 2, 8, 32), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        FA.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="one CUDA device"):
        FA.flash_attn_fwd(q, q, q)


def test_kernel_strides_follow_layout():
    """The kernel reads (batch, head, seq) strides straight from the views the
    model hands it: a qkv-split bshd view needs no copy."""
    B, S, H, D = 2, 5, 3, 32
    qkv = torch.zeros((B, S, 3 * H * D))
    q = qkv[..., : H * D].reshape(B, S, H, D)
    assert FA._strides_of(q, "bshd") == (S * 3 * H * D, D, 3 * H * D)
    bhsd = q.transpose(1, 2)
    assert FA._strides_of(bhsd, "bhsd") == (S * 3 * H * D, D, 3 * H * D)



@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_tma_geometry_contiguous(layout):
    """A contiguous tensor of either layout: dims (D, S, H, B) and the byte
    strides of its S, H and B axes, in bf16."""
    B, H, S, D = 2, 3, 5, 64
    shape = (B, S, H, D) if layout == "bshd" else (B, H, S, D)
    t = torch.zeros(shape, dtype=torch.bfloat16)
    dims, strides = FA._tma_geometry(t, layout)
    assert dims == (D, S, H, B)
    if layout == "bshd":
        assert strides == (2 * H * D, 2 * D, 2 * S * H * D)
    else:
        assert strides == (2 * D, 2 * S * D, 2 * H * S * D)


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_tma_geometry_projection_view(layout):
    """q as the model makes it: a view into one packed qkv projection (and,
    in the single block, into the wider qkv+mlp one): the sequence stride is
    the packed row, no copy."""
    B, S, H, D, mlp = 2, 7, 4, 128, 3 * 4 * 128
    proj = torch.zeros((B, S, 3 * H * D + mlp), dtype=torch.bfloat16)
    row = 3 * H * D + mlp
    for i in range(3):
        t = proj[..., i * H * D:(i + 1) * H * D].reshape(B, S, H, D)
        if layout == "bhsd":
            t = t.transpose(1, 2)
        dims, strides = FA._tma_geometry(t, layout)
        assert dims == (D, S, H, B)
        assert strides == (2 * row, 2 * D, 2 * S * row)


def test_tma_geometry_size_one_axis():
    """A size-1 axis is never stepped along and torch leaves its stride free:
    it gets the stride of a packed (B, H, S, D) tensor, which TMA accepts."""
    B, H, S, D = 1, 1, 1, 32
    t = torch.zeros((B, S, H, 3 * D), dtype=torch.bfloat16)[..., :D]
    weird = t.as_strided((B, H, S, D), (7, 3, 5, 1))
    for x, layout in ((t.transpose(1, 2), "bhsd"), (t, "bshd"), (weird, "bhsd")):
        dims, strides = FA._tma_geometry(x, layout)
        assert dims == (D, 1, 1, 1)
        assert strides == (2 * D, 2 * D, 2 * D)
    # only the size-1 axes are replaced
    x = torch.zeros((1, 2, 1, 3 * D), dtype=torch.bfloat16)[..., :D]  # (B, H, S, D), S = 1
    assert FA._tma_geometry(x, "bhsd") == ((D, 1, 2, 1), (2 * D, 2 * 3 * D, 2 * 2 * D))


@pytest.mark.parametrize("case", ["offset", "row_stride", "strided_last"])
def test_tma_geometry_refuses_misaligned(case):
    """TMA's rules: a 16-byte-aligned base, byte strides that are multiples
    of 16 and a contiguous last axis; anything else raises, and the forward's
    wrapper raises before any launch."""
    D = 64
    flat = torch.zeros(2 * 3 * 8 * 2 * D + 8, dtype=torch.bfloat16)
    if case == "offset":  # base 2 bytes past an aligned address
        t = flat[1:1 + 2 * 3 * 8 * D].view(2, 3, 8, D)
    elif case == "row_stride":  # rows of D + 1 elements: 130 bytes apart
        t = flat[:2 * 3 * 8 * (D + 1)].view(2, 3, 8, D + 1)[..., :D]
    else:
        t = flat[:2 * 3 * 8 * 2 * D].view(2, 3, 8, 2 * D)[..., ::2]
    with pytest.raises(ValueError, match="TMA"):
        FA._tma_geometry(t, "bhsd")

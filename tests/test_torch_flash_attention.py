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
    with pytest.raises(ValueError, match="set_sp_context"):  # ring needs its mesh axis
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


@pytest.mark.parametrize("view", ["bhsd", "bshd", "projection"])
def test_dkv_tma_geometry(view):
    """The dkv kernel's ``geom``: seven values for each of q, k, v and do, in
    that order (the order the C side encodes its tensor maps), for
    contiguous tensors of both layouts and for projection views of a packed
    qkv (the sequence stride is the packed row); do of its own shape, with
    S != Sk."""
    B, H, S, Sk, D = 2, 3, 5, 9, 64
    if view == "projection":
        layout = "bshd"
        proj = torch.zeros((B, Sk, 3 * H * D), dtype=torch.bfloat16)
        q = torch.zeros((B, S, 3 * H * D), dtype=torch.bfloat16)[..., :H * D].reshape(B, S, H, D)
        k, v = (proj[..., i * H * D:(i + 1) * H * D].reshape(B, Sk, H, D) for i in (1, 2))
        do = torch.zeros((B, S, H, D), dtype=torch.bfloat16)
        want = [((D, S, H, B), (2 * 3 * H * D, 2 * D, 2 * S * 3 * H * D)),
                ((D, Sk, H, B), (2 * 3 * H * D, 2 * D, 2 * Sk * 3 * H * D)),
                ((D, Sk, H, B), (2 * 3 * H * D, 2 * D, 2 * Sk * 3 * H * D)),
                ((D, S, H, B), (2 * H * D, 2 * D, 2 * S * H * D))]
    else:
        layout = view
        shp = (lambda s: (B, s, H, D)) if view == "bshd" else (lambda s: (B, H, s, D))
        q, k, v, do = (torch.zeros(shp(s), dtype=torch.bfloat16) for s in (S, Sk, Sk, S))
        strides = ((lambda s: (2 * H * D, 2 * D, 2 * s * H * D)) if view == "bshd"
                   else (lambda s: (2 * D, 2 * s * D, 2 * H * s * D)))
        want = [((D, s, H, B), strides(s)) for s in (S, Sk, Sk, S)]
    geom = FA._tma_geometries(layout, q, k, v, do)
    assert len(geom) == 28
    assert geom == tuple(x for dims, st in want for x in (*dims, *st))
    for i, t in enumerate((q, k, v, do)):
        assert geom[7 * i:7 * i + 7] == tuple(x for p in FA._tma_geometry(t, layout) for x in p)


def test_dkv_tma_geometry_refuses_misaligned_do():
    """A do whose rows are not 16-byte multiples apart cannot be read by TMA:
    the dkv geometry raises (and so does the dkv wrapper, before any launch);
    q, k and v alone are fine."""
    B, H, S, D = 1, 2, 8, 64
    q, k, v = (torch.zeros((B, H, S, D), dtype=torch.bfloat16) for _ in range(3))
    do = torch.zeros((B, H, S, D + 1), dtype=torch.bfloat16)[..., :D]
    FA._tma_geometries("bhsd", q, k, v)
    with pytest.raises(ValueError, match="TMA"):
        FA._tma_geometries("bhsd", q, k, v, do)


@pytest.mark.parametrize("view", ["bhsd", "bshd", "projection"])
def test_fused_tma_geometry(view):
    """The fused kernel's ``geom``: q, k, v and do as for dkv, then the f32 dq
    accumulator the wrapper allocates (q's shape, contiguous), whose byte
    strides count 4-byte elements; 35 values.  dkv and dq take the first
    28."""
    B, H, S, Sk, D = 2, 3, 5, 9, 128
    layout = "bhsd" if view == "bhsd" else "bshd"
    shp = (lambda s: (B, s, H, D)) if layout == "bshd" else (lambda s: (B, H, s, D))
    if view == "projection":
        proj = torch.zeros((B, Sk, 3 * H * D), dtype=torch.bfloat16)
        q = torch.zeros((B, S, 3 * H * D), dtype=torch.bfloat16)[..., :H * D].reshape(shp(S))
        k, v = (proj[..., i * H * D:(i + 1) * H * D].reshape(shp(Sk)) for i in (1, 2))
        do = torch.zeros(shp(S), dtype=torch.bfloat16)
    else:
        q, k, v, do = (torch.zeros(shp(s), dtype=torch.bfloat16) for s in (S, Sk, Sk, S))
    dq32 = torch.zeros(q.shape, dtype=torch.float32)
    geom = FA._bwd_geometry("fused", layout, q, k, v, do, dq32)
    assert len(geom) == 35
    assert geom[:28] == FA._bwd_geometry("dkv", layout, q, k, v, do)
    assert geom[:28] == FA._tma_geometries(layout, q, k, v, do)
    want_dq = ((4 * H * D, 4 * D, 4 * S * H * D) if layout == "bshd"
               else (4 * D, 4 * S * D, 4 * H * S * D))
    assert geom[28:] == (D, S, H, B, *want_dq)
    assert FA._bwd_geometry("dq", layout, q, k, v, do, dq32) == geom[:28]


@pytest.mark.parametrize("operand", ["k", "do"])
def test_fused_tma_geometry_refuses_misaligned(operand):
    """A k or do whose rows are not 16-byte multiples apart cannot be read by
    TMA: the fused geometry raises (and so does the fused wrapper, before
    any launch), while aligned operands pass."""
    B, H, S, D = 1, 2, 8, 64
    t = {n: torch.zeros((B, H, S, D), dtype=torch.bfloat16) for n in ("q", "k", "v", "do")}
    dq32 = torch.zeros((B, H, S, D), dtype=torch.float32)
    FA._bwd_geometry("fused", "bhsd", t["q"], t["k"], t["v"], t["do"], dq32)
    t[operand] = torch.zeros((B, H, S, D + 1), dtype=torch.bfloat16)[..., :D]
    with pytest.raises(ValueError, match="TMA"):
        FA._bwd_geometry("fused", "bhsd", t["q"], t["k"], t["v"], t["do"], dq32)


@pytest.mark.parametrize("operand", ["k", "do"])
def test_dq_tma_geometry_refuses_misaligned(operand):
    """The dq kernel reads q, k, v and do through TMA too: a k or do whose
    rows are not 16-byte multiples apart makes its geometry raise (and so the
    dq wrapper, before any launch), while aligned operands pass."""
    B, H, S, D = 1, 2, 8, 64
    t = {n: torch.zeros((B, H, S, D), dtype=torch.bfloat16) for n in ("q", "k", "v", "do")}
    assert len(FA._bwd_geometry("dq", "bhsd", t["q"], t["k"], t["v"], t["do"])) == 28
    t[operand] = torch.zeros((B, H, S, D + 1), dtype=torch.bfloat16)[..., :D]
    with pytest.raises(ValueError, match="TMA"):
        FA._bwd_geometry("dq", "bhsd", t["q"], t["k"], t["v"], t["do"])


@pytest.mark.parametrize("S,Sk", [(1, 1), (64, 193), (65, 40), (4608, 4608)])
def test_bwd_scratch_size(S, Sk):
    """The pre-pass scratch the backward wrapper allocates: dkv and fused
    hold lse*log2(e) and delta (2 x 64 f32) per 64-row q tile; dq holds them
    for every 64-row half of its 128-row q blocks (an even tile count, so a
    block's second warpgroup has its stats even wholly past S), then one f32
    term per key padded to whole 64-key tiles, per batch row."""
    B, H = 2, 3
    tiles = -(-S // 64)
    assert FA._bwd_scratch_size("dkv", B, H, S, Sk) == B * H * tiles * 128
    assert FA._bwd_scratch_size("fused", B, H, S, Sk) == B * H * tiles * 128
    dq_tiles = tiles + tiles % 2
    assert FA._bwd_scratch_size("dq", B, H, S, Sk) == \
        B * H * dq_tiles * 128 + B * -(-Sk // 64) * 64


def test_aligned_refuses_expanded_axis():
    """A gradient expanded along a used axis (stride 0) is not what TMA reads,
    so ``_aligned`` says no and the autograd backward makes it contiguous
    before the dkv kernel; a size-1 axis keeps any stride."""
    B, H, S, D = 2, 3, 8, 32
    do = torch.zeros((1, H, S, D), dtype=torch.bfloat16)
    assert FA._aligned(do, "bhsd")
    expanded = do.expand(B, H, S, D)
    assert not FA._aligned(expanded, "bhsd")
    assert FA._aligned(expanded.contiguous(), "bhsd")
    with pytest.raises(ValueError, match="TMA"):
        FA._tma_geometry(expanded, "bhsd")

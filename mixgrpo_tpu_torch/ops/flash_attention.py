"""Flash attention for the MMDiT joint sequence: the CUDA kernels' wrappers,
their plain PyTorch versions, and the autograd function that joins them.

Port of mixgrpo_tpu/ops/flash_attention.py, all four of its ``pallas_call``
sites:
  - ``flash_attn_fwd``: the forward without logsumexp (JAX ``_flash`` ->
    ``_fwd_kernel``), the sampling path's forward;
  - ``flash_attn_fwd_lse``: the same kernel writing lse too (JAX
    ``_flash_fwd``), the forward of the PPO update;
  - ``flash_attn_bwd_fused`` (JAX ``_fused_bwd_kernel``), and
    ``flash_attn_bwd_dkv`` + ``flash_attn_bwd_dq`` (JAX ``_dkv_kernel`` and
    ``_dq_kernel``): the backward.
The kernels are ``csrc/flash_attn_fwd.cu`` and ``csrc/flash_attn_bwd.cu``
(CUDA C++ for sm_90a, loaded with ctypes); their source notes give the
designs and the bounds.  Each wrapper counts its launches in ``.launches``.

Contract (as in the JAX package):
  - layouts ``"bhsd"`` (B, H, S, D) and ``"bshd"`` (B, S, H, D); every
    kernel reads its operands through TMA tensor maps over (D, S, H, B) with
    the tensors' byte strides (``_tma_geometries``; the fused kernel also adds
    its dq through one) and writes its outputs through element strides, so
    neither layout is transposed or padded;
  - the 1/sqrt(D) softmax scale is folded into q in q's dtype before the
    kernels, which apply none; the backward's dq is taken with respect to the
    scaled q, and autograd of ``_scaled_q``'s multiply restores the scale;
  - ``mask``: None, a (B, Sk) or a (B, 1, 1, Sk) boolean (True = attend),
    entering as an additive 0 / -1e30 f32 key bias, which gets no gradient;
  - ``kv_valid``: only the first ``kv_valid`` keys are valid (the prefix mask
    of sequence padding); mutually exclusive with ``mask``;
  - lse is f32 (B, H, S) (JAX keeps it lane-broadcast as (B*H, S, 128)).

Dispatch is by the device the tensors lie on: CPU tensors go through the
plain versions (forward and backward); CUDA tensors launch the kernels or
raise.  There is no fallback from a kernel to its plain version.  The forward
writes lse only when a gradient will be taken (grad mode on and q, k or v
requiring grad), as JAX runs ``_flash_fwd`` only under differentiation.
"""

from __future__ import annotations

import ctypes

import torch

from mixgrpo_tpu_torch.ops import build

NEG_INF = -1e30
KERNEL = "flash_attn_fwd"  # the forward's library (both variants)
BWD_KERNEL = "flash_attn_bwd"  # the backward's library (fused, dkv, dq)
SUPPORTED_HEAD_DIMS = (32, 64, 128)
_BWD_MODES = {"dkv": 0, "fused": 1, "dq": 2}
_ENCODE_ERROR = 10000  # a kernel returns this + the CUresult of a failed map encode
_STAT_ROWS = 64  # q rows per tile of the backward's lse/delta scratch
_DQ_BLOCK_Q, _DQ_BLOCK_K = 128, 64  # dq's q rows per block and keys per ring stage


def _shape_of(x, layout):
    """(B, H, S, D) logical dims of ``x`` under ``layout``."""
    if layout == "bshd":
        B, S, H, D = x.shape
        return B, H, S, D
    B, H, S, D = x.shape
    return B, H, S, D


def _strides_of(x, layout):
    """Element strides of the (batch, head, sequence) axes under ``layout``."""
    if layout == "bshd":
        return x.stride(0), x.stride(2), x.stride(1)
    return x.stride(0), x.stride(1), x.stride(2)


def _key_bias(mask, B, Sk):
    """(B, Sk) or (B, 1, 1, Sk) boolean -> (B, Sk) f32 additive bias."""
    m = torch.as_tensor(mask)
    if m.ndim == 4:
        if m.shape[1] != 1 or m.shape[2] != 1:
            raise ValueError(f"only key-side masks are supported, got {tuple(m.shape)}")
        m = m[:, 0, 0, :]
    if tuple(m.shape) != (B, Sk):
        raise ValueError(f"mask shape {tuple(m.shape)} != {(B, Sk)}")
    zero = torch.zeros((), dtype=torch.float32, device=m.device)
    return torch.where(m.bool(), zero, torch.full_like(zero, NEG_INF)).contiguous()


def _scaled_q(q):
    """q * 1/sqrt(D), the scale rounded to q's dtype first (as JAX does)."""
    scale = torch.tensor(1.0 / (q.shape[-1] ** 0.5), dtype=q.dtype).item()
    return q * scale


def _check(q, k, v, mask, kv_valid, layout):
    if layout not in ("bhsd", "bshd"):
        raise ValueError(f"unknown layout {layout!r}")
    B, H, S, D = _shape_of(q, layout)
    Bk, Hk, Sk, Dk = _shape_of(k, layout)
    if (Bk, Hk, Dk) != (B, H, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         f"do not agree under layout {layout!r}")
    if kv_valid is not None:
        if mask is not None:
            raise ValueError("mask and kv_valid are mutually exclusive")
        kv_valid = int(kv_valid)
        if not 0 < kv_valid <= Sk:
            raise ValueError(f"kv_valid={kv_valid} outside (0, {Sk}]")
    return B, H, S, D, Sk, kv_valid


def _einsums(layout):
    """(q.k^T, p.v, p^T.x) einsum specs under ``layout``."""
    if layout == "bshd":
        return "bqhd,bkhd->bhqk", "bhqk,bkhd->bqhd", "bhqk,bqhd->bkhd"
    return "bhqd,bhkd->bhqk", "bhqk,bhkd->bhqd", "bhqk,bhqd->bhkd"


def _scores(qs, k, kbias, layout):
    """f32 scores of the pre-scaled q, plus the key bias: (B, H, S, Sk)."""
    s = torch.einsum(_einsums(layout)[0], qs.float(), k.float())
    if kbias is not None:
        s = s + kbias.to(s.device)[:, None, None, :]
    return s


def _rows(x, layout):
    """A (B, S, H) per-row statistic of a bshd tensor as (B, H, S)."""
    return x.transpose(1, 2) if layout == "bshd" else x


# ----------------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------------


def flash_attention_fwd_lse_reference(qs, k, v, kbias=None, kv_len=None, layout="bhsd"):
    """Plain PyTorch version of the forward kernel, on the kernel's inputs
    (pre-scaled q, f32 key bias, prefix length).  Returns (o, lse).

    Scores in f32, the -1e30 bias and prefix masking, p = exp(s - max) in
    f32 cast to v's dtype before P.V (f32 accumulation), l = max(sum p,
    1e-30), o = acc / l in q's dtype and lse = max + log(l) in f32."""
    B, H, S, D, Sk, _ = _check(qs, k, v, None, None, layout)
    kv_len = Sk if kv_len is None else int(kv_len)
    s = _scores(qs, k, kbias, layout)
    if kv_len < Sk:
        col = torch.arange(Sk, device=s.device)
        s = torch.where(col < kv_len, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1).clamp_min(1e-30)  # (B, H, S)
    o = torch.einsum(_einsums(layout)[1], p.to(v.dtype).float(), v.float())
    lse = m[..., 0] + torch.log(l)
    return (o / _rows(l, layout)[..., None]).to(qs.dtype), lse


def flash_attention_reference(q, k, v, mask=None, kv_valid=None, layout="bhsd"):
    """Plain PyTorch version of ``flash_attention``'s forward, in eager ops,
    on the caller's inputs (q not yet scaled, a boolean mask)."""
    B, H, S, D, Sk, kv_valid = _check(q, k, v, mask, kv_valid, layout)
    kbias = None if mask is None else _key_bias(mask, B, Sk)
    return flash_attention_fwd_lse_reference(_scaled_q(q), k, v, kbias=kbias,
                                             kv_len=kv_valid, layout=layout)[0]


def flash_attention_bwd_reference(qs, k, v, o, lse, do, kbias=None, kv_len=None,
                                  layout="bhsd"):
    """Plain PyTorch version of the backward kernels (fused and split compute
    the same function).  Returns (dq, dk, dv) in q's dtype; dq is the
    gradient of the pre-scaled q.

    The recompute formulas step by step, with the kernels' casts:
    p = exp(s + bias - lse), 0 past kv_len; dv = p^T.do with p in the input
    dtype; dp = do.v^T; delta = rowsum(o * do) in f32; ds = p (dp - delta);
    dk = ds^T.q and dq = ds.k with ds in the input dtype; all sums in f32."""
    B, H, S, D, Sk, _ = _check(qs, k, v, None, None, layout)
    kv_len = Sk if kv_len is None else int(kv_len)
    qk, pv, ptx = _einsums(layout)
    dt = qs.dtype
    p = torch.exp(_scores(qs, k, kbias, layout) - lse[..., None])
    if kv_len < Sk:
        col = torch.arange(Sk, device=p.device)
        p = torch.where(col < kv_len, p, torch.zeros_like(p))
    dv = torch.einsum(ptx, p.to(dt).float(), do.float())
    dp = torch.einsum(qk, do.float(), v.float())
    delta = _rows((o.float() * do.float()).sum(dim=-1), layout)
    ds = p * (dp - delta[..., None])
    dk = torch.einsum(ptx, ds.to(dt).float(), qs.float())
    dq = torch.einsum(pv, ds.to(dt).float(), k.float())
    return dq.to(dt), dk.to(dt), dv.to(dt)


# ----------------------------------------------------------------------------
# the public function and its gradient
# ----------------------------------------------------------------------------


def default_bwd(S, Sk):
    """The backward JAX's wrapper takes at its default blocks (block_q 512,
    ``_auto_block_k``, the 6 MiB gate of ``_flash_bwd``): ``"fused"`` when one
    key block covers every key and its f32 (512, Skp) score tile fits 6 MiB,
    else ``"split"``.  The 720px update (S = 2560) runs fused, the 1024px one
    (S = 4608) split."""
    bq_eff = min(512, S)
    block_k = Sk if bq_eff * Sk * 4 <= 10 * 2**20 else 1024
    bq = -(-min(512, S) // 16) * 16
    bk = -(-min(block_k, Sk) // 128) * 128
    Skp = -(-Sk // bk) * bk
    return "fused" if Skp == bk and bq * Skp * 4 <= 6 * 2**20 else "split"


class _FlashAttention(torch.autograd.Function):
    """o = attention(qs, k, v) with the saved-lse recompute backward.  CPU
    tensors run the plain versions, CUDA tensors the kernels."""

    @staticmethod
    def forward(ctx, qs, k, v, kbias, kv_len, layout, bwd):
        if qs.device.type == "cpu":
            o, lse = flash_attention_fwd_lse_reference(qs, k, v, kbias, kv_len, layout)
        else:
            o, lse = flash_attn_fwd_lse(qs, k, v, kbias=kbias, kv_len=kv_len,
                                        layout=layout)
        ctx.save_for_backward(qs, k, v, o, lse, kbias)
        ctx.kv_len, ctx.layout, ctx.bwd = kv_len, layout, bwd
        return o

    @staticmethod
    def backward(ctx, do):
        qs, k, v, o, lse, kbias = ctx.saved_tensors
        args = (qs, k, v, o, lse, do)
        kw = dict(kbias=kbias, kv_len=ctx.kv_len, layout=ctx.layout)
        if qs.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_reference(*args, **kw)
        else:
            if not _aligned(do, ctx.layout):
                do = do.contiguous()  # e.g. an expanded gradient
                args = (qs, k, v, o, lse, do)
            if ctx.bwd == "fused":
                dq, dk, dv = flash_attn_bwd_fused(*args, **kw)
            else:
                dk, dv = flash_attn_bwd_dkv(*args, **kw)
                dq = flash_attn_bwd_dq(*args, **kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, mask=None, layout="bhsd", kv_valid=None, bwd=None):
    """Flash attention over (B, H, S, D), or (B, S, H, D) with
    ``layout="bshd"``.  CPU tensors run the plain versions; CUDA tensors
    launch the kernels (bf16, D in 32/64/128) or raise.

    Under differentiation the forward also writes lse and the backward runs
    ``bwd``: ``"fused"`` (one pass, dq summed by TMA reduce-adds) or
    ``"split"`` (dkv then dq); None takes JAX's choice at its default blocks
    (``default_bwd``)."""
    B, H, S, D, Sk, kv_valid = _check(q, k, v, mask, kv_valid, layout)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on CPU or CUDA tensors, not {q.device}")
    if bwd not in (None, "fused", "split"):
        raise ValueError(f"bwd must be 'fused', 'split' or None, got {bwd!r}")
    kbias = None if mask is None else _key_bias(mask, B, Sk).to(q.device)
    kv_len = Sk if kv_valid is None else kv_valid
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(_scaled_q(q), k, v, kbias, kv_len, layout,
                                     bwd or default_bwd(S, Sk))
    if q.device.type == "cpu":
        return flash_attention_fwd_lse_reference(_scaled_q(q), k, v, kbias=kbias,
                                                 kv_len=kv_len, layout=layout)[0]
    return flash_attn_fwd(_scaled_q(q), k, v, kbias=kbias, kv_len=kv_len, layout=layout)


# ----------------------------------------------------------------------------
# kernel wrappers
# ----------------------------------------------------------------------------


def _aligned(t, layout):
    """What the kernels read through strides or TMA: a contiguous last axis,
    the other used strides positive (no expanded axis) and, like the
    pointer, 16-byte aligned."""
    B, H, S, _ = _shape_of(t, layout)
    used = [st for n, st in zip((B, H, S), _strides_of(t, layout)) if n > 1]
    # a stride of an axis of size 1 is never used, and torch leaves it free
    return (t.stride(-1) == 1 and all(st > 0 and st % 8 == 0 for st in used)
            and t.data_ptr() % 16 == 0)


def _tma_geometry(t, layout):
    """A kernel's TMA view of ``t``: its dims (D, S, H, B),
    innermost first, and the byte strides of the S, H and B axes.

    TMA needs a 16-byte-aligned base, a contiguous last axis and strides that
    are multiples of 16 bytes.  A size-1 axis is never stepped along, and
    torch leaves its stride free, so it gets the stride a contiguous (B, H,
    S, D) tensor would have.  Raises ValueError on anything else."""
    B, H, S, D = _shape_of(t, layout)
    dims = (D, S, H, B)
    item = t.element_size()
    packed, strides = D * item, []
    for n, st in zip((S, H, B), _strides_of(t, layout)[::-1]):
        strides.append(st * item if n > 1 else packed)
        packed *= n
    if t.stride(-1) != 1 or t.data_ptr() % 16 or any(st % 16 or st <= 0 for st in strides):
        raise ValueError(f"TMA needs a contiguous last axis, a 16-byte-aligned base and "
                         f"16-byte-multiple strides; got strides {t.stride()} at "
                         f"offset {t.data_ptr() % 16} mod 16")
    return dims, tuple(strides)


def _tma_geometries(layout, *tensors):
    """The TMA views of ``tensors`` as one flat tuple, seven int64 values for
    each tensor in the order given (``_tma_geometry``'s dims, then its
    strides): what a kernel's ``geom`` argument reads.  Raises ValueError
    for a tensor TMA cannot read."""
    return tuple(x for t in tensors for part in _tma_geometry(t, layout) for x in part)


def _bwd_geometry(mode, layout, q, k, v, do, dq=None):
    """The ``geom`` argument of a backward mode: the TMA views of q, k, v
    and do for ``"dkv"`` and ``"dq"`` (28 values), and of the f32 dq
    accumulator after them for ``"fused"`` (35).  Raises ValueError for a
    tensor TMA cannot read."""
    return _tma_geometries(layout, q, k, v, do, *((dq,) if mode == "fused" else ()))


def _bwd_scratch_size(mode, B, H, S, Sk):
    """f32 values of a backward mode's pre-pass scratch: lse*log2(e) and
    delta for each 64-row q tile of every (batch, head), (B*H, n, 2, 64),
    where dq's n covers whole 128-row blocks; then, for dq only, one term per
    key padded to whole 64-key tiles, (B, ceil(Sk/64)*64) (log2(e) * bias,
    0, or -inf past kv_len)."""
    if mode == "dq":
        n = -(-S // _DQ_BLOCK_Q) * (_DQ_BLOCK_Q // _STAT_ROWS)
        terms = B * -(-Sk // _DQ_BLOCK_K) * _DQ_BLOCK_K
    else:
        n, terms = -(-S // _STAT_ROWS), 0
    return B * H * n * 2 * _STAT_ROWS + terms


def _check_kernel_inputs(name, layout, kbias, kv_len, **tensors):
    """Raise on anything the kernels do not take: non-CUDA tensors or tensors
    on two devices, another dtype than bf16, a head dim outside 32/64/128,
    misaligned strides, a malformed key bias or lse."""
    q, k, v = tensors["q"], tensors["k"], tensors["v"]
    B, H, S, D, Sk, _ = _check(q, k, v, None, None, layout)
    kv_len = Sk if kv_len is None else int(kv_len)
    extra = [t for t in (kbias, tensors.get("lse")) if t is not None]
    if any(t.device.type != "cuda" or t.device != q.device
           for t in (*tensors.values(), *extra)):
        raise ValueError(f"{name} needs every tensor on one CUDA device")
    for n, t in tensors.items():
        if n != "lse" and t.dtype != torch.bfloat16:
            raise TypeError(f"{name} takes bf16 tensors, got {n}: {t.dtype}")
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{name} takes head dim {SUPPORTED_HEAD_DIMS}, got {D}")
    if not 0 < kv_len <= Sk:
        raise ValueError(f"kv_len={kv_len} outside (0, {Sk}]")
    for n, t in tensors.items():
        if n == "lse":
            if t.dtype != torch.float32 or tuple(t.shape) != (B, H, S) \
                    or not t.is_contiguous():
                raise ValueError(f"{name}: lse must be a contiguous (B, H, S) float32 tensor")
            continue
        rows = S if n in ("q", "o", "do") else Sk
        if tuple(t.shape) != tuple((q if rows == S else k).shape):
            raise ValueError(f"{name}: {n} has shape {tuple(t.shape)}")
        if not _aligned(t, layout):
            raise ValueError(f"{name}: {n}'s last axis must be contiguous and the other "
                             f"strides 16-byte aligned, got strides {t.stride()}")
    if kbias is not None:
        if kbias.dtype != torch.float32 or tuple(kbias.shape) != (B, Sk) \
                or not kbias.is_contiguous():
            raise ValueError("kbias must be a contiguous (B, Sk) float32 tensor")
    return B, H, S, D, Sk, kv_len


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_fwd(name, q, k, v, kbias, kv_len, layout, with_lse):
    B, H, S, D, Sk, kv_len = _check_kernel_inputs(name, layout, kbias, kv_len,
                                                  q=q, k=k, v=v)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) if with_lse else None
    geom = _tma_geometries(layout, q, k, v)
    lib = _library(KERNEL)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _ptr(lse), _ptr(kbias),
            (ctypes.c_int64 * 21)(*geom), *_strides_of(o, layout),
            B, H, S, Sk, D, kv_len, stream)
    _raise_on(name, err)
    return o, lse


def _raise_on(name, err):
    if err >= _ENCODE_ERROR:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled failed: CUresult "
                           f"{err - _ENCODE_ERROR}")
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def flash_attn_fwd(q, k, v, kbias=None, kv_len=None, layout="bhsd"):
    """Launch the forward kernel without lse on pre-scaled q; returns o in
    q's layout.  Raises on anything the kernel does not take."""
    o, _ = _launch_fwd("flash_attn_fwd", q, k, v, kbias, kv_len, layout, False)
    flash_attn_fwd.launches += 1
    return o


def flash_attn_fwd_lse(q, k, v, kbias=None, kv_len=None, layout="bhsd"):
    """Launch the forward kernel with lse on pre-scaled q; returns (o, lse),
    lse f32 (B, H, S)."""
    out = _launch_fwd("flash_attn_fwd_lse", q, k, v, kbias, kv_len, layout, True)
    flash_attn_fwd_lse.launches += 1
    return out


def _launch_bwd(name, mode, q, k, v, o, lse, do, kbias, kv_len, layout, dq):
    B, H, S, D, Sk, kv_len = _check_kernel_inputs(
        name, layout, kbias, kv_len, q=q, k=k, v=v, o=o, do=do, lse=lse)
    dk = dv = None
    if mode != "dq":
        dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
        dv = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    outs = [t if t is not None else q for t in (dq, dk, dv)]  # unused strides: any
    strides = (ctypes.c_int64 * 15)(*(st for t in (o, do, *outs)
                                      for st in _strides_of(t, layout)))
    geom = _bwd_geometry(mode, layout, q, k, v, do, dq)
    geom = (ctypes.c_int64 * len(geom))(*geom)
    scratch = torch.empty(_bwd_scratch_size(mode, B, H, S, Sk), dtype=torch.float32,
                          device=q.device)
    lib = _library(BWD_KERNEL)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attn_bwd(
            _BWD_MODES[mode], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), _ptr(kbias), _ptr(dq), _ptr(dk), _ptr(dv),
            strides, geom, _ptr(scratch), B, H, S, Sk, D, kv_len, stream)
    _raise_on(name, err)
    return dk, dv


def flash_attn_bwd_fused(q, k, v, o, lse, do, kbias=None, kv_len=None, layout="bhsd"):
    """Launch the fused backward (the kernel's lse/delta pre-pass, then the
    kernel, in one C call): (dq, dk, dv) in q's dtype, dq with respect to the
    pre-scaled q.  Every key block adds its dq partial into a zeroed f32
    buffer of q's shape by TMA reduce-adds; the buffer is then cast."""
    dq32 = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = _launch_bwd("flash_attn_bwd_fused", "fused", q, k, v, o, lse, do, kbias,
                         kv_len, layout, dq32)
    flash_attn_bwd_fused.launches += 1
    return dq32.to(q.dtype), dk, dv


def flash_attn_bwd_dkv(q, k, v, o, lse, do, kbias=None, kv_len=None, layout="bhsd"):
    """Launch the dk/dv backward (the kernel's lse/delta pre-pass, then the
    kernel, in one C call; their f32 scratch comes from ``torch.empty``):
    (dk, dv) in k's layout and dtype."""
    out = _launch_bwd("flash_attn_bwd_dkv", "dkv", q, k, v, o, lse, do, kbias, kv_len,
                      layout, None)
    flash_attn_bwd_dkv.launches += 1
    return out


def flash_attn_bwd_dq(q, k, v, o, lse, do, kbias=None, kv_len=None, layout="bhsd"):
    """Launch the dq backward (the kernel's lse/delta and key-term pre-pass,
    then the kernel, in one C call; their f32 scratch comes from
    ``torch.empty``): dq (of the pre-scaled q) in q's layout and dtype."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd("flash_attn_bwd_dq", "dq", q, k, v, o, lse, do, kbias, kv_len, layout, dq)
    flash_attn_bwd_dq.launches += 1
    return dq


# every kernel wrapper, by the name its launches are reported under
KERNEL_WRAPPERS = {f.__name__: f for f in (flash_attn_fwd, flash_attn_fwd_lse,
                                           flash_attn_bwd_fused, flash_attn_bwd_dkv,
                                           flash_attn_bwd_dq)}
for _f in KERNEL_WRAPPERS.values():
    _f.launches = 0


def reset_launches():
    for f in KERNEL_WRAPPERS.values():
        f.launches = 0


def _library(name):
    lib = build.load(name)
    if name == KERNEL:
        fn = lib.flash_attn_fwd
        argtypes = ([ctypes.c_void_p] * 6 + [ctypes.POINTER(ctypes.c_int64)]
                    + [ctypes.c_int64] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    else:
        fn = lib.flash_attn_bwd
        argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                    + [ctypes.POINTER(ctypes.c_int64)] * 2 + [ctypes.c_void_p]
                    + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return lib

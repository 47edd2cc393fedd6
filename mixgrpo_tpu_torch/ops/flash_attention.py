"""Flash attention forward for the MMDiT joint sequence: CUDA kernel wrapper
and its plain PyTorch version.

Port of mixgrpo_tpu/ops/flash_attention.py, the forward without logsumexp
(``_flash`` -> ``_fwd_impl`` -> ``_fwd_kernel``) that the sampling path runs in
every DiT block.  The kernel is ``csrc/flash_attn_fwd.cu`` (CUDA C++ for
sm_90a, loaded with ctypes); its source note gives the design and the bound.
The logsumexp variant and the three backward kernels belong to the PPO update
and are not ported yet.

Contract (as in the JAX package):
  - layouts ``"bhsd"`` (B, H, S, D) and ``"bshd"`` (B, S, H, D); the kernel
    takes element strides, so neither layout is transposed or padded;
  - the 1/sqrt(D) softmax scale is folded into q in q's dtype before the
    kernel, which applies none;
  - ``mask``: None, a (B, Sk) or a (B, 1, 1, Sk) boolean (True = attend),
    entering as an additive 0 / -1e30 f32 key bias;
  - ``kv_valid``: only the first ``kv_valid`` keys are valid (the prefix mask
    of sequence padding); mutually exclusive with ``mask``.

Dispatch is by the device the tensors lie on: CPU tensors go through
``flash_attention_reference``; CUDA tensors launch the kernel or raise.  There
is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from mixgrpo_tpu_torch.ops import build

NEG_INF = -1e30
KERNEL = "flash_attn_fwd"
SUPPORTED_HEAD_DIMS = (32, 64, 128)


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


def flash_attention_reference(q, k, v, mask=None, kv_valid=None, layout="bhsd"):
    """Plain PyTorch version of the kernel's function, in eager ops.

    Scores in f32 from the pre-scaled q, the same -1e30 bias and prefix
    masking, p = exp(s - max) in f32 cast to v's dtype before P.V (f32
    accumulation), then o = acc / max(sum p, 1e-30) in q's dtype."""
    B, H, S, D, Sk, kv_valid = _check(q, k, v, mask, kv_valid, layout)
    qk = "bqhd,bkhd->bhqk" if layout == "bshd" else "bhqd,bhkd->bhqk"
    pv = "bhqk,bkhd->bqhd" if layout == "bshd" else "bhqk,bhkd->bhqd"
    s = torch.einsum(qk, _scaled_q(q).float(), k.float())
    if mask is not None:
        s = s + _key_bias(mask, B, Sk).to(s.device)[:, None, None, :]
    if kv_valid is not None:
        col = torch.arange(Sk, device=s.device)
        s = torch.where(col < kv_valid, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1).clamp_min(1e-30)
    o = torch.einsum(pv, p.to(v.dtype).float(), v.float())
    l = l.transpose(1, 2) if layout == "bshd" else l  # (B, S, H) for bshd
    return (o / l[..., None]).to(q.dtype)


def flash_attention(q, k, v, mask=None, layout="bhsd", kv_valid=None):
    """Flash attention forward over (B, H, S, D), or (B, S, H, D) with
    ``layout="bshd"``.  CPU tensors run the plain version; CUDA tensors launch
    ``flash_attn_fwd`` (bf16, D in 32/64/128) or raise."""
    B, H, S, D, Sk, kv_valid = _check(q, k, v, mask, kv_valid, layout)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, mask=mask, kv_valid=kv_valid,
                                         layout=layout)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CPU or CUDA tensors, not {q.device}")
    kbias = None if mask is None else _key_bias(mask, B, Sk).to(q.device)
    return flash_attn_fwd(_scaled_q(q), k, v, kbias=kbias,
                          kv_len=Sk if kv_valid is None else kv_valid,
                          layout=layout)


def flash_attn_fwd(q, k, v, kbias=None, kv_len=None, layout="bhsd"):
    """Launch the CUDA kernel on pre-scaled q; returns o in q's layout.

    Raises on anything the kernel does not take: non-CUDA tensors, another
    dtype than bf16, a head dim outside 32/64/128, a strided last axis,
    or strides and pointers that are not 16-byte aligned."""
    B, H, S, D, Sk, _ = _check(q, k, v, None, None, layout)
    kv_len = Sk if kv_len is None else int(kv_len)
    tensors = (q, k, v) if kbias is None else (q, k, v, kbias)
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError("flash_attn_fwd needs q, k, v (and kbias) on one CUDA device")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError(f"flash_attn_fwd takes bf16 q/k/v, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attn_fwd takes head dim {SUPPORTED_HEAD_DIMS}, got {D}")
    if not 0 < kv_len <= Sk:
        raise ValueError(f"kv_len={kv_len} outside (0, {Sk}]")
    for name, t, rows in (("q", q, S), ("k", k, Sk), ("v", v, Sk)):
        # a stride of an axis of size 1 is never used, and torch leaves it free
        used = [st for n, st in zip((B, H, rows), _strides_of(t, layout)) if n > 1]
        if t.stride(-1) != 1 or any(st % 8 for st in used) or t.data_ptr() % 16:
            raise ValueError(f"{name}: last axis must be contiguous and the other "
                             f"strides 16-byte aligned, got strides {t.stride()}")
    if kbias is not None:
        if kbias.dtype != torch.float32 or tuple(kbias.shape) != (B, Sk) \
                or not kbias.is_contiguous():
            raise ValueError("kbias must be a contiguous (B, Sk) float32 tensor")
    shape = (B, S, H, D) if layout == "bshd" else (B, H, S, D)
    o = torch.empty(shape, dtype=q.dtype, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if kbias is None else kbias.data_ptr(),
            *_strides_of(q, layout), *_strides_of(k, layout),
            *_strides_of(v, layout), *_strides_of(o, layout),
            B, H, S, Sk, D, kv_len, stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: CUDA error {err}")
    flash_attn_fwd.launches += 1
    return o


flash_attn_fwd.launches = 0


def _library():
    lib = build.load(KERNEL)
    fn = lib.flash_attn_fwd
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 12
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    return lib

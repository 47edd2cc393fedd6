"""Attention dispatch: eager fp32-softmax path and the CUDA flash kernel.

Port of mixgrpo_tpu/ops/attention.py.  Backends:
  - ``"eager"``: torch einsum with an fp32 softmax, the counterpart of JAX's
    ``_xla_attention`` (the reference and CPU path);
  - ``"flash"``: ``ops/flash_attention.py`` (the hand-written CUDA kernels on
    CUDA tensors, their plain versions on CPU tensors; under autograd the
    forward with logsumexp and the backward kernels);
  - ``"auto"``: flash for CUDA tensors, eager for CPU tensors.
  - ``"ulysses"``, ``"ring"``: sequence parallelism over the mesh axis that
    ``parallel.ulysses.set_sp_context`` installed (``parallel/``): q, k and v
    arrive whole on every rank of the axis, each rank attends for its slice
    of the sequence, and the slices are gathered back.  A ``kv_valid`` prefix
    becomes the equivalent key mask, and bshd goes through a transpose, as
    in JAX.
Gradients flow through every backend.  The kernel call (flash or eager)
runs inside an ``attn`` span (``utils/profiling.py``).
"""

from __future__ import annotations

import torch

from mixgrpo_tpu_torch.ops.flash_attention import flash_attention
from mixgrpo_tpu_torch.utils import profiling


def _eager_attention(q, k, v, mask=None, scale=None, layout="bhsd"):
    """q, k, v: (B, H, S, D), or (B, S, H, D) with ``layout="bshd"``.
    Returns the same layout.  fp32 scores and softmax; ``mask`` is a boolean
    broadcastable to (B, H, Sq, Sk), True = attend."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d**0.5)
    qk = "bqhd,bkhd->bhqk" if layout == "bshd" else "bhqd,bhkd->bhqk"
    pv = "bhqk,bkhd->bqhd" if layout == "bshd" else "bhqk,bhkd->bhqd"
    logits = torch.einsum(qk, q.float(), k.float()) * scale
    if mask is not None:
        fmin = torch.finfo(torch.float32).min
        logits = torch.where(torch.as_tensor(mask, device=logits.device), logits,
                             torch.full_like(logits, fmin))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum(pv, probs.to(v.dtype).float(), v.float()).to(v.dtype)


def attention(q, k, v, mask=None, impl: str = "auto", layout: str = "bhsd",
              kv_valid=None):
    """Bidirectional scaled dot-product attention over (B, H, S, D), or
    (B, S, H, D) with ``layout="bshd"``.

    ``mask``: optional boolean, True = attend (the flash path takes key-side
    masks only).  ``kv_valid``: only the first ``kv_valid`` keys are valid;
    dropped when it covers every key; mutually exclusive with ``mask``."""
    Sk = k.shape[2 if layout == "bhsd" else 1]
    if kv_valid is not None:
        if mask is not None:
            raise ValueError("mask and kv_valid are mutually exclusive")
        if int(kv_valid) >= Sk:
            kv_valid = None  # nothing masked
    if impl == "auto":
        impl = "flash" if q.device.type == "cuda" else "eager"
    if impl in ("ulysses", "ring"):
        if kv_valid is not None:  # the keys are sharded: an explicit mask instead
            mask = (torch.arange(Sk, device=q.device) < int(kv_valid))[None, None, None, :]
        if layout == "bshd":
            out = attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                            mask=mask, impl=impl)
            return out.transpose(1, 2)
        from mixgrpo_tpu_torch.parallel.ulysses import get_sp_context, sequence_parallel

        ctx = get_sp_context()
        if ctx is None:
            raise ValueError(f"attention(impl={impl!r}) needs parallel.set_sp_context")
        return sequence_parallel(q, k, v, ctx[0], ctx[1], impl, mask=mask)
    if impl == "flash":
        with profiling.span("attn"):
            return flash_attention(q, k, v, mask=mask, layout=layout, kv_valid=kv_valid)
    if impl != "eager":
        raise ValueError(f"unknown attention impl {impl!r}")
    if kv_valid is not None:
        mask = (torch.arange(Sk, device=q.device) < int(kv_valid))[None, None, None, :]
    with profiling.span("attn"):
        return _eager_attention(q, k, v, mask=mask, layout=layout)

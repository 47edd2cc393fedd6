"""Ulysses (DeepSpeed-style) sequence parallelism on all-to-alls.

Port of mixgrpo_tpu/parallel/ulysses.py.  JAX's ``ulysses_attention``
takes global arrays and ``shard_map``s its body; here it takes this rank's
sequence slice, as that body does: all-to-all the sequence-sharded q, k, v
into head-sharded full-sequence tensors, attend, all-to-all back.  The
all-to-alls' backwards are the inverse all-to-alls
(``collectives.py``).

The local attention is ``ops/attention.attention(impl=base_impl)``; the
default ``"auto"`` runs the hand-written flash kernels on a card (the
forward, and under autograd the backward kernels) at (B, H/sp, S, D), and
the plain torch path on the CPU.  A key mask is all-gathered first, so that
every head shard sees every key's bit, and takes the kernels' key-bias
path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mixgrpo_tpu_torch.parallel import collectives as C

_SP_CONTEXT: Optional[Tuple[object, str]] = None


def set_sp_context(mesh, axis: str = "sp") -> None:
    """Install the mesh and axis that ``attention(impl="ulysses"|"ring")``
    uses (None clears it)."""
    global _SP_CONTEXT
    _SP_CONTEXT = (mesh, axis) if mesh is not None else None


def get_sp_context() -> Optional[Tuple[object, str]]:
    return _SP_CONTEXT


def key_mask_rows(mask, S_local: int, name: str):
    """A key-side mask, (B, s) or (B, 1, 1, s), as (B, s) booleans."""
    m = torch.as_tensor(mask)
    if m.ndim == 4:
        if m.shape[1] != 1 or m.shape[2] != 1:
            raise ValueError(f"{name} attention supports key-side masks only, got "
                             f"{tuple(m.shape)}")
        m = m[:, 0, 0, :]
    if m.ndim != 2 or m.shape[-1] != S_local:
        raise ValueError(f"{name}: key mask {tuple(m.shape)} does not match {S_local} keys")
    return m.to(torch.bool)


def ulysses_attention(q, k, v, mesh, axis: str = "sp", base_impl: str = "auto", mask=None):
    """Attention over this rank's sequence slice: q, k, v (B, H, S/sp, D) of
    a (B, H, S, D) sequence sharded on ``axis``; returns the slice's
    (B, H, S/sp, D) output.  ``mask``: this rank's slice of a key-side
    boolean, (B, S/sp) or (B, 1, 1, S/sp), True = attend.  Query-dependent
    masks are not supported under sequence parallelism."""
    from mixgrpo_tpu_torch.ops.attention import attention

    sp = mesh.size(axis)
    H, S = q.shape[1], q.shape[2] * sp
    if H % sp:
        raise ValueError(f"heads {H} not divisible by sp={sp}")
    if S % sp:
        raise ValueError(f"seq {S} not divisible by sp={sp}")
    local_mask = None
    if mask is not None:
        m = key_mask_rows(mask, q.shape[2], "ulysses")
        local_mask = C.gather_along(m, mesh, axis, dim=1)[:, None, None, :]
    q, k, v = (C.all_to_all_heads_to_seq(t, mesh, axis) for t in (q, k, v))
    o = attention(q, k, v, mask=local_mask, impl=base_impl)
    return C.all_to_all_seq_to_heads(o, mesh, axis)


def sequence_parallel(q, k, v, mesh, axis: str, impl: str, mask=None):
    """``attention(impl="ulysses"|"ring")`` on whole (B, H, S, D) tensors
    that every rank of ``axis`` holds alike: each rank takes its S/sp slice
    (whose backward gathers the slices' gradients), attends with ``impl``,
    and the output slices are all-gathered (whose backward is this rank's
    slice), so the residual stream around attention keeps its full
    sequence, as JAX's ``constrain_residual`` layout does.  ``mask``: a
    key-side boolean over the S keys."""
    from mixgrpo_tpu_torch.parallel.ring import ring_attention

    B, S = q.shape[0], q.shape[2]
    sp = mesh.size(axis)
    if S % sp:
        raise ValueError(f"seq {S} not divisible by sp={sp}")
    m = None
    if mask is not None:
        m = key_mask_rows(mask, S, impl).to(q.device).expand(B, S)
        m = C.slice_along(m, mesh, axis, dim=1)
    ql, kl, vl = (C.split_seq(t, mesh, axis, dim=2) for t in (q, k, v))
    if impl == "ring":
        o = ring_attention(ql, kl, vl, mesh, axis, mask=m)
    else:
        o = ulysses_attention(ql, kl, vl, mesh, axis, mask=m)
    return C.all_gather_seq(o, mesh, axis, dim=2)

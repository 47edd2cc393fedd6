"""Ring attention (context parallelism): K and V rotate around the ring.

Port of mixgrpo_tpu/parallel/ring.py.  Each rank keeps its query slice,
and the key, value and key-mask slices rotate one place per step
(``collectives.ppermute_next``, JAX's ``ppermute``; its backward is the
reverse rotation) while a streaming softmax in f32 builds the exact output
for the local queries against the global key sequence.  It shards the
sequence only, so it needs no ``H % sp == 0``.  JAX computes it with XLA
einsums outside any Pallas kernel; the port computes it with torch einsums
and differentiates it with autograd.
"""

from __future__ import annotations

import torch

from mixgrpo_tpu_torch.parallel import collectives as C
from mixgrpo_tpu_torch.parallel.ulysses import key_mask_rows

_NEG = -1e30  # finite mask fill: keeps the running max well-defined


def _ring_local(q, k, v, m, mesh, axis: str, scale: float):
    sp = mesh.size(axis)
    B, H, Sq, D = q.shape
    qf = q.float() * scale
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)
    denom = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    run_max = torch.full((B, H, Sq), _NEG, dtype=torch.float32, device=q.device)
    for step in range(sp):
        s = torch.einsum("bhqd,bhkd->bhqk", qf, k.float())
        if m is not None:
            s = torch.where(m[:, None, None, :], s, torch.full_like(s, _NEG))
        new_max = torch.maximum(run_max, s.amax(dim=-1))
        corr = torch.exp(run_max - new_max)
        p = torch.exp(s - new_max[..., None])
        acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v.float())
        denom = denom * corr + p.sum(dim=-1)
        run_max = new_max
        if step != sp - 1:
            k = C.ppermute_next(k, mesh, axis)
            v = C.ppermute_next(v, mesh, axis)
            if m is not None:
                m = C.ppermute_next(m, mesh, axis)
    return (acc / denom[..., None]).to(v.dtype)


def ring_attention(q, k, v, mesh, axis: str = "sp", mask=None):
    """Exact attention for this rank's slice of a (B, H, S, D) sequence
    sharded on ``axis``: q, k, v (B, H, S/sp, D) in, (B, H, S/sp, D) out.
    ``mask``: this rank's slice of a key-side boolean, (B, S/sp) or
    (B, 1, 1, S/sp), True = attend."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    m = None if mask is None else key_mask_rows(mask, k.shape[2], "ring").to(q.device)
    return _ring_local(q, k, v, m, mesh, axis, scale)

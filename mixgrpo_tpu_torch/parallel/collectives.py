"""Collectives over one mesh axis, each with the gradient JAX's AD gives.

Port of mixgrpo_tpu/parallel/collectives.py.  JAX's helpers are
``jax.lax`` primitives inside ``shard_map``; here each is a
``torch.autograd.Function`` over the process group of ``mesh``'s ``axis``,
called on this rank's tensor.  Every function is the identity on an axis of
size 1.

Gradients follow one convention: a value that every rank of the axis holds
alike (replicated) carries on each rank the whole gradient of the one loss
those ranks compute together, and a sharded value carries its own part.
Hence:
  - ``all_to_all_*``: the backward is the inverse all-to-all;
  - ``all_gather_seq`` (sharded in, replicated out): the backward is this
    rank's own slice of the gradient, not a sum over ranks (a sum would give
    ``size`` times the gradient);
  - ``split_seq`` (replicated in, sharded out; JAX's ``shard_map`` in_specs
    slicing): the backward all-gathers the slices' gradients;
  - ``psum``: the identity; ``pmean``: the gradient over ``size``;
  - ``broadcast_from``: the gradient goes to rank ``src`` alone;
  - ``ppermute`` (``ring.py``'s rotation): the backward is the reverse
    rotation.

Transport.  NCCL moves CUDA tensors directly.  Under ``gloo`` a CUDA tensor
goes directly where gloo has a CUDA form of the operation
(``GLOO_CUDA_DIRECT``, as ``python -m mixgrpo_tpu_torch.parallel.probe``
found on an H100: every collective here but send/recv) and is staged
through a host copy otherwise.  The choice is this fixed table, keyed on the
backend and the tensor's device; ``TRANSPORT`` counts each operation's
direct and staged calls.
"""

from __future__ import annotations

import collections
from typing import List

import torch
import torch.distributed as dist

GLOO_CUDA_DIRECT = frozenset({"all_reduce", "broadcast", "all_gather", "reduce_scatter",
                              "all_to_all"})
TRANSPORT = {"direct": collections.Counter(), "staged": collections.Counter()}


def reset_transport() -> None:
    for c in TRANSPORT.values():
        c.clear()


def transport_record() -> dict:
    return {k: dict(v) for k, v in TRANSPORT.items()}


def _staged(op: str, mesh, t: torch.Tensor) -> bool:
    staged = mesh.backend == "gloo" and t.is_cuda and op not in GLOO_CUDA_DIRECT
    TRANSPORT["staged" if staged else "direct"][op] += 1
    return staged


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes (its last dimension times its item size):
    the operations that only move data carry any dtype (bf16, bool) so."""
    return t.contiguous().view(torch.uint8)


# ----------------------------------------------------------------------------
# raw collectives on one group (no autograd)
# ----------------------------------------------------------------------------


def all_reduce_(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """In-place sum over ``axis``'s group."""
    if mesh.size(axis) > 1:
        _staged("all_reduce", mesh, t)
        dist.all_reduce(t, group=mesh.groups[axis])
    return t


def broadcast_(t: torch.Tensor, mesh, axis: str, src: int = 0) -> torch.Tensor:
    """In place: every rank of the group takes the value of its ``src``-th."""
    if mesh.size(axis) > 1:
        _staged("broadcast", mesh, t)
        dist.broadcast(t, mesh.ranks[axis][src], group=mesh.groups[axis])
    return t


def gather_along(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` in axis order."""
    n = mesh.size(axis)
    if n == 1:
        return x
    w = _bytes(x)
    _staged("all_gather", mesh, w)
    parts = [torch.empty_like(w) for _ in range(n)]
    dist.all_gather(parts, w, group=mesh.groups[axis])
    return torch.cat(parts, dim=dim % x.ndim).view(x.dtype)


def reduce_scatter_along(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Sum over the group, then this rank's slice along ``dim``."""
    n = mesh.size(axis)
    if n == 1:
        return x
    parts = [p.contiguous() for p in x.chunk(n, dim=dim)]
    out = torch.empty_like(parts[0])
    _staged("reduce_scatter", mesh, out)
    dist.reduce_scatter(out, parts, group=mesh.groups[axis])
    return out


def slice_along(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    n = mesh.size(axis)
    if n == 1:
        return x
    return x.chunk(n, dim=dim)[mesh.index(axis)]


def all_to_all_along(x: torch.Tensor, mesh, axis: str, split_dim: int,
                     concat_dim: int) -> torch.Tensor:
    """JAX's tiled ``all_to_all``: chunk j of ``split_dim`` goes to the j-th
    rank of the group, and the chunks received are concatenated along
    ``concat_dim`` in axis order."""
    n = mesh.size(axis)
    if n == 1:
        return x
    send = _bytes(torch.stack(x.chunk(n, dim=split_dim)))
    recv = torch.empty_like(send)
    _staged("all_to_all", mesh, send)
    dist.all_to_all_single(recv, send, group=mesh.groups[axis])
    return torch.cat(recv.view(x.dtype).unbind(0), dim=concat_dim)


def shift_along(x: torch.Tensor, mesh, axis: str, offset: int) -> torch.Tensor:
    """The value of the rank ``offset`` places earlier along ``axis`` (each
    rank sends its ``x`` to the one ``offset`` places later), JAX's
    ``ppermute`` with ``perm = [(i, (i + offset) % n)]``."""
    n = mesh.size(axis)
    if n == 1:
        return x
    ranks, i = mesh.ranks[axis], mesh.index(axis)
    w = _bytes(x)
    staged = _staged("send_recv", mesh, w)
    if staged:
        w = w.cpu()
    recv = torch.empty_like(w)
    ops = [dist.P2POp(dist.isend, w, ranks[(i + offset) % n], group=mesh.groups[axis]),
           dist.P2POp(dist.irecv, recv, ranks[(i - offset) % n], group=mesh.groups[axis])]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if staged:
        recv = recv.to(x.device)
    return recv.view(x.dtype)


# ----------------------------------------------------------------------------
# differentiable collectives (JAX's helpers)
# ----------------------------------------------------------------------------


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, split_dim, concat_dim)
        return all_to_all_along(x, mesh, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_dim, concat_dim = ctx.args
        return all_to_all_along(g, mesh, axis, concat_dim, split_dim), None, None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return gather_along(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.args
        return slice_along(g, mesh, axis, dim).contiguous(), None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return slice_along(x, mesh, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.args
        return gather_along(g.contiguous(), mesh, axis, dim), None, None, None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, mean):
        ctx.scale = 1.0 / mesh.size(axis) if mean else 1.0
        y = all_reduce_(x.clone(), mesh, axis)
        return y * ctx.scale if mean else y

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None, None, None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, src):
        ctx.mine = mesh.size(axis) == 1 or mesh.index(axis) == src
        return broadcast_(x.clone(), mesh, axis, src)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.mine else torch.zeros_like(g)), None, None, None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, offset):
        ctx.args = (mesh, axis, offset)
        return shift_along(x, mesh, axis, offset)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, offset = ctx.args
        return shift_along(g, mesh, axis, -offset), None, None, None


def all_to_all_heads_to_seq(x, mesh, axis: str = "sp"):
    """(B, H, S/sp, D) -> (B, H/sp, S, D): scatter heads, gather sequence."""
    return _AllToAll.apply(x, mesh, axis, 1, 2)


def all_to_all_seq_to_heads(x, mesh, axis: str = "sp"):
    """(B, H/sp, S, D) -> (B, H, S/sp, D): the inverse resharding."""
    return _AllToAll.apply(x, mesh, axis, 2, 1)


def all_gather_seq(x, mesh, axis: str = "sp", dim: int = 1):
    """Gather a sequence-sharded tensor along ``dim`` (replicated result);
    the backward is this rank's slice."""
    return _AllGather.apply(x, mesh, axis, dim)


def split_seq(x, mesh, axis: str = "sp", dim: int = 1):
    """This rank's slice along ``dim`` of a replicated tensor; the backward
    all-gathers the slices' gradients."""
    return _Split.apply(x, mesh, axis, dim)


def psum(x, mesh, axis: str):
    return _PSum.apply(x, mesh, axis, False)


def pmean(x, mesh, axis: str):
    return _PSum.apply(x, mesh, axis, True)


def broadcast_from(x, mesh, axis: str, src: int = 0):
    """Every rank of the axis takes rank ``src``'s value."""
    return _Broadcast.apply(x, mesh, axis, src)


def ppermute_next(x, mesh, axis: str = "sp"):
    """Rotate one place along the ring: rank i receives rank i - 1's value
    (JAX's ``ppermute`` with ``perm = [(i, (i + 1) % n)]``)."""
    return _Shift.apply(x, mesh, axis, 1)


def gather_objects(obj, mesh, axis: str = "batch") -> List:
    """Every rank's ``obj`` (any picklable value) along ``axis``, in axis
    order; host-side metrics and reward rows."""
    n = mesh.size(axis)
    if n == 1:
        return [obj]
    out = [None] * n
    dist.all_gather_object(out, obj, group=mesh.groups[axis])
    return out

"""FSDP weight sharding of FLUX by JAX's rule table, and batch placement.

Port of mixgrpo_tpu/parallel/sharding.py.  JAX annotates each leaf with a
``PartitionSpec`` and lets XLA insert the all-gathers and reduce-scatters;
here each rank keeps its own slice of every leaf (``shard_params``) and the
forward gathers explicitly.  The rule table is JAX's ``_FLUX_RULES``, with
the same path strings and the same "drop a shard that does not divide"
rule; a spec is a tuple with one entry per leaf dimension (an axis name or
None, trailing Nones dropped, as JAX's canonical specs).

The FSDP forward (``fsdp_view``): the block stacks stay sharded and
``flux_forward``'s ``block_params`` hook gathers each block's leaves inside
the (recomputed) block body, through an autograd function whose backward
reduce-scatters the gradient over ``fsdp``.  So under ``remat`` a block is
gathered again in the backward, as ZeRO-3 does, and a rank holds at most one
or two gathered blocks.  The leaves outside the stacks follow their rules
(``final_mod``'s weight is the one sharded; the embedders and ``proj_out``
are replicated).

``reduce_grads`` averages the gradients over the batch ranks (dp x fsdp),
so that the loss is the mean over the update group's global rows, as in
JAX; the ranks of one ``sp`` group hold the same rows and the same
gradients, and are not averaged.

Tensor parallelism (``tp > 1``) is not carried out: the table holds the
``tp`` dimensions, and ``shard_params`` slices them, but no block splits its
heads or MLPs yet, and the trainer refuses such a mesh (ROADMAP item 8b).

``set_activation_mesh``/``get_activation_mesh`` record the trainer's mesh as
JAX's do.  ``constrain_attn`` and ``constrain_residual`` keep JAX's names and
return their input: the port's activations are each rank's own tensors, and
the residual stream keeps its full sequence on every ``sp`` rank (only
attention splits it, in ``ops/attention.py``).  ``put_global_batch`` and
``get_local_batch`` are the identity on a rank's local rows.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from mixgrpo_tpu_torch.parallel import collectives as C
from mixgrpo_tpu_torch.parallel.mesh import AXES, Mesh, MeshConfig

# path regex -> spec of the leaf's last dims (a leading stacked depth axis
# gets None): JAX's _FLUX_RULES
_FLUX_RULES = [
    (r"(img_qkv|txt_qkv|linear1|img_mlp_in|txt_mlp_in)/w$", ("fsdp", "tp")),
    (r"(img_qkv|txt_qkv|linear1|img_mlp_in|txt_mlp_in)/b$", ("tp",)),
    (r"(img_attn_out|txt_attn_out|linear2|img_mlp_out|txt_mlp_out)/w$", ("tp", "fsdp")),
    (r"(img_attn_out|txt_attn_out|linear2|img_mlp_out|txt_mlp_out)/b$", ()),
    (r"(img_mod|txt_mod|mod|final_mod)/lin/w$", ("fsdp", None)),
    (r"(img_mod|txt_mod|mod|final_mod)/lin/b$", ()),
    (r"(x_embedder|context_embedder|proj_out)/w$", ()),
    (r"(time_in|vector_in|guidance_in)/(in|out)/w$", ()),
    (r".*", ()),
]
STACKS = ("double", "single")


def _mesh_shape(mesh) -> Dict[str, int]:
    if isinstance(mesh, Mesh):
        return mesh.shape
    if isinstance(mesh, MeshConfig):
        return dataclasses.asdict(mesh)
    return {a: int(mesh.get(a, 1)) for a in AXES}


def spec_for(path: str, shape: Sequence[int], mesh) -> tuple:
    """The spec of the leaf at ``path`` (e.g. ``"double/img_qkv/w"``) of
    ``shape`` on ``mesh`` (a ``Mesh``, a resolved ``MeshConfig`` or a dict
    of axis sizes)."""
    sizes = _mesh_shape(mesh)
    ndim = len(shape)
    for pat, spec in _FLUX_RULES:
        if re.search(pat, path):
            parts = [None] * max(ndim - len(spec), 0) + list(spec)
            parts = parts[:ndim]
            out = [ax if ax is not None and sizes.get(ax, 1) > 1
                   and dim % sizes[ax] == 0 else None
                   for dim, ax in zip(shape, parts)]
            while out and out[-1] is None:
                out.pop()
            return tuple(out)
    return ()


def leaf_paths(tree, prefix: str = "") -> List[str]:
    """The path of every tensor of ``tree``, in ``param_leaves`` order
    (dict keys sorted)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in leaf_paths(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


def _map(fn, tree, path: str = ""):
    if isinstance(tree, dict):
        return {k: _map(fn, v, f"{path}{k}/") for k, v in tree.items()}
    return fn(path[:-1], tree)


def flux_param_specs(params: Any, mesh) -> Any:
    """The tree of specs matching ``params`` (full-size leaves, or anything
    with a ``shape``)."""
    return _map(lambda p, v: spec_for(p, tuple(v.shape), mesh), params)


def flatten_specs(specs: Any) -> List[tuple]:
    """A tree of specs as a list in ``param_leaves`` order (dict keys
    sorted)."""
    out = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        else:
            out.append(t)

    walk(specs)
    return out


def _dim(spec: tuple, axis: str) -> Optional[int]:
    return spec.index(axis) if axis in spec else None


def shard_leaf(t: torch.Tensor, mesh: Mesh, spec: tuple) -> torch.Tensor:
    """This rank's slice of a full leaf: one contiguous chunk along each
    sharded dimension."""
    for d, ax in enumerate(spec):
        if ax is not None:
            t = C.slice_along(t, mesh, ax, d)
    return t


def shard_params(params: Any, mesh: Mesh, specs: Any = None) -> Any:
    """Every leaf of a full parameter tree cut to this rank's slice (a new
    tensor, so the full tree can be freed); replicated leaves are kept as
    they are."""
    specs = specs if specs is not None else flux_param_specs(params, mesh)

    def cut(path, t):
        s = _lookup(specs, path)
        return shard_leaf(t, mesh, s).detach().clone() if any(s) else t

    return _map(cut, params)


def _lookup(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def gather_leaf(t: torch.Tensor, mesh: Mesh, spec: tuple, dtype=None) -> torch.Tensor:
    """The full leaf from every rank's slice (no autograd), cast to ``dtype``
    first when given."""
    if dtype is not None:
        t = t.to(dtype)
    for d, ax in enumerate(spec):
        if ax is not None:
            t = C.gather_along(t, mesh, ax, d)
    return t


@torch.no_grad()
def gather_params(params: Any, mesh: Mesh, specs: Any, dtype=None) -> Any:
    """The full tree (ZeRO-3's "summon full params"), leaves of more than
    one dimension cast to ``dtype`` when given (the rollout's copy: every
    use casts to the compute dtype anyway)."""
    return _map(lambda p, t: gather_leaf(t, mesh, _lookup(specs, p),
                                         dtype if t.ndim > 1 else None), params)


class _GatherShard(torch.autograd.Function):
    """All-gather a leaf's fsdp slices; the backward reduce-scatters the
    gradient (each rank's loss used the whole leaf)."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.args = (mesh, dim)
        return C.gather_along(x, mesh, "fsdp", dim)

    @staticmethod
    def backward(ctx, g):
        mesh, dim = ctx.args
        return C.reduce_scatter_along(g.contiguous(), mesh, "fsdp", dim), None, None


def gather_shard(t: torch.Tensor, mesh: Mesh, spec: tuple) -> torch.Tensor:
    d = _dim(spec, "fsdp")
    return t if d is None or mesh.size("fsdp") == 1 else _GatherShard.apply(t, mesh, d)


def fsdp_view(params: Any, mesh: Mesh, specs: Any):
    """``(forward_params, block_params)`` for ``flux_forward`` on this
    rank's shards: the leaves outside the block stacks gathered (under
    autograd), the stacks left sharded, and the hook that gathers one block's
    leaves where the block runs."""
    out = {k: (v if k in STACKS else
               _map(lambda p, t, k=k: gather_shard(t, mesh, _lookup(specs[k], p)), v))
           for k, v in params.items()}

    def block_params(stack, i, p):
        # a block's leaf drops the stack's leading depth dimension
        return _map(lambda path, t: gather_shard(t, mesh, _lookup(specs[stack], path)[1:]), p)

    return out, block_params


def reduce_grads(grads: Sequence[torch.Tensor], specs: Sequence[tuple],
                 mesh: Mesh) -> List[torch.Tensor]:
    """The mean over the batch ranks (dp x fsdp) of each rank's gradients:
    an fsdp-sharded leaf's gradient, already summed over ``fsdp`` by its
    gather's backward, is summed over ``dp``; a replicated leaf's over both.
    Leaves of one kind travel in one flat buffer."""
    n = mesh.batch_size
    if n == 1:
        return list(grads)
    out = list(grads)
    for axis, pick in (("dp", lambda s: "fsdp" in s), ("batch", lambda s: "fsdp" not in s)):
        idx = [i for i, s in enumerate(specs) if pick(s)]
        if not idx or mesh.size(axis) == 1:
            for i in idx:
                out[i] = out[i] / n
            continue
        flat = torch.cat([out[i].reshape(-1).float() for i in idx])
        C.all_reduce_(flat, mesh, axis)
        flat /= n
        off = 0
        for i in idx:
            k = out[i].numel()
            out[i] = flat[off:off + k].view_as(out[i]).to(out[i].dtype)
            off += k
    return out


def shard_opt_state(opt_state: Any, mesh: Mesh) -> Any:
    """The optimizer of a sharded tree needs no placing: ``torch.optim``
    makes each moment at its parameter's (local) shape at the first step.
    Kept for JAX's call sites."""
    return opt_state


# ---------------------------------------------------------------------------
# batch placement and activation specs
# ---------------------------------------------------------------------------


def batch_axes_for(mesh, dim: int, axes=("dp", "fsdp")) -> tuple:
    """The (dp, fsdp) axes that shard a global batch dim of size ``dim``."""
    sizes = _mesh_shape(mesh)
    use = tuple(a for a in axes if sizes.get(a, 1) > 1)
    total = int(np.prod([sizes[a] for a in use])) if use else 1
    return use if use and dim % total == 0 else ()


def data_spec(mesh, ndim: int, batch_axes=("dp", "fsdp")) -> tuple:
    """Batch sharded over dp and fsdp, the rest replicated (one axis by its
    name, as JAX's ``PartitionSpec`` writes it)."""
    sizes = _mesh_shape(mesh)
    axes = tuple(a for a in batch_axes if sizes.get(a, 1) > 1)
    lead = axes[0] if len(axes) == 1 else (axes or None)
    return (lead,) + (None,) * (ndim - 1)


def replicated_spec(mesh) -> tuple:
    return ()


def put_global_batch(mesh: Mesh, x, dtype=None) -> torch.Tensor:
    """This rank's rows as a tensor on its device: the port's arrays are
    each rank's own, so the local batch is the rank's share as it is."""
    t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    return t.to(mesh.device, dtype) if dtype is not None else t.to(mesh.device)


def get_local_batch(mesh: Mesh, x) -> np.ndarray:
    """This rank's rows as numpy."""
    return x.detach().float().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


_ACT_MESH = [None]


def set_activation_mesh(mesh) -> None:
    """Record the mesh the trainer runs on (``get_activation_mesh``); the
    port's activations need no constraint from it."""
    _ACT_MESH[0] = mesh


def get_activation_mesh():
    return _ACT_MESH[0]


def constrain_attn(x, layout: str = "bhsd"):
    return x


def constrain_residual(x):
    return x

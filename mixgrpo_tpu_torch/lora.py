"""LoRA adapters for the FLUX MMDiT (and any parameter tree of tensors).

Port of mixgrpo_tpu/lora.py.  An adapter is a parallel tree of low-rank
factors over selected weight leaves:

    w_eff = w + (a @ b * (alpha / rank)).to(w.dtype)

Factors are keyed by the leaf's path as JAX writes it (``"double/img_qkv/w"``)
and kept in f32.  Stacked block weights (depth, in, out) get per-depth
factors a (depth, in, r) ~ N(0, 1/in) and b (depth, r, out) = 0, so the
block stacks keep their leading depth axis.  The base stays frozen (it can
live in bf16) and only the factors train.

Two ways to merge, with the same numbers:
  - ``apply_lora`` builds the effective tree (JAX's ``apply_lora``), one
    depth slice at a time so no full-stack f32 delta is ever held; the
    trainer's rollout runs on it under ``torch.no_grad``;
  - ``lora_blocks`` merges the leaves outside the block stacks at once and
    gives ``flux_forward`` a per-block merge that it calls inside each
    (checkpointed) block body: only that block's merged weights exist, and
    the backward gathers no gradient of a full-size weight stack.  The
    update differentiates through it.

Over a sharded base (``parallel/sharding.py``: the fsdp slices gathered
where the blocks use them, each block on its tp slice) the factors stay
whole on every rank and ``shard_factors`` cuts each one to the tp slice of
the leaf it adds to: a column-parallel leaf's delta a @ b is cut by b's
columns, a row-parallel leaf's by a's rows, at the same part boundaries as
the leaf (``Spec.parts``), so a @ b_t is the cut of the whole delta.  Each
factor enters the tp region through ``collectives.tp_enter``, whose
backward sums the ranks' gradients, so every rank holds the whole factor
gradient.

``save_lora``/``load_lora`` write and read safetensors files through the
port's ``utils/safetensors_io.py`` (f32 factors, ``__metadata__`` {rank,
alpha}), so they interchange with JAX's ``save_lora``, which goes through
the ``safetensors`` package.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import torch

from mixgrpo_tpu_torch.utils.safetensors_io import SafetensorsFile, save_file

DEFAULT_TARGETS = r"(qkv|linear1|linear2|attn_out|mlp_in|mlp_out)/w$"


def _leaves_with_paths(tree, prefix=""):
    """(path, tensor) of every leaf, dict keys in sorted order (JAX's order),
    the path's parts joined by ``/``."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves_with_paths(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _map_with_paths(fn, tree, prefix=""):
    if isinstance(tree, dict):
        return {k: _map_with_paths(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    return fn(prefix[:-1], tree)


def init_lora(generator, params: Any, rank: int = 16, alpha: float = 16.0,
              targets: str = DEFAULT_TARGETS) -> Dict[str, Any]:
    """The adapter tree ``{"factors": {path: {"a", "b"}}, "rank", "alpha"}``
    over every leaf of two or more dims whose path matches ``targets``;
    ``a`` is drawn from ``generator`` on the leaf's device, leaf by leaf in
    path order (the values differ from JAX's ``jax.random``)."""
    factors = {}
    for path, leaf in _leaves_with_paths(params):
        if leaf.ndim < 2 or not re.search(targets, path):
            continue
        *lead, din, dout = leaf.shape
        a = torch.randn((*lead, din, rank), generator=generator, device=leaf.device,
                        dtype=torch.float32) * din ** -0.5
        b = torch.zeros((*lead, rank, dout), device=leaf.device, dtype=torch.float32)
        factors[path] = {"a": a, "b": b}
    return {"factors": factors, "rank": rank, "alpha": alpha}


def apply_lora(params: Any, lora: Dict[str, Any]) -> Any:
    """The effective parameter tree: targeted leaves merged, the others
    shared with ``params``.  Each depth slice's delta is made and added on
    its own (a full-depth stack's f32 delta would be 4x the bf16 stack)."""
    scale = lora["alpha"] / lora["rank"]
    factors = lora["factors"]

    def merge(path, leaf):
        if path not in factors:
            return leaf
        a, b = factors[path]["a"], factors[path]["b"]
        out = torch.empty_like(leaf)
        flat, fa, fb = (t.reshape(-1, *t.shape[-2:]) for t in (out, a, b))
        for i, w in enumerate(leaf.reshape(-1, *leaf.shape[-2:])):
            flat[i] = w + (fa[i] @ fb[i] * scale).to(leaf.dtype)
        return out

    return _map_with_paths(merge, params)


def merge_lora(params: Any, lora: Dict[str, Any]) -> Any:
    """Permanently fold adapters into the weights (for export)."""
    return apply_lora(params, lora)


def lora_blocks(params: Any, lora: Dict[str, Any], stacks=("double", "single")):
    """``(tree, merge_block)`` for ``flux_forward(tree, ...,
    block_params=merge_block)``: ``tree`` is ``params`` with the targeted
    leaves outside the block ``stacks`` merged (``apply_lora``), and
    ``merge_block(stack, i, p)`` returns block ``i`` of ``stack`` (its
    parameter dict ``p``) with its targeted leaves merged, slice ``i`` of
    each factor."""
    scale = lora["alpha"] / lora["rank"]
    inside = {p: f for p, f in lora["factors"].items() if p.split("/", 1)[0] in stacks}
    outside = {p: f for p, f in lora["factors"].items() if p not in inside}

    def merge_block(stack, i, p):
        def merge(path, w):
            f = inside.get(f"{stack}/{path}")
            return w if f is None else w + (f["a"][i] @ f["b"][i] * scale).to(w.dtype)
        return _map_with_paths(merge, p)

    return apply_lora(params, {**lora, "factors": outside}), merge_block


def shard_factors(factors: Dict[str, Any], specs: Any, mesh) -> Dict[str, Any]:
    """The factors as this rank's blocks use them: where the spec of a
    factor's leaf (``specs``, the tree of ``sharding.flux_param_specs``)
    cuts ``tp``, ``b``'s columns (an output dimension) or ``a``'s rows (an
    input dimension) are cut alike, under autograd; the identity off a tp
    mesh (see the module docstring)."""
    from mixgrpo_tpu_torch.parallel import collectives as C
    from mixgrpo_tpu_torch.parallel.sharding import Spec, cut_leaf

    if not C.tp_split(mesh):
        return factors
    index = {"tp": (mesh.index("tp"), mesh.size("tp"))}
    out = {}
    for path, f in factors.items():
        spec = specs
        for k in path.split("/"):
            spec = spec[k]
        if "tp" not in spec:
            out[path] = f
            continue
        a, b = C.tp_enter(f["a"], mesh), C.tp_enter(f["b"], mesh)
        d = spec.index("tp")  # the leaf's input (ndim - 2) or output (ndim - 1) dimension
        cut = Spec((None,) * d + ("tp",), spec.parts)
        out[path] = ({"a": a, "b": cut_leaf(b, cut, index)} if d == b.ndim - 1
                     else {"a": cut_leaf(a, cut, index), "b": b})
    return out


def save_lora(lora: Dict[str, Any], path: str) -> None:
    """Write the factors as ``<path>.lora_A`` / ``.lora_B`` f32 tensors in
    the safetensors layout, with metadata {rank, alpha}."""
    tensors = {}
    for ps, f in lora["factors"].items():
        tensors[f"{ps}.lora_A"] = f["a"]
        tensors[f"{ps}.lora_B"] = f["b"]
    save_file(tensors, path, metadata={"rank": lora["rank"], "alpha": lora["alpha"]},
              dtype=torch.float32)


def load_lora(path: str, device="cuda") -> Dict[str, Any]:
    """Read a file written by ``save_lora`` (this one or JAX's); the factors
    are put on ``device``."""
    st = SafetensorsFile(path)
    factors: Dict[str, Any] = {}
    for name in st.keys():
        if st.header[name]["dtype"] != "F32":
            raise ValueError(f"{path}: {name} is {st.header[name]['dtype']}, not F32")
        base, kind = name.rsplit(".", 1)
        factors.setdefault(base, {})["a" if kind == "lora_A" else "b"] = \
            st.get(name, device=device)
    return {"factors": factors, "rank": int(st.metadata.get("rank", 16)),
            "alpha": float(st.metadata.get("alpha", 16.0))}


def lora_loss_fn(base_params, lora, loss_of_params):
    """``loss_of_params`` of the merged tree; differentiate it with respect
    to the factors only (the trainer's update merges per block instead,
    ``lora_blocks``)."""
    return loss_of_params(apply_lora(base_params, lora))

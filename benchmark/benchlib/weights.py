"""Weights made from the seed on the device, in a few large calls.

The program's parameter layout (a tree of dicts and lists of tensors) is
taken from its init run on the ``meta`` device, which allocates nothing;
the values are the benchmark's own: one normal draw from a
``torch.Generator`` over one flat buffer in the served dtype, then one
affine map per leaf by a rule on the leaf's name.  Biases and norm scales
are moved off their usual zeros and ones, so that a fault that drops one
shows in the comparison.
"""

from __future__ import annotations

import math
from typing import Callable, List, Tuple

import torch


def leaves(tree, prefix: str = "") -> List[Tuple[str, object]]:
    """(path, leaf) of every leaf, dict keys in sorted order, list items by
    index, parts joined by ``/``."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _rebuild(tree, values, prefix=""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values, f"{prefix}{i}/") for i, v in enumerate(tree))
    return values[prefix[:-1]]


def default_rule(path: str, shape) -> Tuple[float, float]:
    """(mean, std) of a leaf by its name: matrices and convolution kernels
    N(0, 1/fan_in), biases and embeddings N(0, 0.02^2), norm scales
    N(1, 0.05^2), CLIP's logit scale ln(1/0.07)."""
    last = path.split("/")[-1]
    if last in ("w", "proj") or last.endswith("_w"):
        fan_in = math.prod(shape[:-1]) if len(shape) >= 4 else shape[-2]  # convs: k^d * in
        return 0.0, fan_in ** -0.5
    if last in ("b", "bias") or last.endswith("emb"):
        return 0.0, 0.02
    if last == "scale" or last.endswith("norm"):
        return 1.0, 0.05
    if last == "logit_scale":
        return math.log(1 / 0.07), 0.0  # CLIP's initial temperature
    raise KeyError(f"no weight rule for leaf {path!r}")


def materialize(meta_tree, generator: torch.Generator, *, device, dtype,
                rule: Callable = default_rule):
    """A tree shaped like ``meta_tree`` whose leaves are views of one flat
    ``dtype`` buffer on ``device``, drawn from ``generator`` and mapped by
    ``rule(path, shape) -> (mean, std)``."""
    items = leaves(meta_tree)
    total = sum(t.numel() for _, t in items)
    flat = torch.empty(total, dtype=dtype, device=device).normal_(generator=generator)
    values, off = {}, 0
    for path, t in items:
        view = flat[off:off + t.numel()].view(t.shape)
        off += t.numel()
        mean, std = rule(path, tuple(t.shape))
        view.mul_(std).add_(mean)
        values[path] = view
    return _rebuild(meta_tree, values)

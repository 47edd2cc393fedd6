"""Carry JAX parameter pytrees over to the port's tensor dicts.

The port keeps the JAX package's parameter layout (dicts of arrays, lists of
blocks, (in, out) weights, stacked block axes), so conversion is a tree map
over numpy arrays: callers turn a JAX tree into numpy first
(``jax.tree.map(np.asarray, params)``), and this module never imports JAX.
It is the only bridge between the two packages.
"""

from __future__ import annotations

import numpy as np
import torch


def _to_tensor(a: np.ndarray, device, dtype):
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: torch.from_numpy refuses it
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy (JAX's are read-only)
    return t.to(device=device, dtype=dtype or t.dtype)


def from_jax_params(tree, device, dtype=None):
    """Numpy pytree (dicts, lists, tuples of arrays) -> the same tree of
    tensors on ``device``; ``dtype`` casts every leaf (None keeps each
    array's own type, bf16 included)."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_jax_params(v, device, dtype) for v in tree)
    return _to_tensor(np.asarray(tree), device, dtype)

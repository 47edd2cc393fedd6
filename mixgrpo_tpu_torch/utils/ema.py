"""Exponential moving average of params.

Port of mixgrpo_tpu/utils/ema.py over the port's parameter trees (nested
dicts of tensors).  JAX returns a new tree; here ``ema_update`` updates the
EMA tensors in place (they are the trainer's own copies, never aliased by
the model), which saves a second copy of the model in device memory.
"""

from __future__ import annotations

import torch

from mixgrpo_tpu_torch.models.flux.model import param_leaves


def ema_init(params):
    """A detached copy of ``params`` (same tree, same dtypes)."""
    if isinstance(params, dict):
        return {k: ema_init(v) for k, v in params.items()}
    return params.detach().clone()


@torch.no_grad()
def ema_update(ema, params, decay: float = 0.995, step: int | None = None,
               start_step: int = 0):
    """ema <- decay * ema + (1 - decay) * params, in place (no-op before
    ``start_step``); returns ``ema``."""
    if step is not None and step < start_step:
        return ema
    for e, p in zip(param_leaves(ema), param_leaves(params)):
        e.mul_(decay).add_(p.detach().to(e.dtype), alpha=1.0 - decay)
    return ema

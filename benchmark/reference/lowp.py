"""Rounding one precision below bf16, for the controls: a tensor is
quantised and dequantised in f32 and returned in its own dtype.

``int8``: symmetric, max|x| / 127 over ``axis`` (the contraction: a
weight per output channel, an activation per token or position), rounded
half to even.  ``fp8``: e4m3 with one scale per tensor, max|x| / 448.
"""

from __future__ import annotations

import torch


def fake(x, axis, kind):
    xf = x.float()
    if kind == "int8":
        s = xf.abs().amax(dim=axis, keepdim=True).clamp_min(1e-30) / 127.0
        return (torch.round(xf / s).clamp(-127, 127) * s).to(x.dtype)
    if kind == "fp8":
        s = xf.abs().amax().clamp_min(1e-30) / 448.0
        return ((xf / s).to(torch.float8_e4m3fn).float() * s).to(x.dtype)
    raise ValueError(f"unknown precision {kind!r}")

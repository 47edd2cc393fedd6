"""Multi-axis rotary position embeddings for the FLUX MMDiT.

Port of mixgrpo_tpu/models/flux/rope.py: per-axis RoPE over (id, h, w)
position ids with axis dims (16, 56, 56); image ids are [0, row, col] on the
2x2-packed grid, text ids are all zero.  Pairing convention kept: adjacent
(even, odd) features rotate as
(x_even', x_odd') = (x_even cos - x_odd sin, x_odd cos + x_even sin).
JAX rotates with a signed-permutation matmul (a workaround for the TPU
compiler, exact); the port rotates elementwise, which gives the same values.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def make_image_ids(latent_h: int, latent_w: int) -> np.ndarray:
    """Packed-latent position ids, (h/2 * w/2, 3): [0, row, col]."""
    h, w = latent_h // 2, latent_w // 2
    ids = np.zeros((h, w, 3), dtype=np.float32)
    ids[..., 1] += np.arange(h, dtype=np.float32)[:, None]
    ids[..., 2] += np.arange(w, dtype=np.float32)[None, :]
    return ids.reshape(h * w, 3)


def make_text_ids(seq_len: int) -> np.ndarray:
    """Text token ids are all-zero triples (FLUX convention)."""
    return np.zeros((seq_len, 3), dtype=np.float32)


def rope_tables(
    ids,
    axes_dim: Sequence[int] = (16, 56, 56),
    theta: float = 10000.0,
    *,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables of shape (S, sum(axes_dim)) in f32 from (S, 3) ids;
    each entry repeated twice so the table lines up with adjacent pairs."""
    ids = torch.as_tensor(np.asarray(ids, np.float32), device=device)
    cos_parts, sin_parts = [], []
    for a, d in enumerate(axes_dim):
        j = torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
        inv_freq = 1.0 / (theta**j)
        angle = ids[:, a : a + 1] * inv_freq[None, :]
        cos_parts.append(torch.cos(angle).repeat_interleave(2, dim=-1))
        sin_parts.append(torch.sin(angle).repeat_interleave(2, dim=-1))
    return torch.cat(cos_parts, dim=-1), torch.cat(sin_parts, dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate adjacent feature pairs in f32. x: (..., S, D); cos/sin
    broadcastable to x (S, D) for bhsd, (S, 1, D) for bshd."""
    xf = x.float()
    pairs = xf.unflatten(-1, (-1, 2))
    rotated = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)
    return (xf * cos + rotated * sin).to(x.dtype)

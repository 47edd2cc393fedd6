"""Spatio-temporal tiled decoding for causal video VAEs.

Port of mixgrpo_tpu/models/video_tiling.py: one tiling algorithm for any
causal decoder with the frame mapping ``T_out = 1 + (T_latent - 1) * rt``
(the first latent frame gives one frame, every later one ``rt``):

  - evenly spaced full-sized tiles (no short last tile), so every tile has
    one shape;
  - causality across temporal chunks: every chunk after the first reaches
    back one latent frame and drops its first decoded frame (the chunk-local
    "causal start"), so its frame k >= 1 lines up with the global frame of
    the same latent;
  - seams blended on an f32 canvas with separable linear ramps, normalized
    by the summed weights.

JAX decodes the stacked tiles in one ``lax.map``; here the tiles are decoded
one at a time, each added to the canvas and freed before the next, in JAX's
order, so the peak is one tile's decode.
"""

from __future__ import annotations

import torch


def even_starts(size: int, tile: int, stride: int, lo: int = 0) -> list:
    """Evenly spaced full-tile starts covering [lo, size)."""
    if size - lo <= tile:
        return [lo]
    n = -(-(size - lo - tile) // stride) + 1
    return [lo + round(i * (size - lo - tile) / (n - 1)) for i in range(n)]


def ramp1d(n: int, blend: int, first: bool, last: bool, device="cpu") -> torch.Tensor:
    """Linear 0->1 ramps over the blend zones, flat 1 inside; the sides at
    the canvas border stay 1 (nothing to blend against)."""
    w = torch.ones((n,), dtype=torch.float32, device=device)
    blend = min(blend, n)
    ramp = (torch.arange(blend, dtype=torch.float32, device=device) + 1.0) / float(blend + 1)
    if not first:
        w[:blend] = ramp
    if not last:
        w[n - blend:] = ramp.flip(0)
    return w


def tiled_causal_decode(
    decode,  # (B, L, th, tw, C) -> (B, 1 + (L - 1) * rt, rs * th, rs * tw, 3)
    latents: torch.Tensor,  # (B, T, h, w, C)
    *,
    rt: int,  # temporal expansion ratio
    rs: int,  # spatial expansion ratio
    tile_latent: int = 32,
    tile_latent_t: int = 16,
    overlap_factor: float = 0.25,
) -> torch.Tensor:
    b, T, h, w, _ = latents.shape
    spatial = h > tile_latent or w > tile_latent
    temporal = T > tile_latent_t + 1
    if not spatial and not temporal:
        return decode(latents)

    s_stride = max(1, int(tile_latent * (1.0 - overlap_factor)))
    t_stride = max(1, int(tile_latent_t * (1.0 - overlap_factor)))
    th = min(tile_latent, h) if spatial else h
    tw = min(tile_latent, w) if spatial else w
    ys = even_starts(h, th, s_stride)
    xs = even_starts(w, tw, s_stride)

    # temporal chunks: the first is latents [0, L); the others [s-1, s-1+L)
    # with their first decoded frame dropped; L = tile_latent_t + 1 keeps
    # every chunk one shape
    if temporal:
        L = tile_latent_t + 1
        tstarts = [0] + even_starts(T, tile_latent_t, t_stride, lo=1)
        lat_t0 = [0] + [s - 1 for s in tstarts[1:]]
    else:
        L, tstarts, lat_t0 = T, [0], [0]

    dev = latents.device
    T_out = 1 + (T - 1) * rt
    px_h, px_w = rs * th, rs * tw
    blend_s = max(1, int(px_h * overlap_factor))
    blend_t_px = max(1, int(rt * tile_latent_t * overlap_factor))
    canvas = torch.zeros((b, T_out, rs * h, rs * w, 3), dtype=torch.float32, device=dev)
    weight = torch.zeros((1, T_out, rs * h, rs * w, 1), dtype=torch.float32, device=dev)
    for ti, (s, t0) in enumerate(zip(tstarts, lat_t0)):
        if ti == 0:
            f0, frames, local0 = 0, 1 + (min(L, T) - 1) * rt, 0
        else:  # local frames [1, 1 + tile_latent_t*rt) <-> latents [s, s + tile_latent_t)
            f0, frames, local0 = 1 + (s - 1) * rt, rt * tile_latent_t, 1
        wt_t = ramp1d(frames, blend_t_px, ti == 0, ti == len(tstarts) - 1, dev)
        for yi, y in enumerate(ys):
            wy = ramp1d(px_h, blend_s, yi == 0, yi == len(ys) - 1, dev)
            for xi, x in enumerate(xs):
                wx = ramp1d(px_w, blend_s, xi == 0, xi == len(xs) - 1, dev)
                wt = (wt_t[:, None, None] * wy[None, :, None] * wx[None, None, :])[None, ..., None]
                dec = decode(latents[:, t0:t0 + L, y:y + th, x:x + tw, :])
                piece = dec[:, local0:local0 + frames].float()
                del dec
                box = (slice(None), slice(f0, f0 + frames), slice(rs * y, rs * y + px_h),
                       slice(rs * x, rs * x + px_w))
                canvas[box] += piece * wt
                weight[box] += wt
                del piece
    return canvas / weight

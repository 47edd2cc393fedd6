"""Mochi-1 preview's causal video VAE decoder and its tiled decode, in plain
PyTorch.

From the published decoder (genmo/mochi-1-preview ``vae/config.json``;
genmo's ``vae/models.py`` ``Decoder``; diffusers' ``MochiDecoder3D``): the
12-channel latents de-standardised with the published per-channel mean and
std, a 1x1x1 convolution to 768 channels, three ResNets at 768, three up
blocks (6, 4 and 3 ResNets at 768, 512 and 256 channels, each followed by a
channel Linear to out x te x se x se channels and a depth-to-space-time
that expands time by te = 3, 2, 1 and space by se = 2, dropping the first
te - 1 frames, so T latent frames give 1 + 6 (T - 1)), three ResNets at
128 and a 1x1x1 convolution to RGB, mapped from [-1, 1] to [0, 1].  A
ResNet is GroupNorm (32 groups, each frame on its own, eps 1e-5), SiLU, a
causal 3x3x3 convolution (time padded in front by repeating the first
frame), twice, and the residual add.  Kernels are (kt, kh, kw, in, out) and
Linears (in, out), the program's tree layout.

Precision follows the configuration: convolutions in the compute dtype,
GroupNorm in f32, the tiles blended on an f32 canvas.  ``quant`` computes
every convolution and channel Linear one precision below, for the control
(``reference/lowp.py``): ``fp8`` (e4m3, one scale per tensor) or ``int8``.

The tiled decode is the configuration's: tiles of 32 latent pixels and
16 + 1 latent frames with a quarter overlap, evenly spaced and all full
size; each temporal chunk after the first starts one latent frame early and
drops its first decoded frame; tiles are blended on an f32 canvas with
separable linear ramps over the overlaps, divided by the summed weights.

Departures and keys this file could not confirm (no released file was
read; listed under ``assumed`` in the configuration):

- the depth-to-space-time splits the Linear's outputs as (te, se, se, C),
  the program's layout (genmo's rearrange reads (C, te, se, se): the same
  function up to a fixed permutation of the Linear's columns);
- the convolutions pad space with zeros, the program's choice; the
  published causal convolution may replicate the border;
- no SiLU before the output convolution, as the program decodes; the
  published decoders may apply one (genmo's ``output_nonlinearity``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference import lowp


def cconv(p, x, quant=None):
    """Causal 3D convolution of (B, C, T, H, W) ``x``."""
    w = p["w"].permute(4, 3, 0, 1, 2).to(x.dtype)
    kt, kh, kw = w.shape[2:]
    if kt > 1:
        x = torch.cat([x[:, :, :1].expand(-1, -1, kt - 1, -1, -1), x], 2)
    if quant:
        x, w = lowp.fake(x, 1, quant), lowp.fake(w, (1, 2, 3, 4), quant)
    return F.conv3d(x, w, p["b"].to(x.dtype), padding=(0, kh // 2, kw // 2))


def group_norm(p, x, groups):
    """GroupNorm of each frame on its own, in f32."""
    B, C, T, H, W = x.shape
    f = x.transpose(1, 2).reshape(B * T, C, H, W).float()
    y = F.group_norm(f, groups, p["scale"].float(), p["bias"].float(), 1e-5)
    return y.reshape(B, T, C, H, W).transpose(1, 2).to(x.dtype)


def resnet(p, x, groups, quant=None):
    h = cconv(p["conv1"], F.silu(group_norm(p["norm1"], x, groups)), quant)
    h = cconv(p["conv2"], F.silu(group_norm(p["norm2"], h, groups)), quant)
    return x + h


def up(p, x, te, se, cout, quant=None):
    """The channel Linear, then depth to space and time, the first te - 1
    frames dropped."""
    w = p["w"].to(x.dtype)
    xl = x.permute(0, 2, 3, 4, 1)
    if quant:
        xl, w = lowp.fake(xl, -1, quant), lowp.fake(w, 0, quant)
    y = (xl @ w + p["b"].to(x.dtype)).permute(0, 4, 1, 2, 3)
    B, _, T, H, W = y.shape
    y = y.reshape(B, te, se, se, cout, T, H, W).permute(0, 4, 5, 1, 6, 2, 7, 3)
    return y.reshape(B, cout, T * te, H * se, W * se)[:, :, te - 1:]


def decode(p, cfg, z, dtype=torch.bfloat16, quant=None):
    """(B, T, h, w, 12) de-standardised latents -> (B, 1 + 6 (T - 1), 8h,
    8w, 3) f32 in about [-1, 1]."""
    g, q = cfg["norm_num_groups"], quant
    chans = cfg["block_out_channels"]
    x = cconv(p["conv_in"], z.permute(0, 4, 1, 2, 3).to(dtype), q)
    for rp in p["block_in"]:
        x = resnet(rp, x, g, q)
    n = len(p["up_blocks"])
    for bi, blk in enumerate(p["up_blocks"]):
        for rp in blk["resnets"]:
            x = resnet(rp, x, g, q)
        te = cfg["temporal_expansions"][n - 1 - bi]
        se = cfg["spatial_expansions"][n - 1 - bi]
        x = up(blk["proj"], x, te, se, chans[n - 1 - bi], q)
    for rp in p["block_out"]:
        x = resnet(rp, x, g, q)
    return cconv(p["proj_out"], x, q).float().permute(0, 2, 3, 4, 1)


def tile_starts(size, tile, stride, lo=0):
    """Evenly spaced starts of full-size tiles covering [lo, size)."""
    if size - lo <= tile:
        return [lo]
    n = -(-(size - lo - tile) // stride) + 1
    return [lo + round(i * (size - lo - tile) / (n - 1)) for i in range(n)]


def _ramp(n, blend, first, last, device):
    w = torch.ones(n, device=device)
    blend = min(blend, n)
    r = (torch.arange(blend, dtype=torch.float32, device=device) + 1) / (blend + 1)
    if not first:
        w[:blend] = r
    if not last:
        w[n - blend:] = r.flip(0)
    return w


def decode_tiled(p, cfg, latents, dtype=torch.bfloat16, tile=32, tile_t=16, overlap=0.25,
                 quant=None):
    """The video in [0, 1], (B, 1 + 6 (T - 1), 8h, 8w, 3), of the DiT's
    final latents (B, T, h, w, 12), de-standardised and decoded in tiles
    as the module docstring says."""
    kw = dict(dtype=latents.dtype, device=latents.device)
    mean = torch.tensor(cfg["latents_mean"], **kw)
    std = torch.tensor(cfg["latents_std"], **kw)
    z = latents * std + mean
    B, T, h, w, _ = z.shape
    rt, rs = 6, 8
    dev = z.device
    s_stride, t_stride = int(tile * (1 - overlap)), int(tile_t * (1 - overlap))
    spatial = h > tile or w > tile
    th, tw = (min(tile, h), min(tile, w)) if spatial else (h, w)
    ys, xs = tile_starts(h, th, s_stride), tile_starts(w, tw, s_stride)
    if T > tile_t + 1:
        L = tile_t + 1
        chunks = [(0, 0)] + [(s, s - 1) for s in tile_starts(T, tile_t, t_stride, lo=1)]
    else:
        L, chunks = T, [(0, 0)]
    T_out = 1 + rt * (T - 1)
    canvas = torch.zeros((B, T_out, rs * h, rs * w, 3), device=dev)
    weight = torch.zeros((1, T_out, rs * h, rs * w, 1), device=dev)
    bs, bt = max(1, int(rs * th * overlap)), max(1, int(rt * tile_t * overlap))
    for ci, (s, t0) in enumerate(chunks):
        f0, nf, skip = (0, 1 + rt * (min(L, T) - 1), 0) if ci == 0 else \
            (1 + rt * (s - 1), rt * tile_t, 1)
        wt = _ramp(nf, bt, ci == 0, ci == len(chunks) - 1, dev)
        for yi, y in enumerate(ys):
            wy = _ramp(rs * th, bs, yi == 0, yi == len(ys) - 1, dev)
            for xi, x in enumerate(xs):
                wx = _ramp(rs * tw, bs, xi == 0, xi == len(xs) - 1, dev)
                wgt = (wt[:, None, None] * wy[None, :, None] * wx[None, None, :])[None, ..., None]
                piece = decode(p, cfg, z[:, t0:t0 + L, y:y + th, x:x + tw], dtype, quant)
                box = (slice(None), slice(f0, f0 + nf), slice(rs * y, rs * y + rs * th),
                       slice(rs * x, rs * x + rs * tw))
                canvas[box] += piece[:, skip:skip + nf] * wgt
                weight[box] += wgt
    return torch.clamp((canvas / weight) * 0.5 + 0.5, 0.0, 1.0)

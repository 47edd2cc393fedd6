"""HunyuanVideo's causal 3D VAE decoder and its tiled decode, in plain PyTorch.

From the published ``AutoencoderKLCausal3D`` (tencent/HunyuanVideo,
``hyvideo/vae/``): causal 3D convolutions (replicate padding of k - 1
frames before and k // 2 pixels on each side, then a valid convolution), a
3x3x3 input convolution, a mid block of ResNet, per-frame single-head
spatial attention and ResNet, four up blocks of three ResNets (GroupNorm of
32, SiLU) with nearest upsampling before a causal convolution (2x in space
in blocks 0-2, 2x in time in blocks 1-2 with the first frame kept single,
so T frames of latents give 1 + 4 (T - 1)), then GroupNorm, SiLU and a
causal convolution to RGB; kernels are (kt, kh, kw, in, out) in the
program's tree layout.  The latents are divided by the scaling 0.476986
first and the video mapped from [-1, 1] to [0, 1].

``quant`` computes every convolution and projection one precision below
the configuration's, for the control (``reference/lowp.py``): ``int8``
(weights per output channel, activations per position over the channels)
or ``fp8`` (e4m3, one scale per tensor).

The tiled decode is the configuration's: tiles of 32 latent pixels and
16 + 1 latent frames with a quarter overlap, evenly spaced and all full
size; each temporal chunk after the first starts one latent frame early and
drops its first decoded frame; tiles are blended on an f32 canvas with
separable linear ramps over the overlaps, divided by the summed weights.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference import lowp


def cconv(p, x, quant=None):
    w = p["w"].permute(4, 3, 0, 1, 2).to(x.dtype)
    kt, kh, kw = w.shape[2:]
    if kt > 1 or kh > 1:
        x = F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2, kt - 1, 0), mode="replicate")
    if quant:
        x, w = lowp.fake(x, 1, quant), lowp.fake(w, (1, 2, 3, 4), quant)
    return F.conv3d(x, w, p["b"].to(x.dtype))


def lin(x, p, quant=None):
    if quant:
        return lowp.fake(x, -1, quant) @ lowp.fake(p["w"], 0, quant) + p["b"]
    return x @ p["w"] + p["b"]


def gn(p, x, groups):
    return F.group_norm(x.float(), groups, p["scale"].float(), p["bias"].float(),
                        1e-6).to(x.dtype)


def resnet(p, x, groups, quant=None):
    h = cconv(p["conv1"], F.silu(gn(p["norm1"], x, groups)), quant)
    h = cconv(p["conv2"], F.silu(gn(p["norm2"], h, groups)), quant)
    return (cconv(p["shortcut"], x, quant) if "shortcut" in p else x) + h


def frame_attention(p, x, groups, quant=None):
    B, C, T, H, W = x.shape
    y = gn(p["norm"], x, groups).permute(0, 2, 3, 4, 1).reshape(B * T, H * W, C)
    q, k, v = (lin(y, p[n], quant) for n in ("q", "k", "v"))
    a = torch.softmax((q.float() @ k.float().transpose(1, 2)) * C ** -0.5, -1)
    o = lin((a @ v.float()).to(y.dtype), p["out"], quant)
    return x + o.reshape(B, T, H, W, C).permute(0, 4, 1, 2, 3)


def upsample(x, up_t, up_s):
    if up_t > 1 and x.shape[2] > 1:
        first = F.interpolate(x[:, :, :1], scale_factor=(1, up_s, up_s), mode="nearest")
        rest = F.interpolate(x[:, :, 1:], scale_factor=(up_t, up_s, up_s), mode="nearest")
        return torch.cat([first, rest], 2)
    return F.interpolate(x, scale_factor=(1, up_s, up_s), mode="nearest")


def decode(p, cfg, z, dtype=torch.bfloat16, quant=None):
    """(B, T, h, w, C) latents (already divided by the scaling) -> (B, 1 + 4
    (T - 1), 8h, 8w, 3) f32 in about [-1, 1]."""
    g, q = cfg["norm_num_groups"], quant
    x = cconv(p["conv_in"], z.permute(0, 4, 1, 2, 3).to(dtype), q)
    x = resnet(p["mid_res1"], x, g, q)
    x = resnet(p["mid_res2"], frame_attention(p["mid_attn"], x, g, q), g, q)
    n = len(p["up_blocks"])
    for bi, blk in enumerate(p["up_blocks"]):
        for rp in blk["resnets"]:
            x = resnet(rp, x, g, q)
        if "upsample" in blk:
            up_s = 2 if bi < 3 else 1
            up_t = 2 if 1 <= bi < n - 1 else 1
            x = cconv(blk["upsample"], upsample(x, up_t, up_s), q)
    x = cconv(p["conv_out"], F.silu(gn(p["norm_out"], x, g)), q)
    return x.float().permute(0, 2, 3, 4, 1)


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
    """The video in [0, 1], (B, 1 + 4 (T - 1), 8h, 8w, 3), of final latents
    (B, T, h, w, C), decoded in tiles as the module docstring says."""
    z = latents / cfg["scaling_factor"]
    B, T, h, w, _ = z.shape
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
    canvas = torch.zeros((B, 1 + 4 * (T - 1), 8 * h, 8 * w, 3), device=dev)
    weight = torch.zeros((1, 1 + 4 * (T - 1), 8 * h, 8 * w, 1), device=dev)
    bs, bt = int(8 * th * overlap), int(4 * tile_t * overlap)
    for ci, (s, t0) in enumerate(chunks):
        f0, nf, skip = (0, 1 + 4 * (min(L, T) - 1), 0) if ci == 0 else \
            (1 + 4 * (s - 1), 4 * tile_t, 1)
        wt = _ramp(nf, bt, ci == 0, ci == len(chunks) - 1, dev)
        for yi, y in enumerate(ys):
            wy = _ramp(8 * th, bs, yi == 0, yi == len(ys) - 1, dev)
            for xi, x in enumerate(xs):
                wx = _ramp(8 * tw, bs, xi == 0, xi == len(xs) - 1, dev)
                wgt = (wt[:, None, None] * wy[None, :, None] * wx[None, None, :])[None, ..., None]
                piece = decode(p, cfg, z[:, t0:t0 + L, y:y + th, x:x + tw], dtype, quant)
                piece = piece[:, skip:skip + nf]
                box = (slice(None), slice(f0, f0 + nf), slice(8 * y, 8 * y + 8 * th),
                       slice(8 * x, 8 * x + 8 * tw))
                canvas[box] += piece * wgt
                weight[box] += wgt
    return torch.clamp((canvas / weight) * 0.5 + 0.5, 0.0, 1.0)

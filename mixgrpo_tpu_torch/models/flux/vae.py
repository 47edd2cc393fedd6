"""FLUX AutoencoderKL decoder in plain PyTorch.

Port of the decoder half of mixgrpo_tpu/models/flux/vae.py: conv_in 16->512,
mid block (resnet, single-head spatial attention, resnet), four up blocks of
3 resnets at channels (512, 512, 256, 128) with nearest-2x upsampling, a
GroupNorm(32) + SiLU head and conv_out -> RGB; fp32 GroupNorm statistics.

The functions take and return NHWC tensors and keep JAX's HWIO conv weights,
so converted weights and outputs line up with the JAX package; inside, the
decoder runs NCHW for ``torch.nn.functional.conv2d`` (XLA computed these
convolutions outside any Pallas kernel, so they are plain library calls here
too).  The encoder waits for the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    latent_channels: int = 16
    out_channels: int = 3
    block_out_channels: tuple = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.3611
    shift_factor: float = 0.1159

    @classmethod
    def flux_dev(cls) -> "VAEConfig":
        return cls()

    @classmethod
    def tiny(cls, **kw) -> "VAEConfig":
        d = dict(block_out_channels=(8, 16, 16, 32), norm_num_groups=4)
        d.update(kw)
        return cls(**d)


def _conv_init(gen, kh, kw, cin, cout, device, dtype):
    scale = 1.0 / (kh * kw * cin) ** 0.5
    w = torch.empty((kh, kw, cin, cout), device=device, dtype=dtype)
    return {"w": w.uniform_(-scale, scale, generator=gen),
            "b": torch.zeros((cout,), device=device, dtype=dtype)}


def _gn_init(c, device, dtype):
    return {"scale": torch.ones((c,), device=device, dtype=dtype),
            "bias": torch.zeros((c,), device=device, dtype=dtype)}


def _resnet_init(gen, cin, cout, device, dtype):
    p = {
        "norm1": _gn_init(cin, device, dtype),
        "conv1": _conv_init(gen, 3, 3, cin, cout, device, dtype),
        "norm2": _gn_init(cout, device, dtype),
        "conv2": _conv_init(gen, 3, 3, cout, cout, device, dtype),
    }
    if cin != cout:
        p["shortcut"] = _conv_init(gen, 1, 1, cin, cout, device, dtype)
    return p


def _attn_init(gen, c, device, dtype):
    def lin():
        w = torch.empty((c, c), device=device, dtype=dtype)
        return {"w": w.normal_(0.0, c**-0.5, generator=gen),
                "b": torch.zeros((c,), device=device, dtype=dtype)}

    return {"norm": _gn_init(c, device, dtype), "q": lin(), "k": lin(),
            "v": lin(), "out": lin()}


def init_vae_decoder(cfg: VAEConfig, *, generator=None, device="cuda",
                     dtype=torch.float32) -> Dict[str, Any]:
    """Random decoder weights in the JAX layout, at ``dtype`` on ``device``."""
    chans = cfg.block_out_channels
    top = chans[-1]
    kw = dict(device=device, dtype=dtype)
    g = generator
    params: Dict[str, Any] = {
        "conv_in": _conv_init(g, 3, 3, cfg.latent_channels, top, **kw),
        "mid_res1": _resnet_init(g, top, top, **kw),
        "mid_attn": _attn_init(g, top, **kw),
        "mid_res2": _resnet_init(g, top, top, **kw),
        "norm_out": _gn_init(chans[0], **kw),
        "conv_out": _conv_init(g, 3, 3, chans[0], cfg.out_channels, **kw),
    }
    rev = list(reversed(chans))  # up blocks run top-down
    blocks = []
    cin = top
    for bi, cout in enumerate(rev):
        resnets = []
        for _ in range(cfg.layers_per_block + 1):
            resnets.append(_resnet_init(g, cin, cout, **kw))
            cin = cout
        blk = {"resnets": resnets}
        if bi < len(rev) - 1:
            blk["upsample"] = _conv_init(g, 3, 3, cout, cout, **kw)
        blocks.append(blk)
    params["up_blocks"] = blocks
    return params


# The decoder below runs on NCHW tensors.


def _conv(p, x, dtype=None):
    """'SAME' stride-1 convolution; ``p["w"]`` is HWIO."""
    dtype = dtype or x.dtype
    w = p["w"].to(dtype).permute(3, 2, 0, 1)  # HWIO -> OIHW
    y = F.conv2d(x.to(dtype), w, padding=w.shape[-1] // 2)
    return y + p["b"].to(dtype)[:, None, None]


def _group_norm(p, x, groups, eps=1e-6):
    y = F.group_norm(x.float(), groups, p["scale"].float(), p["bias"].float(), eps)
    return y.to(x.dtype)


def _resnet(p, x, groups, dtype):
    h = _group_norm(p["norm1"], x, groups)
    h = _conv(p["conv1"], F.silu(h), dtype=dtype)
    h = _group_norm(p["norm2"], h, groups)
    h = _conv(p["conv2"], F.silu(h), dtype=dtype)
    skip = _conv(p["shortcut"], x, dtype=dtype) if "shortcut" in p else x
    return skip + h


def _spatial_attn(p, x, groups, dtype):
    """Single-head attention over the H*W token grid (VAE mid block)."""
    b, c, h, w = x.shape
    y = _group_norm(p["norm"], x, groups).reshape(b, c, h * w).transpose(1, 2)
    proj = lambda n, t: t @ p[n]["w"].to(t.dtype) + p[n]["b"].to(t.dtype)
    q, k, v = proj("q", y), proj("k", y), proj("v", y)
    logits = q.float() @ k.float().transpose(1, 2)
    probs = torch.softmax(logits * (c**-0.5), dim=-1).to(v.dtype)
    o = (probs.float() @ v.float()).to(y.dtype)
    o = proj("out", o)
    return x + o.transpose(1, 2).reshape(b, c, h, w)


def vae_decode(
    params: Dict[str, Any],
    cfg: VAEConfig,
    latents: torch.Tensor,  # (B, h, w, latent_channels), denormalized
    dtype=torch.bfloat16,
) -> torch.Tensor:
    """Decode latents to images in [-1, 1], (B, 8h, 8w, 3) f32.  The caller
    un-normalizes first (``denormalize_latents``)."""
    g = cfg.norm_num_groups
    x = _conv(params["conv_in"], latents.permute(0, 3, 1, 2).to(dtype))
    x = _resnet(params["mid_res1"], x, g, dtype)
    x = _spatial_attn(params["mid_attn"], x, g, dtype)
    x = _resnet(params["mid_res2"], x, g, dtype)
    n_blocks = len(params["up_blocks"])
    for bi, blk in enumerate(params["up_blocks"]):
        for rp in blk["resnets"]:
            x = _resnet(rp, x, g, dtype)
        if bi < n_blocks - 1:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = _conv(blk["upsample"], x)
    x = _group_norm(params["norm_out"], x, g)
    x = _conv(params["conv_out"], F.silu(x))
    return x.permute(0, 2, 3, 1).float()


def postprocess_images(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1], clipped."""
    return torch.clamp(images * 0.5 + 0.5, 0.0, 1.0)


# ---------------------------------------------------------------------------
# tiled decode (memory-bounded decode for 1024px and large batches)
# ---------------------------------------------------------------------------


def _tile_starts(size: int, tile: int, stride: int) -> list:
    """Evenly spaced tile starts covering [0, size), all full-sized."""
    if size <= tile:
        return [0]
    n = -(-(size - tile) // stride) + 1  # ceil div
    return [round(i * (size - tile) / (n - 1)) for i in range(n)]


def _ramp_weight(tile_px: int, blend: int, first: bool, last: bool, device="cpu"):
    """1D blend profile: linear 0->1 ramp over the overlap, flat inside;
    canvas-border sides stay at weight 1."""
    w = torch.ones((tile_px,), dtype=torch.float32, device=device)
    ramp = (torch.arange(blend, dtype=torch.float32, device=device) + 1.0) / float(blend + 1)
    if not first:
        w[:blend] = ramp
    if not last:
        w[-blend:] = ramp.flip(0)
    return w


def vae_decode_tiled(
    params: Dict[str, Any],
    cfg: VAEConfig,
    latents: torch.Tensor,  # (B, h, w, latent_channels), denormalized
    dtype=torch.bfloat16,
    tile_latent: int = 64,
    overlap_factor: float = 0.25,
) -> torch.Tensor:
    """Memory-bounded decode: overlapping full-sized latent tiles decoded one
    at a time, blended on an f32 canvas with linear ramps over the overlap
    and normalized by the accumulated weight."""
    b, h, w, c = latents.shape
    if h <= tile_latent and w <= tile_latent:
        return vae_decode(params, cfg, latents, dtype)
    stride = max(1, int(tile_latent * (1.0 - overlap_factor)))
    ys = _tile_starts(h, tile_latent, stride)
    xs = _tile_starts(w, tile_latent, stride)
    th, tw = min(tile_latent, h), min(tile_latent, w)
    px_h, px_w = 8 * th, 8 * tw
    blend_h_px = max(1, int(px_h * overlap_factor))
    blend_w_px = max(1, int(px_w * overlap_factor))
    dev = latents.device
    canvas = torch.zeros((b, 8 * h, 8 * w, 3), dtype=torch.float32, device=dev)
    weight = torch.zeros((1, 8 * h, 8 * w, 1), dtype=torch.float32, device=dev)
    for yi, y in enumerate(ys):
        wy = _ramp_weight(px_h, blend_h_px, yi == 0, yi == len(ys) - 1, dev)
        for xi, x in enumerate(xs):
            wx = _ramp_weight(px_w, blend_w_px, xi == 0, xi == len(xs) - 1, dev)
            wt = (wy[:, None] * wx[None, :])[None, :, :, None]
            dec = vae_decode(params, cfg, latents[:, y : y + th, x : x + tw, :], dtype)
            canvas[:, 8 * y : 8 * y + px_h, 8 * x : 8 * x + px_w, :] += dec * wt
            weight[:, 8 * y : 8 * y + px_h, 8 * x : 8 * x + px_w, :] += wt
    return canvas / weight

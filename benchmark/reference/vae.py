"""The FLUX AutoencoderKL decoder in plain PyTorch.

From the published diffusers ``AutoencoderKL`` decoder that FLUX.1 ships
(``vae/config.json``: 16 latent channels, blocks (128, 256, 512, 512), 2
layers per block, GroupNorm of 32): a 3x3 input convolution, a mid block of
ResNet, single-head spatial attention and ResNet, four up blocks of three
ResNets with nearest 2x upsampling and a 3x3 convolution between them, then
GroupNorm, SiLU and a 3x3 convolution to RGB.  Kernels are HWIO in the
program's tree layout.  Convolutions in the compute dtype, GroupNorm and
attention statistics in f32.  Also the packing of FLUX latents: 2x2
patches of 16 channels per 64-channel token, entries in (channel, dy, dx)
order, and the latent scaling (0.3611, shift 0.1159).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

SCALING, SHIFT = 0.3611, 0.1159


def unpack(tokens, rows: int, cols: int):
    """(B, rows * cols, 4C) packed tokens -> (B, C, 2 rows, 2 cols)."""
    B, _, ch = tokens.shape
    x = tokens.reshape(B, rows, cols, ch // 4, 2, 2)
    return x.permute(0, 3, 1, 4, 2, 5).reshape(B, ch // 4, 2 * rows, 2 * cols)


def conv(p, x, stride=1):
    w = p["w"].permute(3, 2, 0, 1).to(x.dtype)
    return F.conv2d(x, w, p["b"].to(x.dtype), padding=w.shape[-1] // 2, stride=stride)


def group_norm(p, x, groups):
    return F.group_norm(x.float(), groups, p["scale"].float(), p["bias"].float(),
                        1e-6).to(x.dtype)


def resnet(p, x, groups):
    h = conv(p["conv1"], F.silu(group_norm(p["norm1"], x, groups)))
    h = conv(p["conv2"], F.silu(group_norm(p["norm2"], h, groups)))
    return (conv(p["shortcut"], x) if "shortcut" in p else x) + h


def mid_attention(p, x, groups):
    B, C, H, W = x.shape
    y = group_norm(p["norm"], x, groups).reshape(B, C, H * W).transpose(1, 2)
    q, k, v = (y @ p[n]["w"] + p[n]["b"] for n in ("q", "k", "v"))
    a = torch.softmax((q.float() @ k.float().transpose(1, 2)) * C ** -0.5, -1)
    o = (a @ v.float()).to(y.dtype) @ p["out"]["w"] + p["out"]["b"]
    return x + o.transpose(1, 2).reshape(B, C, H, W)


def decode(p, packed, rows: int, cols: int, *, groups: int = 32, dtype=torch.bfloat16):
    """Images (B, 16 rows, 16 cols, 3) in [0, 1] from packed latents."""
    x = (unpack(packed.float(), rows, cols) / SCALING + SHIFT).to(dtype)
    x = conv(p["conv_in"], x)
    x = resnet(p["mid_res1"], x, groups)
    x = mid_attention(p["mid_attn"], x, groups)
    x = resnet(p["mid_res2"], x, groups)
    for bi, blk in enumerate(p["up_blocks"]):
        for rp in blk["resnets"]:
            x = resnet(rp, x, groups)
        if "upsample" in blk:
            x = conv(blk["upsample"], F.interpolate(x, scale_factor=2, mode="nearest"))
    x = conv(p["conv_out"], F.silu(group_norm(p["norm_out"], x, groups)))
    return torch.clamp(x.float().permute(0, 2, 3, 1) * 0.5 + 0.5, 0.0, 1.0)

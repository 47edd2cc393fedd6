"""Mochi-1 causal 3D VAE decoder in plain PyTorch.

Port of mixgrpo_tpu/models/mochi/vae.py (diffusers' AutoencoderKLMochi
decoder, the names enumerated by the reference's
convert_diffusers_to_mochi.py:342-449):

  conv_in (1x1x1, 12 -> 768) -> block_in: 3 resnets at 768 ->
  up_blocks 0-2: [6, 4, 3] resnets, then a channel Linear (``proj``) and
  depth-to-space-time with (temporal, spatial) expansion (3, 2), (2, 2),
  (1, 2), 768 -> 512 -> 256 -> 128, each dropping its first te - 1 frames,
  so T_out = 1 + (T_in - 1) * 6 -> block_out: 3 resnets at 128 ->
  proj_out (1x1x1, 128 -> 3).

Not the HunyuanVideo VAE's layers, and a copy goes wrong where they differ:
  - the causal conv pads time by replicating the first frame, (k - 1, 0),
    and pads space with zeros (JAX's SAME padding), not by replication;
  - GroupNorm runs per frame (MochiChunkedGroupNorm3D): statistics over
    (H, W, C/g) of each frame in f32, eps 1e-5, the affine in f32, cast
    back;
  - ``_depth_to_spacetime`` splits channels as (te, se_h, se_w, C).
The functions take and return channels-last (B, T, H, W, C) tensors, as
JAX's do, and keep JAX's (k, k, k, cin, cout) conv weights and (in, out)
``proj`` weights; inside they run (B, C, T, H, W) for ``F.conv3d`` (cuDNN;
XLA computed these convolutions outside any Pallas kernel).  The decoder
has no attention.  ``mochi_vae_decode_tiled`` decodes overlapping tiles one
at a time (``models/video_tiling.py``).  GroupNorm with its SiLU is a
``norm`` span and each tile a ``tile`` span (``utils/profiling.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from mixgrpo_tpu_torch.utils import profiling
from mixgrpo_tpu_torch.utils.safetensors_io import SafetensorsDir, read_tensor


@dataclasses.dataclass(frozen=True)
class MochiVAEConfig:
    latent_channels: int = 12
    out_channels: int = 3
    block_out_channels: tuple = (128, 256, 512, 768)
    # resnets per stage, innermost first: block_in, up0, up1, up2, block_out
    layers: tuple = (3, 6, 4, 3, 3)
    # (temporal, spatial) expansion per up block (innermost first)
    expansions: tuple = ((3, 2), (2, 2), (1, 2))
    norm_num_groups: int = 32
    temporal_compression: int = 6
    spatial_compression: int = 8

    @classmethod
    def mochi_preview(cls) -> "MochiVAEConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "MochiVAEConfig":
        return cls(latent_channels=4, block_out_channels=(8, 8, 16, 16),
                   layers=(1, 1, 1, 1, 1), norm_num_groups=4)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _conv_init(gen, k, cin, cout, kw):
    scale = (k * k * k * cin) ** -0.5
    return {"w": torch.empty((k, k, k, cin, cout), **kw).uniform_(-scale, scale, generator=gen),
            "b": torch.zeros((cout,), **kw)}


def _gn_init(c, kw):
    return {"scale": torch.ones((c,), **kw), "bias": torch.zeros((c,), **kw)}


def _resnet_init(gen, c, kw):
    return {"norm1": _gn_init(c, kw), "conv1": _conv_init(gen, 3, c, c, kw),
            "norm2": _gn_init(c, kw), "conv2": _conv_init(gen, 3, c, c, kw)}


def init_mochi_vae_decoder(cfg: MochiVAEConfig, *, generator=None, device="cuda",
                           dtype=torch.float32) -> Dict[str, Any]:
    """Random decoder weights in the JAX layout, at ``dtype`` on ``device``."""
    chans, g, kw = cfg.block_out_channels, generator, dict(device=device, dtype=dtype)
    top = chans[-1]
    params: Dict[str, Any] = {
        "conv_in": _conv_init(g, 1, cfg.latent_channels, top, kw),
        "block_in": [_resnet_init(g, top, kw) for _ in range(cfg.layers[0])],
        "block_out": [_resnet_init(g, chans[0], kw) for _ in range(cfg.layers[-1])],
        "proj_out": _conv_init(g, 1, chans[0], cfg.out_channels, kw),
    }
    ups, cin = [], top
    for bi, (te, se) in enumerate(cfg.expansions):
        cout = chans[-2 - bi]
        n = cout * te * se * se
        ups.append({
            "resnets": [_resnet_init(g, cin, kw) for _ in range(cfg.layers[1 + bi])],
            "proj": {"w": torch.empty((cin, n), **kw).normal_(0.0, cin**-0.5, generator=g),
                     "b": torch.zeros((n,), **kw)},
        })
        cin = cout
    params["up_blocks"] = ups
    return params


# ---------------------------------------------------------------------------
# layers, on (B, C, T, H, W)
# ---------------------------------------------------------------------------


def _causal_conv(p, x, dtype=None):
    """Replicate the first frame (k - 1) times in front, zero-pad space
    (k // 2 each side), then convolve; ``p["w"]`` is (kt, kh, kw, in, out)."""
    dtype = dtype or x.dtype
    kt, kh, kw = p["w"].shape[:3]
    if kt > 1:
        x = F.pad(x, (0, 0, 0, 0, kt - 1, 0), mode="replicate")
    w = p["w"].to(dtype).permute(4, 3, 0, 1, 2)  # -> (out, in, kt, kh, kw)
    y = F.conv3d(x.to(dtype), w, padding=(0, kh // 2, kw // 2))
    return y + p["b"].to(dtype)[:, None, None, None]


def _frame_group_norm(p, x, groups, eps=1e-5, silu=False):
    """GroupNorm of each frame on its own: statistics over (C/g, H, W) in
    f32, the affine in f32, cast back to x's dtype; ``silu`` applies SiLU
    to the result.  A ``norm`` span."""
    with profiling.span("norm"):
        b, c, t, h, w = x.shape
        frames = x.transpose(1, 2).reshape(b * t, c, h, w).float()
        y = F.group_norm(frames, groups, p["scale"].float(), p["bias"].float(), eps)
        y = y.to(x.dtype).reshape(b, t, c, h, w).transpose(1, 2)
        return F.silu(y) if silu else y


def _resnet(p, x, groups, dtype):
    h = _causal_conv(p["conv1"], _frame_group_norm(p["norm1"], x, groups, silu=True), dtype)
    h = _causal_conv(p["conv2"], _frame_group_norm(p["norm2"], h, groups, silu=True), dtype)
    return x + h


def _channel_linear(p, x, dtype):
    """``proj``: an (in, out) Linear over the channel axis of (B, C, T, H, W)."""
    w = p["w"].to(dtype).t()[:, :, None, None, None]
    return F.conv3d(x.to(dtype), w) + p["b"].to(dtype)[:, None, None, None]


def _depth_to_spacetime(x, te: int, se: int, cout: int):
    """(B, te*se*se*C, T, H, W) -> (B, C, T*te - (te-1), H*se, W*se): the
    channels split as (te, se_h, se_w, C); the first te - 1 expanded frames
    are dropped (the first latent frame decodes to one output frame)."""
    b, _, t, h, w = x.shape
    x = x.reshape(b, te, se, se, cout, t, h, w).permute(0, 4, 5, 1, 6, 2, 7, 3)
    x = x.reshape(b, cout, t * te, h * se, w * se)
    return x[:, :, te - 1:] if te > 1 else x


@torch.no_grad()
def mochi_vae_decode(params, cfg: MochiVAEConfig, latents: torch.Tensor,
                     dtype=torch.bfloat16) -> torch.Tensor:
    """(B, T, h, w, 12) DEnormalized latents -> (B, 1 + (T-1)*6, 8h, 8w, 3) f32."""
    g = cfg.norm_num_groups
    x = _causal_conv(params["conv_in"], latents.permute(0, 4, 1, 2, 3).to(dtype))
    for rp in params["block_in"]:
        x = _resnet(rp, x, g, dtype)
    for bi, blk in enumerate(params["up_blocks"]):
        for rp in blk["resnets"]:
            x = _resnet(rp, x, g, dtype)
        te, se = cfg.expansions[bi]
        x = _depth_to_spacetime(_channel_linear(blk["proj"], x, dtype), te, se,
                                cfg.block_out_channels[-2 - bi])
    for rp in params["block_out"]:
        x = _resnet(rp, x, g, dtype)
    return _causal_conv(params["proj_out"], x).float().permute(0, 2, 3, 4, 1)


def mochi_vae_decode_tiled(params, cfg: MochiVAEConfig, latents: torch.Tensor,
                           dtype=torch.bfloat16, tile_latent: int = 32,
                           tile_latent_t: int = 16, overlap_factor: float = 0.25) -> torch.Tensor:
    """Memory-bounded decode, the reference pipeline's ``enable_vae_tiling``
    (256 px / 16-frame tiles, 25% overlap), decoded one tile at a time and
    ramp-blended; Mochi's frame mapping (the first latent frame gives one
    frame) is the one ``models/video_tiling.py`` tiles.  Each tile is a
    ``tile`` span."""
    from mixgrpo_tpu_torch.models.video_tiling import tiled_causal_decode

    def decode(z):
        with profiling.span("tile"):
            return mochi_vae_decode(params, cfg, z, dtype)

    return tiled_causal_decode(
        decode, latents,
        rt=cfg.temporal_compression, rs=cfg.spatial_compression, tile_latent=tile_latent,
        tile_latent_t=tile_latent_t, overlap_factor=overlap_factor)


# ---------------------------------------------------------------------------
# loader (diffusers AutoencoderKLMochi decoder names)
# ---------------------------------------------------------------------------


def load_mochi_vae_decoder(path, cfg: MochiVAEConfig, *, device="cuda",
                           dtype=torch.float32) -> Dict[str, Any]:
    """The decoder of a diffusers-layout checkpoint (a safetensors file or
    directory, or a state dict), each tensor read to ``device`` at
    ``dtype``: 2-D conv weights (Linears) become 1x1x1 kernels, (out, in,
    kt, kh, kw) kernels are transposed to (kt, kh, kw, in, out)."""
    st = SafetensorsDir(path) if isinstance(path, str) else path
    get = lambda n: read_tensor(st, n, device, dtype)

    def conv(n):
        w = get(f"{n}.weight")
        w = w.t()[None, None, None] if w.ndim == 2 else w.permute(2, 3, 4, 1, 0)
        return {"w": w.contiguous(), "b": get(f"{n}.bias")}

    def gn(n):
        return {"scale": get(f"{n}.weight"), "bias": get(f"{n}.bias")}

    def resnet(n):
        return {"norm1": gn(f"{n}.norm1.norm_layer"), "conv1": conv(f"{n}.conv1.conv"),
                "norm2": gn(f"{n}.norm2.norm_layer"), "conv2": conv(f"{n}.conv2.conv")}

    def proj(n):
        w = get(f"{n}.weight")
        return {"w": w.reshape(w.shape[0], -1).t().contiguous(), "b": get(f"{n}.bias")}

    d = "decoder"
    return {
        "conv_in": conv(f"{d}.conv_in"),
        "block_in": [resnet(f"{d}.block_in.resnets.{i}") for i in range(cfg.layers[0])],
        "block_out": [resnet(f"{d}.block_out.resnets.{i}") for i in range(cfg.layers[-1])],
        "proj_out": conv(f"{d}.proj_out"),
        "up_blocks": [
            {"resnets": [resnet(f"{d}.up_blocks.{bi}.resnets.{li}")
                         for li in range(cfg.layers[1 + bi])],
             "proj": proj(f"{d}.up_blocks.{bi}.proj")}
            for bi in range(len(cfg.expansions))
        ],
    }

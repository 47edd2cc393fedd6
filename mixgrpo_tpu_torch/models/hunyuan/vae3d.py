"""HunyuanVideo's causal 3D VAE (decoder and encoder) in plain PyTorch.

Port of mixgrpo_tpu/models/hunyuan/vae3d.py.  Structure:

  - the causal conv: replicate padding, (k-1, 0) in time (frame t sees only
    frames <= t) and (k//2, k//2) in space, then a VALID conv (strided for
    the encoder's downsampling).  Every pad is replicate, spatial included,
    as JAX pads with ``mode="edge"``;
  - GroupNorm statistics over (T, H, W, C/g) in f32;
  - decoder: conv_in -> mid (resnet, per-frame single-head spatial
    attention, resnet) -> 4 up blocks of 3 resnets -> GroupNorm + SiLU ->
    conv_out; nearest upsampling 2x in space in blocks 0-2 and 2x in time in
    blocks 1-2, never doubling the first frame, so T_out = 1 + (T_in - 1) * 4;
    ``post_quant_conv`` first when the checkpoint has one;
  - encoder: conv_in -> 4 down blocks (2 resnets + a strided causal conv:
    space in blocks 0-2, time in blocks 1-2) -> mid -> conv_out to 2x latent
    channels -> quant_conv -> the diagonal Gaussian posterior;
  - the latent scaling 0.476986 is applied by the caller.

The functions take and return channels-last (B, T, H, W, C) tensors and
keep JAX's (k, k, k, cin, cout) conv weights, permuted at each call; inside
they run (B, C, T, H, W) for ``F.pad(mode="replicate")`` and ``F.conv3d``
(cuDNN; XLA computed these convolutions outside any Pallas kernel).  The mid
block's attention at C = 512 is eager (no kernel covers D = 512).
``causal_vae_decode_tiled`` decodes overlapping tiles one at a time
(``models/video_tiling.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from mixgrpo_tpu_torch.utils.safetensors_io import SafetensorsDir, read_tensor


@dataclasses.dataclass(frozen=True)
class CausalVAEConfig:
    latent_channels: int = 16
    out_channels: int = 3
    block_out_channels: tuple = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    time_compression_ratio: int = 4
    spatial_compression_ratio: int = 8
    scaling_factor: float = 0.476986

    @classmethod
    def hunyuan_video(cls) -> "CausalVAEConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "CausalVAEConfig":
        return cls(latent_channels=4, block_out_channels=(8, 8, 16, 16), norm_num_groups=4)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _conv3d_init(gen, k, cin, cout, kw):
    scale = (k * k * k * cin) ** -0.5
    w = torch.empty((k, k, k, cin, cout), **kw).uniform_(-scale, scale, generator=gen)
    return {"w": w, "b": torch.zeros((cout,), **kw)}


def _gn_init(c, kw):
    return {"scale": torch.ones((c,), **kw), "bias": torch.zeros((c,), **kw)}


def _resnet_init(gen, cin, cout, kw):
    p = {"norm1": _gn_init(cin, kw), "conv1": _conv3d_init(gen, 3, cin, cout, kw),
         "norm2": _gn_init(cout, kw), "conv2": _conv3d_init(gen, 3, cout, cout, kw)}
    if cin != cout:
        p["shortcut"] = _conv3d_init(gen, 1, cin, cout, kw)
    return p


def _attn_init(gen, c, kw):
    def lin():
        return {"w": torch.empty((c, c), **kw).normal_(0.0, c**-0.5, generator=gen),
                "b": torch.zeros((c,), **kw)}
    return {"norm": _gn_init(c, kw), "q": lin(), "k": lin(), "v": lin(), "out": lin()}


def _block_upsample_factors(cfg: CausalVAEConfig, bi: int):
    """(spatial, temporal) factors of up-block ``bi``: spatial 2x while bi <
    log2(spatial ratio); temporal 2x in the last log2(time ratio) blocks
    before the final one."""
    n = len(cfg.block_out_channels)
    n_spatial = int(math.log2(cfg.spatial_compression_ratio))
    n_time = int(math.log2(cfg.time_compression_ratio))
    up_s = 2 if bi < n_spatial else 1
    up_t = 2 if (bi >= n - 1 - n_time and bi != n - 1) else 1
    return up_s, up_t


def _block_downsample_strides(cfg: CausalVAEConfig, bi: int):
    """(t, h, w) strides of down-block ``bi`` (the mirror of the above)."""
    n = len(cfg.block_out_channels)
    n_spatial = int(math.log2(cfg.spatial_compression_ratio))
    n_time = int(math.log2(cfg.time_compression_ratio))
    s = 2 if bi < n_spatial else 1
    t = 2 if (bi >= n - 1 - n_time and bi != n - 1) else 1
    return t, s, s


def init_causal_vae_decoder(cfg: CausalVAEConfig, *, generator=None, device="cuda",
                            dtype=torch.float32) -> Dict[str, Any]:
    """Random decoder weights in the JAX layout, at ``dtype`` on ``device``."""
    chans, g, kw = cfg.block_out_channels, generator, dict(device=device, dtype=dtype)
    top = chans[-1]
    params: Dict[str, Any] = {
        "conv_in": _conv3d_init(g, 3, cfg.latent_channels, top, kw),
        "mid_res1": _resnet_init(g, top, top, kw),
        "mid_attn": _attn_init(g, top, kw),
        "mid_res2": _resnet_init(g, top, top, kw),
        "norm_out": _gn_init(chans[0], kw),
        "conv_out": _conv3d_init(g, 3, chans[0], cfg.out_channels, kw),
    }
    blocks, cin = [], top
    for bi, cout in enumerate(reversed(chans)):
        resnets = []
        for _ in range(cfg.layers_per_block + 1):
            resnets.append(_resnet_init(g, cin, cout, kw))
            cin = cout
        blk = {"resnets": resnets}
        if max(_block_upsample_factors(cfg, bi)) > 1:
            blk["upsample"] = _conv3d_init(g, 3, cout, cout, kw)
        blocks.append(blk)
    params["up_blocks"] = blocks
    return params


def init_causal_vae_encoder(cfg: CausalVAEConfig, *, generator=None, device="cuda",
                            dtype=torch.float32) -> Dict[str, Any]:
    """Random encoder weights in the JAX layout, at ``dtype`` on ``device``."""
    chans, g, kw = cfg.block_out_channels, generator, dict(device=device, dtype=dtype)
    top, lc = chans[-1], cfg.latent_channels
    params: Dict[str, Any] = {
        "conv_in": _conv3d_init(g, 3, cfg.out_channels, chans[0], kw),
        "mid_res1": _resnet_init(g, top, top, kw),
        "mid_attn": _attn_init(g, top, kw),
        "mid_res2": _resnet_init(g, top, top, kw),
        "norm_out": _gn_init(top, kw),
        "conv_out": _conv3d_init(g, 3, top, 2 * lc, kw),
        "quant_conv": _conv3d_init(g, 1, 2 * lc, 2 * lc, kw),
    }
    blocks, cin = [], chans[0]
    for bi, cout in enumerate(chans):
        resnets = []
        for _ in range(cfg.layers_per_block):
            resnets.append(_resnet_init(g, cin, cout, kw))
            cin = cout
        blk = {"resnets": resnets}
        if max(_block_downsample_strides(cfg, bi)) > 1:
            blk["downsample"] = _conv3d_init(g, 3, cout, cout, kw)
        blocks.append(blk)
    params["down_blocks"] = blocks
    return params


# ---------------------------------------------------------------------------
# layers, on (B, C, T, H, W)
# ---------------------------------------------------------------------------


def _causal_conv3d(p, x, dtype=None, strides=(1, 1, 1)):
    """Replicate padding, (k-1, 0) in time and k//2 on each side in space,
    then a VALID (strided) convolution; ``p["w"]`` is (kt, kh, kw, in, out)."""
    dtype = dtype or x.dtype
    kt, kh, kw = p["w"].shape[:3]
    if kt > 1 or kh > 1 or kw > 1:
        x = F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2, kt - 1, 0), mode="replicate")
    w = p["w"].to(dtype).permute(4, 3, 0, 1, 2)  # -> (out, in, kt, kh, kw)
    y = F.conv3d(x.to(dtype), w, stride=tuple(strides))
    return y + p["b"].to(dtype)[:, None, None, None]


def _group_norm(p, x, groups, eps=1e-6):
    """Statistics over (C/g, T, H, W) in f32, the affine in f32."""
    y = F.group_norm(x.float(), groups, p["scale"].float(), p["bias"].float(), eps)
    return y.to(x.dtype)


def _resnet(p, x, groups, dtype):
    h = _causal_conv3d(p["conv1"], F.silu(_group_norm(p["norm1"], x, groups)), dtype)
    h = _causal_conv3d(p["conv2"], F.silu(_group_norm(p["norm2"], h, groups)), dtype)
    skip = _causal_conv3d(p["shortcut"], x, dtype) if "shortcut" in p else x
    return skip + h


def _frame_attn(p, x, groups):
    """Per-frame single-head spatial attention (the mid block), eager: f32
    scores and softmax, probabilities rounded to the compute dtype."""
    b, c, t, h, w = x.shape
    y = _group_norm(p["norm"], x, groups).permute(0, 2, 3, 4, 1).reshape(b * t, h * w, c)
    lin = lambda n, z: z @ p[n]["w"].to(z.dtype) + p[n]["b"].to(z.dtype)
    q, k, v = lin("q", y), lin("k", y), lin("v", y)
    logits = q.float() @ k.float().transpose(1, 2)
    probs = torch.softmax(logits * (c**-0.5), dim=-1).to(v.dtype)
    o = lin("out", (probs.float() @ v.float()).to(y.dtype))
    return x + o.reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3)


def _upsample(x, factor_t: int, factor_s: int):
    """Nearest upsampling; the first frame is never doubled in time."""
    if factor_t > 1 and x.shape[2] > 1:
        first = F.interpolate(x[:, :, :1], scale_factor=(1, factor_s, factor_s), mode="nearest")
        rest = F.interpolate(x[:, :, 1:], scale_factor=(factor_t, factor_s, factor_s),
                             mode="nearest")
        return torch.cat([first, rest], dim=2)
    return F.interpolate(x, scale_factor=(1, factor_s, factor_s), mode="nearest")


def _mid(params, x, g, dtype):
    x = _resnet(params["mid_res1"], x, g, dtype)
    x = _frame_attn(params["mid_attn"], x, g)
    return _resnet(params["mid_res2"], x, g, dtype)


# ---------------------------------------------------------------------------
# decode / encode
# ---------------------------------------------------------------------------


@torch.no_grad()
def causal_vae_decode(params, cfg: CausalVAEConfig, latents: torch.Tensor,
                      dtype=torch.bfloat16) -> torch.Tensor:
    """(B, T, h, w, latent_ch) -> (B, 1 + (T-1)*4, 8h, 8w, 3) f32 in about
    [-1, 1]."""
    g = cfg.norm_num_groups
    x = latents.permute(0, 4, 1, 2, 3)
    if "post_quant_conv" in params:
        x = _causal_conv3d(params["post_quant_conv"], x, dtype)
    x = _causal_conv3d(params["conv_in"], x.to(dtype))
    x = _mid(params, x, g, dtype)
    for bi, blk in enumerate(params["up_blocks"]):
        for rp in blk["resnets"]:
            x = _resnet(rp, x, g, dtype)
        if "upsample" in blk:
            up_s, up_t = _block_upsample_factors(cfg, bi)
            x = _causal_conv3d(blk["upsample"], _upsample(x, up_t, up_s), dtype)
    x = F.silu(_group_norm(params["norm_out"], x, g))
    return _causal_conv3d(params["conv_out"], x).float().permute(0, 2, 3, 4, 1)


def causal_vae_decode_tiled(params, cfg: CausalVAEConfig, latents: torch.Tensor,
                            dtype=torch.bfloat16, tile_latent: int = 32,
                            tile_latent_t: int = 16, overlap_factor: float = 0.25,
                            _decode_fn=None) -> torch.Tensor:
    """Memory-bounded decode: overlapping spatio-temporal tiles (32 latent
    pixels, 16 + 1 latent frames, 25% overlap) decoded one at a time and
    ramp-blended (``models/video_tiling.py``).  ``_decode_fn`` replaces the
    per-tile decoder (a test hook)."""
    from mixgrpo_tpu_torch.models.video_tiling import tiled_causal_decode

    decode = _decode_fn or (lambda z: causal_vae_decode(params, cfg, z, dtype))
    return tiled_causal_decode(decode, latents, rt=cfg.time_compression_ratio,
                               rs=cfg.spatial_compression_ratio, tile_latent=tile_latent,
                               tile_latent_t=tile_latent_t, overlap_factor=overlap_factor)


@torch.no_grad()
def causal_vae_encode(params, cfg: CausalVAEConfig, video: torch.Tensor,
                      generator: Optional[torch.Generator] = None, *, sample: bool = True,
                      dtype=torch.bfloat16) -> torch.Tensor:
    """(B, T, H, W, 3) in [-1, 1], T = 1 + k * 4 -> unscaled latents (B,
    1 + (T-1)/4, H/8, W/8, latent_ch) f32: the posterior drawn from
    ``generator``, or its mean with ``sample=False``."""
    g = cfg.norm_num_groups
    x = _causal_conv3d(params["conv_in"], video.permute(0, 4, 1, 2, 3).to(dtype))
    for bi, blk in enumerate(params["down_blocks"]):
        for rp in blk["resnets"]:
            x = _resnet(rp, x, g, dtype)
        if "downsample" in blk:
            x = _causal_conv3d(blk["downsample"], x, dtype,
                               strides=_block_downsample_strides(cfg, bi))
    x = _mid(params, x, g, dtype)
    x = F.silu(_group_norm(params["norm_out"], x, g))
    moments = _causal_conv3d(params["conv_out"], x).float()
    moments = _causal_conv3d(params["quant_conv"], moments).permute(0, 2, 3, 4, 1)
    mean, logvar = moments.chunk(2, dim=-1)
    if not sample:
        return mean
    if generator is None:
        raise ValueError("sampling the posterior needs a generator (or sample=False)")
    std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
    return mean + std * torch.randn(mean.shape, generator=generator, device=mean.device)


# ---------------------------------------------------------------------------
# loaders (the reference's names: CausalConv3d wraps nn.Conv3d as ``.conv``)
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, st, device, dtype):
        self.st, self.device, self.dtype = st, device, dtype

    def __call__(self, name):
        return read_tensor(self.st, name, self.device, self.dtype)

    def plain_conv(self, n):  # torch (out, in, kt, kh, kw) -> (kt, kh, kw, in, out)
        return {"w": self(f"{n}.weight").permute(2, 3, 4, 1, 0).contiguous(),
                "b": self(f"{n}.bias")}

    def conv(self, n):
        return self.plain_conv(f"{n}.conv")

    def gn(self, n):
        return {"scale": self(f"{n}.weight"), "bias": self(f"{n}.bias")}

    def lin(self, n):
        return {"w": self(f"{n}.weight").t().contiguous(), "b": self(f"{n}.bias")}

    def resnet(self, n):
        p = {"norm1": self.gn(f"{n}.norm1"), "conv1": self.conv(f"{n}.conv1"),
             "norm2": self.gn(f"{n}.norm2"), "conv2": self.conv(f"{n}.conv2")}
        if f"{n}.conv_shortcut.conv.weight" in self.st:
            p["shortcut"] = self.conv(f"{n}.conv_shortcut")
        return p

    def trunk(self, prefix):
        a = f"{prefix}.mid_block.attentions.0"
        return {
            "conv_in": self.conv(f"{prefix}.conv_in"),
            "mid_res1": self.resnet(f"{prefix}.mid_block.resnets.0"),
            "mid_attn": {"norm": self.gn(f"{a}.group_norm"), "q": self.lin(f"{a}.to_q"),
                         "k": self.lin(f"{a}.to_k"), "v": self.lin(f"{a}.to_v"),
                         "out": self.lin(f"{a}.to_out.0")},
            "mid_res2": self.resnet(f"{prefix}.mid_block.resnets.1"),
            "norm_out": self.gn(f"{prefix}.conv_norm_out"),
            "conv_out": self.conv(f"{prefix}.conv_out"),
        }


def _state(path_or_state):
    return SafetensorsDir(path_or_state) if isinstance(path_or_state, str) else path_or_state


def load_causal_vae_decoder(path, cfg: CausalVAEConfig, *, device="cuda",
                            dtype=torch.float32) -> Dict[str, Any]:
    """The decoder (+ ``post_quant_conv``) of a reference-format checkpoint
    (a safetensors file or directory, or a state dict), each tensor read to
    ``device`` at ``dtype``."""
    r = _Reader(_state(path), device, dtype)
    params = r.trunk("decoder")
    blocks = []
    for bi in range(len(cfg.block_out_channels)):
        n = f"decoder.up_blocks.{bi}"
        blk = {"resnets": [r.resnet(f"{n}.resnets.{li}")
                           for li in range(cfg.layers_per_block + 1)]}
        if f"{n}.upsamplers.0.conv.conv.weight" in r.st:
            blk["upsample"] = r.conv(f"{n}.upsamplers.0.conv")
        blocks.append(blk)
    params["up_blocks"] = blocks
    if "post_quant_conv.weight" in r.st:
        params["post_quant_conv"] = r.plain_conv("post_quant_conv")
    return params


def load_causal_vae_encoder(path, cfg: CausalVAEConfig, *, device="cuda",
                            dtype=torch.float32) -> Dict[str, Any]:
    """The encoder + ``quant_conv`` of a reference-format checkpoint; raises
    ``KeyError`` on a decoder-only file."""
    r = _Reader(_state(path), device, dtype)
    params = r.trunk("encoder")
    params["quant_conv"] = r.plain_conv("quant_conv")
    blocks = []
    for bi in range(len(cfg.block_out_channels)):
        n = f"encoder.down_blocks.{bi}"
        blk = {"resnets": [r.resnet(f"{n}.resnets.{li}") for li in range(cfg.layers_per_block)]}
        if f"{n}.downsamplers.0.conv.conv.weight" in r.st:
            blk["downsample"] = r.conv(f"{n}.downsamplers.0.conv")
        blocks.append(blk)
    params["down_blocks"] = blocks
    return params

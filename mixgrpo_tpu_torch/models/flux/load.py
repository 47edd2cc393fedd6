"""diffusers safetensors -> the port's FLUX and VAE parameter dicts.

Port of mixgrpo_tpu/models/flux/load.py, with the same name mapping onto the
JAX layout:

  - HF linear weights are (out, in); ours are (in, out) -> transpose.
  - HF conv weights are (out, in, kh, kw); ours are (kh, kw, in, out).
  - Per-block tensors are stacked along a leading depth axis.
  - Fused projections: double-block qkv = concat(to_q, to_k, to_v);
    single-block linear1 = concat(to_q, to_k, to_v, proj_mlp).

Where JAX builds every leaf in f32 on the host, the loaders here take
``dtype`` and ``device`` (default ``"cuda"``): each tensor is read from the
file's memory map straight to the device, cast and concatenated there, and
each block stack is filled one block at a time (``stack_blocks``).  A
full-depth FLUX.1-dev transformer is 23.8 GB in bf16 (47.6 GB in f32), so
the CLIs load the base and the tuned transformer in bf16 on one card.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from mixgrpo_tpu_torch.models.flux.model import FluxConfig
from mixgrpo_tpu_torch.models.flux.vae import VAEConfig
from mixgrpo_tpu_torch.utils.safetensors_io import SafetensorsDir, read_tensor, stack_blocks


def load_safetensors_dir(path: str) -> SafetensorsDir:
    """All ``*.safetensors`` under ``path`` (or a single file), read lazily."""
    return SafetensorsDir(path)


def _lin(st, name, dev, dtype):
    p = {"w": read_tensor(st, f"{name}.weight", dev, dtype).t().contiguous()}
    if f"{name}.bias" in st:
        p["b"] = read_tensor(st, f"{name}.bias", dev, dtype)
    return p


def _lin_cat(st, names, dev, dtype):
    """Several HF linears concatenated along the output dim (fused proj)."""
    w = torch.cat([read_tensor(st, f"{n}.weight", dev, dtype) for n in names])
    p = {"w": w.t().contiguous()}
    if f"{names[0]}.bias" in st:
        p["b"] = torch.cat([read_tensor(st, f"{n}.bias", dev, dtype) for n in names])
    return p


def _mlp_embedder(st, name, dev, dtype):
    return {"in": _lin(st, f"{name}.linear_1", dev, dtype),
            "out": _lin(st, f"{name}.linear_2", dev, dtype)}


def load_flux_params(path: str, cfg: FluxConfig, dtype=torch.float32, device="cuda"
                     ) -> Dict[str, Any]:
    """The ``init_flux``-shaped dict from a FLUX transformer checkpoint (a
    directory of shards or one file)."""
    st = load_safetensors_dir(path)
    kw = dict(dev=device, dtype=dtype)
    params = {
        "x_embedder": _lin(st, "x_embedder", **kw),
        "context_embedder": _lin(st, "context_embedder", **kw),
        "time_in": _mlp_embedder(st, "time_text_embed.timestep_embedder", **kw),
        "vector_in": _mlp_embedder(st, "time_text_embed.text_embedder", **kw),
        "final_mod": {"lin": _lin(st, "norm_out.linear", **kw)},
        "proj_out": _lin(st, "proj_out", **kw),
    }
    if cfg.guidance_embeds:
        params["guidance_in"] = _mlp_embedder(st, "time_text_embed.guidance_embedder", **kw)
    get = lambda n: read_tensor(st, n, device, dtype)

    def double(i):
        b = f"transformer_blocks.{i}"
        return {
            "img_mod": {"lin": _lin(st, f"{b}.norm1.linear", **kw)},
            "txt_mod": {"lin": _lin(st, f"{b}.norm1_context.linear", **kw)},
            "img_qkv": _lin_cat(st, [f"{b}.attn.to_q", f"{b}.attn.to_k", f"{b}.attn.to_v"],
                                **kw),
            "txt_qkv": _lin_cat(st, [f"{b}.attn.add_q_proj", f"{b}.attn.add_k_proj",
                                     f"{b}.attn.add_v_proj"], **kw),
            "img_qnorm": get(f"{b}.attn.norm_q.weight"),
            "img_knorm": get(f"{b}.attn.norm_k.weight"),
            "txt_qnorm": get(f"{b}.attn.norm_added_q.weight"),
            "txt_knorm": get(f"{b}.attn.norm_added_k.weight"),
            "img_attn_out": _lin(st, f"{b}.attn.to_out.0", **kw),
            "txt_attn_out": _lin(st, f"{b}.attn.to_add_out", **kw),
            "img_mlp_in": _lin(st, f"{b}.ff.net.0.proj", **kw),
            "img_mlp_out": _lin(st, f"{b}.ff.net.2", **kw),
            "txt_mlp_in": _lin(st, f"{b}.ff_context.net.0.proj", **kw),
            "txt_mlp_out": _lin(st, f"{b}.ff_context.net.2", **kw),
        }

    def single(i):
        b = f"single_transformer_blocks.{i}"
        return {
            "mod": {"lin": _lin(st, f"{b}.norm.linear", **kw)},
            "linear1": _lin_cat(st, [f"{b}.attn.to_q", f"{b}.attn.to_k", f"{b}.attn.to_v",
                                     f"{b}.proj_mlp"], **kw),
            "linear2": _lin(st, f"{b}.proj_out", **kw),
            "qnorm": get(f"{b}.attn.norm_q.weight"),
            "knorm": get(f"{b}.attn.norm_k.weight"),
        }

    params["double"] = stack_blocks(cfg.depth_double, double)
    params["single"] = stack_blocks(cfg.depth_single, single)
    return params


# ----------------------------------------------------------------------------
# VAE
# ----------------------------------------------------------------------------


def _convp(st, name, dev, dtype):
    w = read_tensor(st, f"{name}.weight", dev, dtype)  # (out, in, kh, kw)
    return {"w": w.permute(2, 3, 1, 0).contiguous(),
            "b": read_tensor(st, f"{name}.bias", dev, dtype)}


def _gnp(st, name, dev, dtype):
    return {"scale": read_tensor(st, f"{name}.weight", dev, dtype),
            "bias": read_tensor(st, f"{name}.bias", dev, dtype)}


def _resnetp(st, name, dev, dtype):
    p = {
        "norm1": _gnp(st, f"{name}.norm1", dev, dtype),
        "conv1": _convp(st, f"{name}.conv1", dev, dtype),
        "norm2": _gnp(st, f"{name}.norm2", dev, dtype),
        "conv2": _convp(st, f"{name}.conv2", dev, dtype),
    }
    if f"{name}.conv_shortcut.weight" in st:
        p["shortcut"] = _convp(st, f"{name}.conv_shortcut", dev, dtype)
    return p


def _vae_common(st, prefix, dev, dtype):
    a = f"{prefix}.mid_block.attentions.0"
    return {
        "conv_in": _convp(st, f"{prefix}.conv_in", dev, dtype),
        "mid_res1": _resnetp(st, f"{prefix}.mid_block.resnets.0", dev, dtype),
        "mid_res2": _resnetp(st, f"{prefix}.mid_block.resnets.1", dev, dtype),
        "norm_out": _gnp(st, f"{prefix}.conv_norm_out", dev, dtype),
        "conv_out": _convp(st, f"{prefix}.conv_out", dev, dtype),
        "mid_attn": {
            "norm": _gnp(st, f"{a}.group_norm", dev, dtype),
            "q": _lin(st, f"{a}.to_q", dev, dtype),
            "k": _lin(st, f"{a}.to_k", dev, dtype),
            "v": _lin(st, f"{a}.to_v", dev, dtype),
            "out": _lin(st, f"{a}.to_out.0", dev, dtype),
        },
    }


def load_vae_encoder_params(path: str, cfg: VAEConfig, dtype=torch.float32, device="cuda"):
    """Encoder side of the AutoencoderKL checkpoint (``encoder.*`` names)."""
    st = load_safetensors_dir(path)
    params = _vae_common(st, "encoder", device, dtype)
    blocks = []
    for bi in range(len(cfg.block_out_channels)):
        name = f"encoder.down_blocks.{bi}"
        blk = {"resnets": [_resnetp(st, f"{name}.resnets.{li}", device, dtype)
                           for li in range(cfg.layers_per_block)]}
        if f"{name}.downsamplers.0.conv.weight" in st:
            blk["downsample"] = _convp(st, f"{name}.downsamplers.0.conv", device, dtype)
        blocks.append(blk)
    params["down_blocks"] = blocks
    return params


def load_vae_decoder_params(path: str, cfg: VAEConfig, dtype=torch.float32, device="cuda"):
    """Decoder side of the AutoencoderKL checkpoint (``decoder.*`` names)."""
    st = load_safetensors_dir(path)
    params = _vae_common(st, "decoder", device, dtype)
    blocks = []
    for bi in range(len(cfg.block_out_channels)):
        name = f"decoder.up_blocks.{bi}"
        blk = {"resnets": [_resnetp(st, f"{name}.resnets.{li}", device, dtype)
                           for li in range(cfg.layers_per_block + 1)]}
        if f"{name}.upsamplers.0.conv.weight" in st:
            blk["upsample"] = _convp(st, f"{name}.upsamplers.0.conv", device, dtype)
        blocks.append(blk)
    params["up_blocks"] = blocks
    return params

"""Export a Mochi parameter dict back to diffusers-layout safetensors.

Port of mixgrpo_tpu/models/mochi/convert.py (the counterpart of the
reference's convert_diffusers_to_mochi.py:40-172): every tensor is renamed
and reshaped to the ``MochiTransformer3DModel`` names, so an exported
directory loads through ``load.load_mochi_checkpoint`` and in diffusers.
The files are written F32, as JAX writes them, by the port's own
safetensors writer (``utils/safetensors_io.py``), one tensor at a time.

CLI: ``python -m mixgrpo_tpu_torch.models.mochi.convert --in <diffusers_dir>
--out <dir> [--device cuda]`` round-trips a checkpoint through the dict (a
structure self-check); the config is read from the input's tensors
(``load.infer_mochi_config``), so a directory cut in depth converts too.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import torch

from mixgrpo_tpu_torch.models.flux.model import _unstack
from mixgrpo_tpu_torch.models.mochi.model import MochiConfig
from mixgrpo_tpu_torch.utils.safetensors_io import save_file


def _put_block(put, unlin, i: int, p: Dict, last: bool) -> None:
    b = f"transformer_blocks.{i}"

    def fused(base, w, names):  # (in, sum(out)) -> one (out, in) tensor per name
        for name, chunk in zip(names, w["w"].t().chunk(len(names), dim=0)):
            put(f"{base}.{name}.weight", chunk)

    unlin(f"{b}.norm1.linear", p["mod_x"]["lin"])
    fused(f"{b}.attn1", p["qkv"], ("to_q", "to_k", "to_v"))
    put(f"{b}.attn1.norm_q.weight", p["qnorm"])
    put(f"{b}.attn1.norm_k.weight", p["knorm"])
    fused(f"{b}.attn1", p["add_kv"], ("add_k_proj", "add_v_proj"))
    put(f"{b}.attn1.norm_added_k.weight", p["add_knorm"])
    unlin(f"{b}.attn1.to_out.0", p["attn_out"])
    unlin(f"{b}.ff.net.0.proj", p["ff_in"])
    unlin(f"{b}.ff.net.2", p["ff_out"])
    if last:
        unlin(f"{b}.norm1_context.linear_1", p["mod_c"]["lin"])
    else:
        unlin(f"{b}.norm1_context.linear", p["mod_c"]["lin"])
        unlin(f"{b}.attn1.add_q_proj", p["add_q"])
        put(f"{b}.attn1.norm_added_q.weight", p["add_qnorm"])
        unlin(f"{b}.attn1.to_add_out", p["attn_out_c"])
        unlin(f"{b}.ff_context.net.0.proj", p["ff_c_in"])
        unlin(f"{b}.ff_context.net.2", p["ff_c_out"])


def export_mochi_diffusers(params, cfg: MochiConfig, *, device="cpu",
                           dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Param dict -> flat diffusers-name state dict, each tensor contiguous
    on ``device`` at ``dtype`` (F32 on the host by default, as JAX's numpy
    export).  ``device=None`` keeps each tensor where it lies, as a view of
    the parameter where it can be (what ``save_mochi_diffusers`` writes
    from, casting one tensor at a time)."""
    out: Dict[str, torch.Tensor] = {}

    def put(name, t):
        t = t.detach()
        out[name] = t if device is None else t.to(device=device, dtype=dtype).contiguous()

    def unlin(name, p, conv_shape=None):
        w = p["w"].t()  # (out, in)
        put(f"{name}.weight", w if conv_shape is None else w.reshape(conv_shape))
        if "b" in p:
            put(f"{name}.bias", p["b"])

    ps = cfg.patch_size
    unlin("patch_embed.proj", params["patch_embed"],
          conv_shape=(cfg.dim, cfg.in_channels, ps, ps))
    unlin("time_embed.timestep_embedder.linear_1", params["time_in"]["in"])
    unlin("time_embed.timestep_embedder.linear_2", params["time_in"]["out"])
    for k in ("to_kv", "to_q", "to_out"):
        unlin(f"time_embed.pooler.{k}", params["pooler"][k])
    unlin("time_embed.caption_proj", params["caption_proj"])
    put("pos_frequencies", params["pos_frequencies"])
    unlin("norm_out.linear", params["final_mod"]["lin"])
    unlin("proj_out", params["proj_out"])
    for i, bp in enumerate(_unstack(params["blocks"])):
        _put_block(put, unlin, i, bp, last=False)
    _put_block(put, unlin, cfg.num_layers - 1, params["final_block"], last=True)
    return out


def save_mochi_diffusers(params, cfg: MochiConfig, out_dir: str) -> str:
    """Write diffusers-layout safetensors (one F32 shard) and a minimal
    ``config.json``; returns the shard's path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "diffusion_pytorch_model.safetensors")
    save_file(export_mochi_diffusers(params, cfg, device=None), path, dtype=torch.float32)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump({
            "_class_name": "MochiTransformer3DModel",
            "patch_size": cfg.patch_size, "num_attention_heads": cfg.num_heads,
            "attention_head_dim": cfg.head_dim, "num_layers": cfg.num_layers,
            "in_channels": cfg.in_channels,
            "pooled_projection_dim": cfg.text_dim,
            "text_embed_dim": cfg.text_embed_dim,
        }, f, indent=2)
    return path


def main(argv=None):
    import argparse

    from mixgrpo_tpu_torch.models.mochi.load import infer_mochi_config, load_mochi_hf
    from mixgrpo_tpu_torch.utils.safetensors_io import SafetensorsDir

    ap = argparse.ArgumentParser(description="Round-trip a diffusers Mochi transformer "
                                             "directory through the port's parameter dict")
    ap.add_argument("--in", dest="in_dir", required=True,
                    help="diffusers MochiTransformer3DModel dir")
    ap.add_argument("--out", dest="out_dir", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    st = SafetensorsDir(args.in_dir)
    cfg = infer_mochi_config(st)
    params = load_mochi_hf(st, cfg, device=args.device, dtype=torch.float32)
    path = save_mochi_diffusers(params, cfg, args.out_dir)
    print(path)
    return path


if __name__ == "__main__":
    main()

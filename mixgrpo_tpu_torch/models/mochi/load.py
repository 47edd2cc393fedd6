"""Diffusers ``MochiTransformer3DModel`` safetensors -> the port's Mochi dict.

Port of mixgrpo_tpu/models/mochi/load.py, with the same name mapping (the
reference's convert_diffusers_to_mochi.py:40-172 enumerates every
diffusers-side parameter):

  patch_embed.proj, time_embed.{timestep_embedder.linear_1/2, pooler.to_kv/
  to_q/to_out, caption_proj}, pos_frequencies,
  transformer_blocks.{i}.{norm1.linear, norm1_context.linear[_1],
  attn1.{to_q,to_k,to_v,norm_q,norm_k,to_out.0,add_q_proj,add_k_proj,
  add_v_proj,norm_added_q,norm_added_k,to_add_out}, ff.net.{0.proj,2},
  ff_context.net.{0.proj,2}}, norm_out.linear, proj_out.

HF linear weights are (out, in) and ours (in, out); to_q/to_k/to_v fuse into
``qkv`` and add_k_proj/add_v_proj into ``add_kv``; the conv-shaped patch
embed (out, C, p, p) is flattened to (out, C*p*p), as JAX flattens it.
Where JAX builds every leaf in f32 on the host, each tensor here is read
from the file's memory map straight to ``device`` at ``dtype``, and the 47
body blocks fill their stack one block at a time (``stack_blocks``).
``infer_mochi_config`` reads the widths and depth from the tensors, so a
file cut in depth loads without a config.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch

from mixgrpo_tpu_torch.models.mochi.model import MochiConfig
from mixgrpo_tpu_torch.utils.safetensors_io import SafetensorsDir, read_tensor, stack_blocks


def _lin(st, name, dev, dtype):
    w = read_tensor(st, f"{name}.weight", dev, dtype)
    if w.ndim == 4:  # conv-style patch embed (out, in, ph, pw)
        w = w.reshape(w.shape[0], -1)
    p = {"w": w.t().contiguous()}
    if f"{name}.bias" in st:
        p["b"] = read_tensor(st, f"{name}.bias", dev, dtype)
    return p


def _fused(st, base, names, dev, dtype):
    w = torch.cat([read_tensor(st, f"{base}.{n}.weight", dev, dtype) for n in names])
    return {"w": w.t().contiguous()}


def _block_from(st, i: int, n_layers: int, dev, dtype) -> Dict[str, Any]:
    b = f"transformer_blocks.{i}"
    kw = dict(dev=dev, dtype=dtype)
    vec = lambda name: read_tensor(st, f"{name}.weight", dev, dtype)
    p = {
        "mod_x": {"lin": _lin(st, f"{b}.norm1.linear", **kw)},
        "qkv": _fused(st, f"{b}.attn1", ("to_q", "to_k", "to_v"), **kw),
        "qnorm": vec(f"{b}.attn1.norm_q"),
        "knorm": vec(f"{b}.attn1.norm_k"),
        "add_kv": _fused(st, f"{b}.attn1", ("add_k_proj", "add_v_proj"), **kw),
        "add_knorm": vec(f"{b}.attn1.norm_added_k"),
        "attn_out": _lin(st, f"{b}.attn1.to_out.0", **kw),
        "ff_in": _lin(st, f"{b}.ff.net.0.proj", **kw),
        "ff_out": _lin(st, f"{b}.ff.net.2", **kw),
    }
    if i == n_layers - 1:  # context_pre_only: LayerNormContinuous with its own linear
        p["mod_c"] = {"lin": _lin(st, f"{b}.norm1_context.linear_1", **kw)}
    else:
        p["mod_c"] = {"lin": _lin(st, f"{b}.norm1_context.linear", **kw)}
        p["add_q"] = _lin(st, f"{b}.attn1.add_q_proj", **kw)
        p["add_qnorm"] = vec(f"{b}.attn1.norm_added_q")
        p["attn_out_c"] = _lin(st, f"{b}.attn1.to_add_out", **kw)
        p["ff_c_in"] = _lin(st, f"{b}.ff_context.net.0.proj", **kw)
        p["ff_c_out"] = _lin(st, f"{b}.ff_context.net.2", **kw)
    return p


def _shape(st: Mapping, name: str) -> tuple:
    """A tensor's shape; from its file's header for a ``SafetensorsDir``."""
    if isinstance(st, SafetensorsDir):
        return tuple(next(f.header[name]["shape"] for f in st.files if name in f))
    return tuple(st[name].shape)


def infer_mochi_config(st: Mapping) -> MochiConfig:
    """The config whose tensors ``st`` holds: depth, widths, patch and
    channels from the shapes (the pooler's heads, the text length, the base
    area and eps are not in the weights and stay ``mochi_preview``'s)."""
    n_layers = 1 + max(int(k.split(".")[1]) for k in st if k.startswith("transformer_blocks."))
    dim, in_ch, patch, _ = _shape(st, "patch_embed.proj.weight")
    head_dim = _shape(st, "transformer_blocks.0.attn1.norm_q.weight")[0]
    return MochiConfig(
        patch_size=patch, num_heads=dim // head_dim, head_dim=head_dim, num_layers=n_layers,
        in_channels=in_ch, text_dim=_shape(st, "transformer_blocks.0.attn1.add_q_proj.weight")[1],
        text_embed_dim=_shape(st, "time_embed.caption_proj.weight")[1],
        time_freq_dim=_shape(st, "time_embed.timestep_embedder.linear_1.weight")[1])


def load_mochi_hf(st: Mapping, cfg: MochiConfig, *, device="cuda",
                  dtype=torch.float32) -> Dict[str, Any]:
    """Map a diffusers MochiTransformer3DModel state (a ``SafetensorsDir`` or
    a dict of tensors or arrays) onto the ``init_mochi`` dict."""
    kw = dict(dev=device, dtype=dtype)
    n = cfg.num_layers
    return {
        "patch_embed": _lin(st, "patch_embed.proj", **kw),
        "time_in": {"in": _lin(st, "time_embed.timestep_embedder.linear_1", **kw),
                    "out": _lin(st, "time_embed.timestep_embedder.linear_2", **kw)},
        "pooler": {k: _lin(st, f"time_embed.pooler.{k}", **kw)
                   for k in ("to_kv", "to_q", "to_out")},
        "caption_proj": _lin(st, "time_embed.caption_proj", **kw),
        "pos_frequencies": read_tensor(st, "pos_frequencies", device, dtype),
        "final_mod": {"lin": _lin(st, "norm_out.linear", **kw)},
        "proj_out": _lin(st, "proj_out", **kw),
        "blocks": stack_blocks(n - 1, lambda i: _block_from(st, i, n, device, dtype)),
        "final_block": _block_from(st, n - 1, n, device, dtype),
    }


def load_mochi_checkpoint(path: str, cfg: Optional[MochiConfig] = None, *, device="cuda",
                          dtype=torch.float32) -> Dict[str, Any]:
    """A diffusers Mochi transformer directory (or one file) -> the param
    dict on ``device`` at ``dtype``; ``cfg`` defaults to the one the file
    holds (``infer_mochi_config``: ``mochi_preview`` for the released
    weights)."""
    st = SafetensorsDir(path)
    return load_mochi_hf(st, cfg or infer_mochi_config(st), device=device, dtype=dtype)

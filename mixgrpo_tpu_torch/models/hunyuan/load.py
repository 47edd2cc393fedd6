"""HunyuanVideo transformer checkpoints: the released ``.pt`` <-> the port's
parameter dict.

Port of mixgrpo_tpu/models/hunyuan/load.py, with the same name mapping of
the released ``HYVideoDiffusionTransformer`` state dict (optionally nested
under ``"module"``) onto the JAX layout:

  img_in.proj (Conv3d (h, C, 1, 2, 2))  -> img_in, flattened in (ph, pw, C)
  txt_in.{input_embedder, t_embedder.mlp.0/2, c_embedder.linear_1/2,
          individual_token_refiner.blocks.N.{norm1, self_attn_qkv,
          self_attn_proj, norm2, mlp.fc1/fc2, adaLN_modulation.1}}
  time_in.mlp.0/2, guidance_in.mlp.0/2, vector_in.{in_layer, out_layer}
  double_blocks.N.{img_mod.linear, img_attn_qkv, img_attn_{q,k}_norm,
    img_attn_proj, img_mlp.fc1/fc2, and the txt_* mirrors}
  single_blocks.N.{linear1, linear2, q_norm, k_norm, modulation.linear}
  final_layer.{linear, adaLN_modulation.1}

Where JAX converts every leaf to an f32 numpy array on the host first, the
port reads the ``.pt`` with ``torch.load(mmap=True, weights_only=True)`` (its
tensors are views of the file's pages) and moves one leaf at a time to
``device`` at ``dtype`` (bf16 by default), filling each block stack one
block at a time (``stack_blocks``), so no whole tree exists on the host.
``export_hunyuan_state_dict`` is the inverse.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import torch

from mixgrpo_tpu_torch.models.flux.model import _unstack
from mixgrpo_tpu_torch.models.hunyuan.model import HunyuanVideoConfig
from mixgrpo_tpu_torch.utils.safetensors_io import read_tensor, stack_blocks


def _depth(sd: Mapping, prefix: str) -> int:
    n = -1
    for k in sd:
        if k.startswith(prefix):
            n = max(n, int(k[len(prefix):].split(".", 1)[0]))
    return n + 1


def infer_hunyuan_config(sd: Mapping) -> HunyuanVideoConfig:
    """The architecture from the checkpoint's shapes."""
    hidden, in_ch, *patch = sd["img_in.proj.weight"].shape  # (h, C, pt, ph, pw)
    head_dim = sd["single_blocks.0.q_norm.weight"].shape[0]
    mlp_hidden = sd["double_blocks.0.img_mlp.fc1.bias"].shape[0]
    if head_dim == 128:
        rope_dims = (16, 56, 56)  # the released 720p model
    else:
        t = head_dim // 4
        if (head_dim - t) % 2:
            raise ValueError(f"head_dim {head_dim} has no (t, h, w) RoPE split")
        rope_dims = (t, (head_dim - t) // 2, (head_dim - t) // 2)
    return HunyuanVideoConfig(
        patch_size=tuple(patch), in_channels=in_ch, hidden_size=hidden,
        num_heads=hidden // head_dim, mlp_ratio=mlp_hidden / hidden,
        depth_double=_depth(sd, "double_blocks."), depth_single=_depth(sd, "single_blocks."),
        rope_dim_list=rope_dims,
        text_states_dim=sd["txt_in.input_embedder.weight"].shape[1],
        text_states_dim_2=sd["vector_in.in_layer.weight"].shape[1],
        refiner_depth=_depth(sd, "txt_in.individual_token_refiner.blocks."),
        guidance_embed="guidance_in.mlp.0.weight" in sd,
        time_freq_dim=sd["time_in.mlp.0.weight"].shape[1],
    )


class _Reader:
    def __init__(self, sd, device, dtype):
        self.sd, self.device, self.dtype = sd, device, dtype

    def __call__(self, name):
        return read_tensor(self.sd, name, self.device, self.dtype)

    def lin(self, name):
        p = {"w": self(f"{name}.weight").t().contiguous()}
        if f"{name}.bias" in self.sd:
            p["b"] = self(f"{name}.bias")
        return p

    def mlp(self, n0, n1):
        return {"in": self.lin(n0), "out": self.lin(n1)}

    def ln(self, name):
        return {"scale": self(f"{name}.weight"), "bias": self(f"{name}.bias")}


def _double_block(r: _Reader, i: int) -> Dict[str, Any]:
    b = f"double_blocks.{i}"
    return {
        "img_mod": {"lin": r.lin(f"{b}.img_mod.linear")},
        "txt_mod": {"lin": r.lin(f"{b}.txt_mod.linear")},
        "img_qkv": r.lin(f"{b}.img_attn_qkv"),
        "txt_qkv": r.lin(f"{b}.txt_attn_qkv"),
        "img_qnorm": r(f"{b}.img_attn_q_norm.weight"),
        "img_knorm": r(f"{b}.img_attn_k_norm.weight"),
        "txt_qnorm": r(f"{b}.txt_attn_q_norm.weight"),
        "txt_knorm": r(f"{b}.txt_attn_k_norm.weight"),
        "img_attn_out": r.lin(f"{b}.img_attn_proj"),
        "txt_attn_out": r.lin(f"{b}.txt_attn_proj"),
        "img_mlp_in": r.lin(f"{b}.img_mlp.fc1"),
        "img_mlp_out": r.lin(f"{b}.img_mlp.fc2"),
        "txt_mlp_in": r.lin(f"{b}.txt_mlp.fc1"),
        "txt_mlp_out": r.lin(f"{b}.txt_mlp.fc2"),
    }


def _single_block(r: _Reader, i: int) -> Dict[str, Any]:
    b = f"single_blocks.{i}"
    return {
        "mod": {"lin": r.lin(f"{b}.modulation.linear")},
        "linear1": r.lin(f"{b}.linear1"),
        "linear2": r.lin(f"{b}.linear2"),
        "qnorm": r(f"{b}.q_norm.weight"),
        "knorm": r(f"{b}.k_norm.weight"),
    }


def _refiner_block(r: _Reader, i: int) -> Dict[str, Any]:
    b = f"txt_in.individual_token_refiner.blocks.{i}"
    return {
        "norm1": r.ln(f"{b}.norm1"),
        "qkv": r.lin(f"{b}.self_attn_qkv"),
        "proj": r.lin(f"{b}.self_attn_proj"),
        "norm2": r.ln(f"{b}.norm2"),
        "mlp_in": r.lin(f"{b}.mlp.fc1"),
        "mlp_out": r.lin(f"{b}.mlp.fc2"),
        "mod": {"lin": r.lin(f"{b}.adaLN_modulation.1")},
    }


def convert_hunyuan_state_dict(sd: Mapping, cfg: Optional[HunyuanVideoConfig] = None, *,
                               device="cuda", dtype=torch.bfloat16):
    """Released HunyuanVideo state dict -> (params, config), each leaf read
    to ``device`` at ``dtype`` one at a time."""
    cfg = cfg or infer_hunyuan_config(sd)
    r = _Reader(sd, device, dtype)
    # Conv3d patchify (h, C, pt, ph, pw) -> a matmul over tokens flattened in
    # (ph, pw, C) order; pt folds in front
    conv_w = r("img_in.proj.weight")
    params: Dict[str, Any] = {
        "img_in": {"w": conv_w.permute(2, 3, 4, 1, 0).reshape(-1, conv_w.shape[0]).contiguous(),
                   "b": r("img_in.proj.bias")},
        "txt_in": {
            "input_embedder": r.lin("txt_in.input_embedder"),
            "t_embedder": r.mlp("txt_in.t_embedder.mlp.0", "txt_in.t_embedder.mlp.2"),
            "c_embedder": r.mlp("txt_in.c_embedder.linear_1", "txt_in.c_embedder.linear_2"),
            "blocks": [_refiner_block(r, i) for i in range(cfg.refiner_depth)],
        },
        "time_in": r.mlp("time_in.mlp.0", "time_in.mlp.2"),
        "vector_in": r.mlp("vector_in.in_layer", "vector_in.out_layer"),
        "final_mod": {"lin": r.lin("final_layer.adaLN_modulation.1")},
        "final_proj": r.lin("final_layer.linear"),
    }
    del conv_w
    if cfg.guidance_embed:
        params["guidance_in"] = r.mlp("guidance_in.mlp.0", "guidance_in.mlp.2")
    params["double"] = stack_blocks(cfg.depth_double, lambda i: _double_block(r, i))
    params["single"] = stack_blocks(cfg.depth_single, lambda i: _single_block(r, i))
    return params, cfg


def resolve_checkpoint_path(path: str, load_key: str = "module") -> str:
    """A directory -> its weight file: ``pytorch_model_{load_key}.pt``, else
    the one ``*.pt`` file there."""
    if os.path.isfile(path):
        return path
    preferred = os.path.join(path, f"pytorch_model_{load_key}.pt")
    if os.path.exists(preferred):
        return preferred
    files = sorted(f for f in os.listdir(path) if f.endswith(".pt"))
    if len(files) != 1:
        raise ValueError(f"cannot resolve HunyuanVideo weights in {path!r}: no "
                         f"pytorch_model_{load_key}.pt and {len(files)} .pt candidates")
    return os.path.join(path, files[0])


def load_hunyuan_video(path: str, cfg: Optional[HunyuanVideoConfig] = None,
                       load_key: str = "module", *, device="cuda", dtype=torch.bfloat16):
    """Released HunyuanVideo transformer weights -> (params, config) on
    ``device`` at ``dtype``; the file is memory-mapped, never read whole."""
    sd = torch.load(resolve_checkpoint_path(path, load_key), map_location="cpu",
                    weights_only=True, mmap=True)
    if load_key in sd:
        sd = sd[load_key]
    elif "module" in sd:
        sd = sd["module"]
    return convert_hunyuan_state_dict(sd, cfg, device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# inverse: parameter dict -> the released state-dict layout
# ---------------------------------------------------------------------------


def export_hunyuan_state_dict(params, cfg: HunyuanVideoConfig, *, device="cpu",
                              dtype=None) -> Dict[str, torch.Tensor]:
    """The parameter dict -> the released ``HYVideoDiffusionTransformer``
    names, each tensor contiguous on ``device`` at ``dtype`` (its own by
    default), for publishing weights in the layout the reference reads."""
    sd: Dict[str, torch.Tensor] = {}
    put = lambda name, t: sd.__setitem__(
        name, t.detach().to(device=device, dtype=dtype or t.dtype).contiguous())

    def unlin(name, p):
        put(f"{name}.weight", p["w"].t())
        if "b" in p:
            put(f"{name}.bias", p["b"])

    pt, ph, pw = cfg.patch_size
    w = params["img_in"]["w"]
    put("img_in.proj.weight",
        w.reshape(pt, ph, pw, cfg.in_channels, cfg.hidden_size).permute(4, 3, 0, 1, 2))
    put("img_in.proj.bias", params["img_in"]["b"])
    tx = params["txt_in"]
    unlin("txt_in.input_embedder", tx["input_embedder"])
    unlin("txt_in.t_embedder.mlp.0", tx["t_embedder"]["in"])
    unlin("txt_in.t_embedder.mlp.2", tx["t_embedder"]["out"])
    unlin("txt_in.c_embedder.linear_1", tx["c_embedder"]["in"])
    unlin("txt_in.c_embedder.linear_2", tx["c_embedder"]["out"])
    for i, bp in enumerate(tx["blocks"]):
        b = f"txt_in.individual_token_refiner.blocks.{i}"
        for n in ("norm1", "norm2"):
            put(f"{b}.{n}.weight", bp[n]["scale"])
            put(f"{b}.{n}.bias", bp[n]["bias"])
        unlin(f"{b}.self_attn_qkv", bp["qkv"])
        unlin(f"{b}.self_attn_proj", bp["proj"])
        unlin(f"{b}.mlp.fc1", bp["mlp_in"])
        unlin(f"{b}.mlp.fc2", bp["mlp_out"])
        unlin(f"{b}.adaLN_modulation.1", bp["mod"]["lin"])
    unlin("time_in.mlp.0", params["time_in"]["in"])
    unlin("time_in.mlp.2", params["time_in"]["out"])
    unlin("vector_in.in_layer", params["vector_in"]["in"])
    unlin("vector_in.out_layer", params["vector_in"]["out"])
    if cfg.guidance_embed:
        unlin("guidance_in.mlp.0", params["guidance_in"]["in"])
        unlin("guidance_in.mlp.2", params["guidance_in"]["out"])
    unlin("final_layer.adaLN_modulation.1", params["final_mod"]["lin"])
    unlin("final_layer.linear", params["final_proj"])

    for i, bp in enumerate(_unstack(params["double"])):
        b = f"double_blocks.{i}"
        for s in ("img", "txt"):
            unlin(f"{b}.{s}_mod.linear", bp[f"{s}_mod"]["lin"])
            unlin(f"{b}.{s}_attn_qkv", bp[f"{s}_qkv"])
            put(f"{b}.{s}_attn_q_norm.weight", bp[f"{s}_qnorm"])
            put(f"{b}.{s}_attn_k_norm.weight", bp[f"{s}_knorm"])
            unlin(f"{b}.{s}_attn_proj", bp[f"{s}_attn_out"])
            unlin(f"{b}.{s}_mlp.fc1", bp[f"{s}_mlp_in"])
            unlin(f"{b}.{s}_mlp.fc2", bp[f"{s}_mlp_out"])
    for i, bp in enumerate(_unstack(params["single"])):
        b = f"single_blocks.{i}"
        unlin(f"{b}.modulation.linear", bp["mod"]["lin"])
        unlin(f"{b}.linear1", bp["linear1"])
        unlin(f"{b}.linear2", bp["linear2"])
        put(f"{b}.q_norm.weight", bp["qnorm"])
        put(f"{b}.k_norm.weight", bp["knorm"])
    return sd

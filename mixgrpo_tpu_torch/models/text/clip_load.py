"""CLIP weight loading: HF ``CLIPModel`` / ``CLIPTextModel`` and OpenCLIP.

Port of mixgrpo_tpu/models/text/clip_load.py.  ``load_torch_state`` reads a
``.pt``/``.bin`` state dict with ``torch.load(weights_only=True)`` (HPS nests
it under ``state_dict``) and a ``.safetensors`` file with the port's own
reader; the config introspection builds a ``CLIPConfig`` from the config
JSON shipped beside the weights; the three loaders map each naming onto the
JAX layout (qkv fused in q, k, v order, (in, out) weights, HWIO patch
kernel, blocks stacked along a leading depth axis), reading each tensor to
``device`` at ``dtype``.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Any, Dict, Mapping

import torch

from mixgrpo_tpu_torch.models.text.clip import CLIPConfig, CLIPTowerConfig
from mixgrpo_tpu_torch.utils.safetensors_io import (
    SafetensorsDir, read_tensor, stack_blocks,
)


def load_torch_state(path: str) -> Mapping[str, torch.Tensor]:
    """A torch ``.pt``/``.bin`` state dict (HPS nests it under
    ``state_dict``), or a ``.safetensors`` file read lazily.  A ``.pt`` is
    memory-mapped (``mmap=True``): its tensors are views of the file's
    pages, read as each one is copied to the device, with no whole-file
    copy in the process's own memory."""
    if path.endswith(".safetensors"):
        return SafetensorsDir(path)
    obj = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return dict(obj)


# ---------------------------------------------------------------------------
# checkpoint-config introspection
# ---------------------------------------------------------------------------


def clip_config_from_json(cfg: dict, image_size=None) -> CLIPConfig:
    """A CLIPConfig from either config flavour: HF ``CLIPModel``
    config.json (``vision_config``/``text_config``) or open_clip's
    ``open_clip_config.json`` (``model_cfg``)."""
    if "model_cfg" in cfg:  # open_clip flavour
        m = cfg["model_cfg"]
        v, t = m["vision_cfg"], m["text_cfg"]
        v_width = v["width"]
        vision = CLIPTowerConfig(
            width=v_width, layers=v["layers"], heads=v_width // v.get("head_width", 64),
            patch=v.get("patch_size", 14), image_size=image_size or v.get("image_size", 224),
        )
        text = CLIPTowerConfig(
            width=t["width"], layers=t["layers"], heads=t.get("heads", t["width"] // 64),
            vocab=t.get("vocab_size", 49408), context=t.get("context_length", 77),
        )
        return CLIPConfig(embed_dim=m["embed_dim"], vision=vision, text=text,
                          quick_gelu=bool(m.get("quick_gelu", False)))

    v, t = cfg["vision_config"], cfg["text_config"]
    vision = CLIPTowerConfig(
        width=v["hidden_size"], layers=v["num_hidden_layers"],
        heads=v["num_attention_heads"], patch=v.get("patch_size", 14),
        image_size=image_size or v.get("image_size", 224),
    )
    text = CLIPTowerConfig(
        width=t["hidden_size"], layers=t["num_hidden_layers"],
        heads=t["num_attention_heads"], vocab=t.get("vocab_size", 49408),
        context=t.get("max_position_embeddings", 77),
    )
    return CLIPConfig(embed_dim=cfg.get("projection_dim", 512), vision=vision, text=text,
                      quick_gelu=v.get("hidden_act", "gelu") == "quick_gelu")


def find_clip_config(path: str):
    """The config JSON of a checkpoint (file or directory):
    ``open_clip_config.json``, then ``config.json``, in the directory (or
    the file's parent); the parsed dict, or None."""
    d = path if os.path.isdir(path) else os.path.dirname(os.path.abspath(path))
    for name in ("open_clip_config.json", "config.json"):
        p = os.path.join(d, name)
        if os.path.exists(p):
            with open(p) as f:
                cfg = json.load(f)
            if "model_cfg" in cfg or "vision_config" in cfg:
                return cfg
    return None


def clip_config_from_checkpoint(path: str, image_size=None, default=None) -> CLIPConfig:
    """The config introspected from the checkpoint's directory; else
    ``default``, or ViT-H-14 with a warning (a bare HPS_v2.1_compressed.pt
    *is* ViT-H-14)."""
    cfg = find_clip_config(path)
    if cfg is not None:
        return clip_config_from_json(cfg, image_size=image_size)
    if default is not None:
        return default
    warnings.warn(f"no config JSON next to {path!r}; assuming OpenCLIP ViT-H-14 "
                  "geometry (quick_gelu=False)")
    return CLIPConfig.vit_h_14(image_size=image_size or 224)


# ---------------------------------------------------------------------------
# shared mapping helpers
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, st, device, dtype):
        self.st, self.device, self.dtype = st, device, dtype

    def __call__(self, name):
        return read_tensor(self.st, name, self.device, self.dtype)

    def ln(self, name):
        return {"scale": self(f"{name}.weight"), "bias": self(f"{name}.bias")}

    def lin(self, name):
        return {"w": self(f"{name}.weight").t().contiguous(), "b": self(f"{name}.bias")}

    def t(self, name):
        return self(name).t().contiguous()

    def patch(self, name):  # (width, 3, p, p) -> HWIO
        return {"w": self(name).permute(2, 3, 1, 0).contiguous()}


def _hf_blocks(r: _Reader, prefix, n):
    def block(i):
        b = f"{prefix}.layers.{i}"
        return {
            "ln1": r.ln(f"{b}.layer_norm1"),
            "qkv": {"w": torch.cat([r(f"{b}.self_attn.{x}_proj.weight") for x in "qkv"]
                                   ).t().contiguous(),
                    "b": torch.cat([r(f"{b}.self_attn.{x}_proj.bias") for x in "qkv"])},
            "out": r.lin(f"{b}.self_attn.out_proj"),
            "ln2": r.ln(f"{b}.layer_norm2"),
            "fc1": r.lin(f"{b}.mlp.fc1"),
            "fc2": r.lin(f"{b}.mlp.fc2"),
        }
    return stack_blocks(n, block)


def _scalar(r: _Reader, name):
    return r(name).reshape(())


# ---------------------------------------------------------------------------
# HF CLIPModel naming
# ---------------------------------------------------------------------------


def load_clip_hf(state: Mapping, cfg: CLIPConfig, *, device="cuda", dtype=torch.float32
                 ) -> Dict[str, Any]:
    """Map transformers ``CLIPModel`` names onto the JAX layout."""
    r = _Reader(state, device, dtype)
    vp, tp = "vision_model", "text_model"
    vision = {
        "patch_embed": r.patch(f"{vp}.embeddings.patch_embedding.weight"),
        "class_emb": r(f"{vp}.embeddings.class_embedding"),
        "pos_emb": r(f"{vp}.embeddings.position_embedding.weight"),
        # HF's historical typo: "pre_layrnorm"
        "ln_pre": r.ln(f"{vp}.pre_layrnorm" if f"{vp}.pre_layrnorm.weight" in state
                       else f"{vp}.pre_layernorm"),
        "blocks": _hf_blocks(r, f"{vp}.encoder", cfg.vision.layers),
        "ln_post": r.ln(f"{vp}.post_layernorm"),
        "proj": r.t("visual_projection.weight"),
    }
    text = {
        "token_emb": r(f"{tp}.embeddings.token_embedding.weight"),
        "pos_emb": r(f"{tp}.embeddings.position_embedding.weight"),
        "blocks": _hf_blocks(r, f"{tp}.encoder", cfg.text.layers),
        "ln_final": r.ln(f"{tp}.final_layer_norm"),
        "proj": r.t("text_projection.weight"),
    }
    return {"vision": vision, "text": text, "logit_scale": _scalar(r, "logit_scale")}


def load_clip_hf_text_only(state: Mapping, cfg: CLIPConfig, *, device="cuda",
                           dtype=torch.float32) -> Dict[str, Any]:
    """Text tower only (FLUX's ``text_encoder`` directory is a bare
    ``CLIPTextModel``, with no vision weights and no projection: the
    projection is then the identity)."""
    r = _Reader(state, device, dtype)
    tp = "text_model"
    emb = r(f"{tp}.embeddings.token_embedding.weight")
    text = {
        "token_emb": emb,
        "pos_emb": r(f"{tp}.embeddings.position_embedding.weight"),
        "blocks": _hf_blocks(r, f"{tp}.encoder", cfg.text.layers),
        "ln_final": r.ln(f"{tp}.final_layer_norm"),
        "proj": (r.t("text_projection.weight") if "text_projection.weight" in state
                 else torch.eye(emb.shape[1], device=device, dtype=dtype)),
    }
    return {"text": text, "logit_scale": torch.zeros((), device=device, dtype=dtype)}


# ---------------------------------------------------------------------------
# OpenCLIP naming
# ---------------------------------------------------------------------------


def load_clip_openclip(state: Mapping, cfg: CLIPConfig, *, device="cuda",
                       dtype=torch.float32) -> Dict[str, Any]:
    """Map OpenCLIP state-dict names (``visual.*``, ``transformer.*``, ...)."""
    if any(k.startswith("module.") for k in state):
        state = {k.replace("module.", "", 1) if k.startswith("module.") else k: state[k]
                 for k in state}
    r = _Reader(state, device, dtype)

    def blocks(prefix, n):
        def block(i):
            b = f"{prefix}.resblocks.{i}"
            return {
                "ln1": r.ln(f"{b}.ln_1"),
                "qkv": {"w": r.t(f"{b}.attn.in_proj_weight"), "b": r(f"{b}.attn.in_proj_bias")},
                "out": r.lin(f"{b}.attn.out_proj"),
                "ln2": r.ln(f"{b}.ln_2"),
                "fc1": r.lin(f"{b}.mlp.c_fc"),
                "fc2": r.lin(f"{b}.mlp.c_proj"),
            }
        return stack_blocks(n, block)

    vision = {
        "patch_embed": r.patch("visual.conv1.weight"),  # no bias
        "class_emb": r("visual.class_embedding"),
        "pos_emb": r("visual.positional_embedding"),
        "ln_pre": r.ln("visual.ln_pre"),
        "blocks": blocks("visual.transformer", cfg.vision.layers),
        "ln_post": r.ln("visual.ln_post"),
        "proj": r("visual.proj"),  # already (width, embed)
    }
    text = {
        "token_emb": r("token_embedding.weight"),
        "pos_emb": r("positional_embedding"),
        "blocks": blocks("transformer", cfg.text.layers),
        "ln_final": r.ln("ln_final"),
        "proj": r("text_projection"),
    }
    return {"vision": vision, "text": text, "logit_scale": _scalar(r, "logit_scale")}

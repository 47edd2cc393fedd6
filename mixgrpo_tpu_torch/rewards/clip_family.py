"""CLIP-family reward models: HPSv2.1, PickScore, CLIP-score.

Port of mixgrpo_tpu/rewards/clip_family.py over the port's CLIP towers
(``models/text/clip.py``) and loaders (``clip_load.py``).

Score formulas (parity with the reference):
  - HPSv2.1:    diag(img_feat @ txt_feat^T) on normalized features — cosine;
  - PickScore:  exp(logit_scale) * cosine, then (s - 18) / 8;
  - CLIP-score: cosine similarity.

Each class takes a checkpoint path and a CLIP merges path; images enter as
(B, H, W, 3) floats in [0, 1] (the decoded VAE output) and are scored on the
device the weights live on: a CUDA batch is never copied to the host, only
the B scores come back.  The weights are held at the compute ``dtype``
(bf16 on a card, f32 on the CPU by default) except ``logit_scale``, which
stays f32 (a bf16 ``exp(logit_scale)`` would be ~1% off).  Attention is
eager, as JAX runs these towers with ``impl="xla"``; no hand-written kernel
is launched.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Sequence, Tuple

import torch

from mixgrpo_tpu_torch.models.text.clip import (
    CLIPConfig, clip_image_features, clip_text_features,
)
from mixgrpo_tpu_torch.models.text.clip_load import (
    clip_config_from_checkpoint, find_clip_config, load_clip_hf, load_clip_openclip,
    load_torch_state,
)
from mixgrpo_tpu_torch.preprocess import compute_dtype
from mixgrpo_tpu_torch.rewards.preprocess import as_image_batch, clip_preprocess
from mixgrpo_tpu_torch.rewards.tokenizer import CLIPTokenizer
from mixgrpo_tpu_torch.utils.safetensors_io import read_tensor


class _ClipRewardBase:
    name = "clip_base"
    mean = 0.0
    std = 1.0
    use_logit_scale = False

    def __init__(self, params, cfg: CLIPConfig, tokenizer: Optional[CLIPTokenizer] = None,
                 dtype: Optional[torch.dtype] = None):
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.device = params["logit_scale"].device
        self.dtype = dtype or compute_dtype(self.device)

    @torch.no_grad()
    def features(self, images, token_ids):
        """(image, text) normalized features, (B, embed) f32 each."""
        x = clip_preprocess(as_image_batch(images, self.device), self.cfg.vision.image_size)
        ids = torch.as_tensor(token_ids, device=self.device).long()
        img = clip_image_features(self.params, self.cfg, x, dtype=self.dtype)
        txt = clip_text_features(self.params, self.cfg, ids, dtype=self.dtype)
        return img, txt

    def score(self, images, token_ids) -> torch.Tensor:
        """Batched scoring with pre-tokenized prompts: (B,) f32 on the
        weights' device."""
        img, txt = self.features(images, token_ids)
        s = (img * txt).sum(dim=-1)
        if self.use_logit_scale:
            s = torch.exp(self.params["logit_scale"].float()) * s
        return (s - self.mean) / self.std

    def __call__(self, images, prompts: Sequence[str]) -> Tuple[List[float], List[float]]:
        assert self.tokenizer is not None, f"{self.name}: tokenizer required"
        ids = self.tokenizer(list(prompts))
        s = self.score(images, ids).double().cpu().tolist()
        return s, [1.0] * len(s)

    @classmethod
    def _build(cls, loader, state, cfg, merges_path, device, dtype):
        dtype = dtype or compute_dtype(device)
        params = loader(state, cfg, device=device, dtype=dtype)
        params["logit_scale"] = read_tensor(state, "logit_scale", device,
                                            torch.float32).reshape(())
        tok = CLIPTokenizer(merges_path) if merges_path else None
        return cls(params, cfg, tok, dtype=dtype)


class HPSReward(_ClipRewardBase):
    """HPSv2.1 — OpenCLIP ViT-H-14 with the HPS_v2.1 checkpoint."""

    name = "hpsv2"

    @classmethod
    def from_checkpoint(cls, hps_ckpt_path: str, merges_path: Optional[str] = None, *,
                        device="cuda", dtype: Optional[torch.dtype] = None) -> "HPSReward":
        # HPS_v2.1_compressed.pt ships bare; ViT-H-14/224 is its published
        # geometry, but a sibling config JSON (if present) wins, image_size too
        cfg = clip_config_from_checkpoint(hps_ckpt_path,
                                          default=CLIPConfig.vit_h_14(image_size=224))
        return cls._build(load_clip_openclip, load_torch_state(hps_ckpt_path), cfg,
                          merges_path, device, dtype)


class PickScoreReward(_ClipRewardBase):
    """PickScore_v1 — HF CLIP ViT-H; score = exp(logit_scale)*cos, (s-18)/8."""

    name = "pick_score"
    mean = 18.0
    std = 8.0
    use_logit_scale = True

    @classmethod
    def from_checkpoint(cls, ckpt_path: str, merges_path: Optional[str] = None, *,
                        device="cuda", dtype: Optional[torch.dtype] = None
                        ) -> "PickScoreReward":
        from mixgrpo_tpu_torch.models.flux.load import load_safetensors_dir

        # PickScore_v1 is an HF CLIPModel dir: its config.json gives hidden_act
        # and the geometry, as the reference's from_pretrained reads them
        cfg = clip_config_from_checkpoint(ckpt_path, default=CLIPConfig.vit_h_14(image_size=224))
        return cls._build(load_clip_hf, load_safetensors_dir(ckpt_path), cfg, merges_path,
                          device, dtype)


class CLIPScoreReward(_ClipRewardBase):
    """DFN5B CLIP ViT-H-14-384 cosine similarity."""

    name = "clip_score"

    @classmethod
    def from_checkpoint(cls, ckpt_path: str, merges_path: Optional[str] = None,
                        image_size: Optional[int] = None, *, device="cuda",
                        dtype: Optional[torch.dtype] = None) -> "CLIPScoreReward":
        # DFN5B publishes open_clip_config.json (quick_gelu=true, 384px): read
        # it rather than hard-coding, as the reference builds from it
        if find_clip_config(ckpt_path) is None:
            warnings.warn(
                f"no config JSON next to {ckpt_path!r}; assuming ViT-H-14/"
                f"{image_size or 384} with quick_gelu=False — DFN5B models "
                "are quickgelu variants, ship the open_clip_config.json"
            )
            cfg = CLIPConfig.vit_h_14(image_size=image_size or 384)
        else:
            cfg = clip_config_from_checkpoint(ckpt_path, image_size=image_size)
        return cls._build(load_clip_openclip, load_torch_state(ckpt_path), cfg, merges_path,
                          device, dtype)

"""ImageReward: BLIP backbone + linear score head.

Port of mixgrpo_tpu/rewards/image_reward.py:

  score = MLP(BLIP_text(prompt tokens, cross-attend BLIP_ViT(image))[CLS])
  reward = (score - 0.16717362830052426) / 1.0333394966054072

The MLP is the published head, 768 -> 1024 -> 128 -> 64 -> 16 -> 1, a plain
linear stack (state-dict indices ``layers.{0,2,4,6,7}``: the dropout slots
between them hold no weights).  BLIP resizes *square* to 224 (no
aspect-preserving crop; bicubic with antialiasing, as JAX's
``jax.image.resize``) with the CLIP normalization constants.

The prompts are tokenized by the port's BERT WordPiece tokenizer
(``models/text/tokenizer_json.py``): ``from_checkpoint`` takes it from
``bert_vocab_dir`` (a ``tokenizer.json`` or a ``vocab.txt``), and a model
without one raises when it is called.  Images are scored on the device the
weights live on; only the B scores come back to the host.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from mixgrpo_tpu_torch.models.text.blip import (
    BlipTextConfig, BlipVisionConfig, blip_text_encode, blip_vision_encode, load_blip_text,
    load_blip_vision,
)
from mixgrpo_tpu_torch.preprocess import compute_dtype
from mixgrpo_tpu_torch.rewards.preprocess import as_image_batch, normalize, resize

IR_MEAN = 0.16717362830052426
IR_STD = 1.0333394966054072
MLP_INDICES = (0, 2, 4, 6, 7)


def blip_preprocess(images: torch.Tensor, size: int = 224) -> torch.Tensor:
    """Square resize (the BLIP transform) + CLIP normalization, f32."""
    return normalize(resize(images, size, size))


def mlp_head(params: Dict, x: torch.Tensor) -> torch.Tensor:
    for layer in params["layers"]:
        x = x @ layer["w"] + layer["b"]
    return x


class ImageRewardModel:
    name = "image_reward"

    def __init__(self, vision_params, vision_cfg: BlipVisionConfig, text_params,
                 text_cfg: BlipTextConfig, mlp_params, tokenizer=None, max_len: int = 35,
                 dtype: Optional[torch.dtype] = None):
        self.vp, self.vcfg = vision_params, vision_cfg
        self.tp, self.tcfg = text_params, text_cfg
        self.mlp = mlp_params
        self.tokenizer = tokenizer
        self.max_len = max_len
        self.device = text_params["word_emb"].device
        self.dtype = dtype or compute_dtype(self.device)

    @torch.no_grad()
    def score(self, images, token_ids, attention_mask) -> torch.Tensor:
        """(B,) f32 on the weights' device."""
        x = blip_preprocess(as_image_batch(images, self.device), self.vcfg.image_size)
        img_emb = blip_vision_encode(self.vp, self.vcfg, x, dtype=self.dtype)
        txt = blip_text_encode(self.tp, self.tcfg, token_ids, attention_mask, img_emb,
                               dtype=self.dtype)
        s = mlp_head(self.mlp, txt[:, 0].float())[:, 0]
        return (s - IR_MEAN) / IR_STD

    def __call__(self, images, prompts: Sequence[str]) -> Tuple[List[float], List[float]]:
        assert self.tokenizer is not None, "image_reward: tokenizer required"
        enc = self.tokenizer(list(prompts), padding="max_length", truncation=True,
                             max_length=self.max_len, return_tensors="np")
        s = self.score(images, enc["input_ids"], enc["attention_mask"]).double().cpu().tolist()
        return s, [1.0] * len(s)

    @classmethod
    def from_checkpoint(cls, ckpt_path: str, med_config: Optional[str] = None,
                        bert_vocab_dir: Optional[str] = None, *, vision_cfg=None,
                        text_cfg=None, device="cuda", dtype: Optional[torch.dtype] = None,
                        **kw) -> "ImageRewardModel":
        """Load ``ImageReward.pt`` (``blip.visual_encoder.*``,
        ``blip.text_encoder.*``, ``mlp.layers.*``).  The vision geometry is
        ViT-L/16 at 224 (``vision_cfg`` overrides it); the text geometry is
        BERT-base, or ``med_config``'s when that file exists (``text_cfg``
        overrides both).  The MLP head is kept in f32."""
        from mixgrpo_tpu_torch.models.text.clip_load import load_torch_state
        from mixgrpo_tpu_torch.models.text.tokenizer_json import load_bert_tokenizer
        from mixgrpo_tpu_torch.utils.safetensors_io import read_tensor

        dtype = dtype or compute_dtype(device)
        st = load_torch_state(ckpt_path)
        vcfg = vision_cfg or BlipVisionConfig.vit_large()
        if text_cfg is None and med_config and os.path.exists(med_config):
            with open(med_config) as f:
                text_cfg = BlipTextConfig.from_med_config(json.load(f))
        tcfg = text_cfg or BlipTextConfig.base()
        kwd = dict(device=device, dtype=dtype)
        vp = load_blip_vision(st, vcfg, prefix="blip.visual_encoder.", **kwd)
        tp = load_blip_text(st, tcfg, prefix="blip.text_encoder.", **kwd)
        f32 = lambda n: read_tensor(st, n, device, torch.float32)
        mlp = {"layers": [{"w": f32(f"mlp.layers.{i}.weight").t().contiguous(),
                           "b": f32(f"mlp.layers.{i}.bias")} for i in MLP_INDICES]}
        tok = load_bert_tokenizer(bert_vocab_dir) if bert_vocab_dir else None
        return cls(vp, vcfg, tp, tcfg, mlp, tok, dtype=dtype, **kw)

"""HunyuanVideo text encoders: the LLM hidden-state extractor and the CLIP
pooled vector.

Port of mixgrpo_tpu/models/hunyuan/text_encoder.py:

  - ``LLMTextEncoder``: prompts wrapped in the official instruction template,
    tokenized to ``max_length`` (256) plus ``crop_start`` (95 for video, 36
    for image), run through the Llama-3 tower (``models/text/llama.py``) read
    at ``hidden_states[-(skip + 1)]`` (skip 2), then the template's tokens
    cropped off so only the prompt-conditioned states reach the DiT;
  - ``CLIPTextPooler``: CLIP-L's ``pooler_output`` (``clip_text_features``
    with ``project=False``) as the global text vector.

``tokenize_fn(texts, max_length) -> (ids, mask)`` abstracts the tokenizer.
Where JAX's ``hf_tokenize_fn`` runs ``transformers.AutoTokenizer``, the
port's ``json_tokenize_fn`` reads the directory's ``tokenizer.json`` with
``models/text/tokenizer_json.py`` (the Llama-3 byte-level BPE), right-padded
and truncated as JAX's call does.  The template strings are the released
checkpoint's wire format (the DiT was trained on states encoded under
exactly these instructions).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mixgrpo_tpu_torch.models.text.llama import LlamaConfig, llama_hidden_states, load_llama_hf

# the official encode templates (wire format of the released checkpoint)
HUNYUAN_PROMPT_TEMPLATE_ENCODE = (
    "<|start_header_id|>system<|end_header_id|>\n\nDescribe the image by "
    "detailing the color, shape, size, texture, quantity, text, spatial "
    "relationships of the objects and background:<|eot_id|>"
    "<|start_header_id|>user<|end_header_id|>\n\n{}<|eot_id|>"
)
HUNYUAN_PROMPT_TEMPLATE_ENCODE_VIDEO = (
    "<|start_header_id|>system<|end_header_id|>\n\nDescribe the video by "
    "detailing the following aspects: "
    "1. The main content and theme of the video."
    "2. The color, shape, size, texture, quantity, text, and spatial "
    "relationships of the objects."
    "3. Actions, events, behaviors temporal relationships, physical "
    "movement changes of the objects."
    "4. background environment, light, style and atmosphere."
    "5. camera angles, movements, and transitions used in the video:"
    "<|eot_id|><|start_header_id|>user<|end_header_id|>\n\n{}<|eot_id|>"
)
HUNYUAN_PROMPT_TEMPLATES = {
    "dit-llm-encode": {"template": HUNYUAN_PROMPT_TEMPLATE_ENCODE, "crop_start": 36},
    "dit-llm-encode-video": {"template": HUNYUAN_PROMPT_TEMPLATE_ENCODE_VIDEO,
                             "crop_start": 95},
}


def json_tokenize_fn(tokenizer_path: str):
    """Right-padded, truncated ``max_length`` tokenization of a directory's
    ``tokenizer.json`` (+ ``tokenizer_config.json``), as JAX's
    ``hf_tokenize_fn`` calls ``AutoTokenizer``."""
    from mixgrpo_tpu_torch.models.text.tokenizer_json import TokenizerJSON

    tok = TokenizerJSON(tokenizer_path)

    def fn(texts, max_length):
        enc = tok(list(texts), truncation=True, max_length=max_length, padding="max_length",
                  return_tensors="np")
        return enc["input_ids"], enc["attention_mask"]

    return fn


@dataclasses.dataclass
class LLMTextEncoder:
    """LLM hidden-state text encoder (the reference's ``llm`` branch)."""

    params: Any
    cfg: LlamaConfig
    tokenize_fn: Callable[[list, int], Tuple[np.ndarray, np.ndarray]]
    max_length: int = 256
    hidden_state_skip_layer: int = 2
    apply_final_norm: bool = False
    prompt_template: Optional[Dict[str, Any]] = None
    prompt_template_video: Optional[Dict[str, Any]] = None
    dtype: Any = torch.bfloat16

    def _template_for(self, data_type: str) -> Optional[Dict[str, Any]]:
        if data_type == "image":
            return self.prompt_template
        if data_type == "video":
            return self.prompt_template_video
        raise ValueError(f"Unsupported data type: {data_type}")

    def text2tokens(self, text, data_type: str = "image"):
        """The template applied and the text tokenized to ``max_length`` +
        ``crop_start``: (ids, mask) numpy."""
        texts = [text] if isinstance(text, str) else list(text)
        tpl = self._template_for(data_type)
        crop = 0
        if tpl is not None:
            texts = [tpl["template"].format(t) for t in texts]
            crop = int(tpl.get("crop_start", 0))
        ids, mask = self.tokenize_fn(texts, self.max_length + max(crop, 0))
        return np.asarray(ids), np.asarray(mask)

    def encode(self, ids, mask, data_type: str = "image"):
        """-> (hidden states (B, L, D) f32, attention mask (B, L)) on the
        tower's device, the template's ``crop_start`` tokens cropped off."""
        dev = self.params["token_emb"].device
        mask = torch.as_tensor(np.asarray(mask), device=dev)
        hidden = llama_hidden_states(
            self.params, self.cfg, torch.as_tensor(np.asarray(ids), device=dev), mask,
            hidden_state_skip_layer=self.hidden_state_skip_layer,
            apply_final_norm=self.apply_final_norm, dtype=self.dtype)
        tpl = self._template_for(data_type)
        crop = int(tpl.get("crop_start", -1)) if tpl is not None else -1
        if crop > 0:
            hidden, mask = hidden[:, crop:], mask[:, crop:]
        return hidden, mask

    def __call__(self, text, data_type: str = "image"):
        ids, mask = self.text2tokens(text, data_type)
        return self.encode(ids, mask, data_type)

    @classmethod
    def from_checkpoint(cls, path: str, tokenizer_path: Optional[str] = None,
                        cfg: Optional[LlamaConfig] = None,
                        template_id: str = "dit-llm-encode",
                        template_id_video: str = "dit-llm-encode-video", *, device="cuda",
                        dtype=torch.bfloat16, **kw) -> "LLMTextEncoder":
        """An HF ``LlamaModel`` safetensors directory + its tokenizer
        directory (``tokenizer.json``), the tower read to ``device`` at
        ``dtype`` tensor by tensor."""
        from mixgrpo_tpu_torch.utils.safetensors_io import SafetensorsDir

        cfg = cfg or LlamaConfig.llava_llama3_8b()
        params = load_llama_hf(SafetensorsDir(path), cfg, device=device, dtype=dtype)
        return cls(params=params, cfg=cfg, tokenize_fn=json_tokenize_fn(tokenizer_path or path),
                   prompt_template=HUNYUAN_PROMPT_TEMPLATES[template_id],
                   prompt_template_video=HUNYUAN_PROMPT_TEMPLATES[template_id_video],
                   dtype=dtype, **kw)


def clip_tokenize_fn(merges_path: str):
    """CLIP's BPE (``rewards/tokenizer.py``) as a ``tokenize_fn``: ids padded
    to its context length; no mask (the pooled read needs none)."""
    from mixgrpo_tpu_torch.rewards.tokenizer import CLIPTokenizer

    tok = CLIPTokenizer(merges_path)

    def fn(texts, max_length):
        if max_length != tok.context_length:
            raise ValueError(f"CLIP tokenizes to {tok.context_length} tokens, not {max_length}")
        return tok(list(texts)), None

    return fn


@dataclasses.dataclass
class CLIPTextPooler:
    """CLIP-L pooled text vector (the reference's ``clipL`` branch, its
    ``pooler_output``)."""

    params: Any
    cfg: Any
    tokenize_fn: Callable[[list, int], Tuple[np.ndarray, Any]]
    max_length: int = 77
    dtype: Any = torch.bfloat16

    def __call__(self, text) -> torch.Tensor:
        from mixgrpo_tpu_torch.models.text.clip import clip_text_features

        texts = [text] if isinstance(text, str) else list(text)
        ids, _ = self.tokenize_fn(texts, self.max_length)
        return clip_text_features(self.params, self.cfg, torch.as_tensor(np.asarray(ids)),
                                  dtype=self.dtype, project=False)

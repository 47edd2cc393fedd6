"""Prompt-embedding preprocessing: T5-XXL + CLIP-L -> embedding cache.

Port of mixgrpo_tpu/preprocess.py.  FLUX conditioning: ``prompt_embed`` is
T5-XXL's last hidden state at 512 tokens (no attention mask, as diffusers
passes none for FLUX); ``pooled`` is CLIP-L's final-LN hidden state at the
end-of-text token before the projection (the HF ``pooler_output``).  The T5
tokenizer is read from ``tokenizer_2/tokenizer.json`` by the port's own
reader (``models/text/tokenizer_json.py``), the CLIP one from
``tokenizer/merges.txt``.  Each process encodes every ``process_count``-th
prompt from its ``process_index``-th, as JAX's does by
``jax.process_index``, and writes through ``EmbeddingCacheWriter``: one
process writes the cache at ``output_dir``, several each write
``output_dir/host_<i>``.  The CLIs compute in bf16 on a card and in f32 on
the CPU (``compute_dtype``).

Run: ``python -m mixgrpo_tpu_torch.preprocess --prompt_dir prompts.txt
--output_dir cache --model_path FLUX.1-dev`` (``--device cpu`` on a machine
without a card); under ``torchrun --nproc_per_node N -m
mixgrpo_tpu_torch.preprocess ...`` each rank takes its card and its share.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from mixgrpo_tpu_torch.data.dataset import EmbeddingCacheWriter
from mixgrpo_tpu_torch.models.text.clip import clip_text_features
from mixgrpo_tpu_torch.models.text.t5 import T5Config, t5_encode
from mixgrpo_tpu_torch.utils.logging import main_print


def compute_dtype(device) -> torch.dtype:
    """The CLIs' weight and compute dtype: bf16 on a card (the released
    weights' dtype; two full transformers fit one 80 GB card only so), f32
    on the CPU (where the tests hold the CLIs against JAX)."""
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


def read_prompts(path: str) -> List[str]:
    """Prompts, one per non-empty line, of a text file, or of every
    ``*.txt`` in a directory (sorted)."""
    files = sorted(glob.glob(os.path.join(path, "*.txt"))) if os.path.isdir(path) else [path]
    out: List[str] = []
    for fp in files:
        with open(fp) as f:
            out.extend(ln.strip() for ln in f if ln.strip())
    return out


class PromptEncoder:
    """Batched T5 + CLIP-L prompt encoder; computes in ``dtype`` on the
    device its parameters live on and returns f32 numpy arrays."""

    def __init__(self, t5_params, t5_cfg: T5Config, t5_tokenizer, clip_params, clip_cfg,
                 clip_tokenizer, max_len: int = 512, dtype=torch.bfloat16):
        self.t5_params, self.t5_cfg, self.t5_tok = t5_params, t5_cfg, t5_tokenizer
        self.clip_params, self.clip_cfg, self.clip_tok = clip_params, clip_cfg, clip_tokenizer
        self.max_len = max_len
        self.dtype = dtype

    def __call__(self, prompts: Sequence[str]):
        """(B, max_len, d_model) T5 embeddings and (B, width) pooled CLIP."""
        t5_ids = self.t5_tok(list(prompts), padding="max_length", truncation=True,
                             max_length=self.max_len, return_tensors="np")["input_ids"]
        emb = t5_encode(self.t5_params, self.t5_cfg, torch.from_numpy(t5_ids.astype(np.int64)),
                        dtype=self.dtype)
        clip_ids = torch.from_numpy(self.clip_tok(list(prompts)).astype(np.int64))
        # FLUX's pooled projection takes the *unprojected* EOT hidden state
        pooled = clip_text_features(self.clip_params, self.clip_cfg, clip_ids,
                                    dtype=self.dtype, normalize=False, project=False)
        return emb.cpu().numpy(), pooled.cpu().numpy()


def run_preprocess(prompts: List[str], encoder: PromptEncoder, output_dir: str,
                   batch_size: int = 8, process_index: int = 0,
                   process_count: int = 1) -> str:
    """Encode this process's share, every ``process_count``-th prompt from
    the ``process_index``-th, and write its cache: at ``output_dir`` for one
    process, at ``output_dir/host_<process_index>`` for several.  Returns
    the manifest's path."""
    mine = prompts[process_index::process_count]
    out = output_dir if process_count == 1 else os.path.join(output_dir,
                                                             f"host_{process_index}")
    w = EmbeddingCacheWriter(out)
    for i in range(0, len(mine), batch_size):
        chunk = mine[i:i + batch_size]
        emb, pooled = encoder(chunk)
        for j, c in enumerate(chunk):
            w.add(emb[j], pooled[j], c)
        main_print(f"encoded {i + len(chunk)}/{len(mine)}")
    return w.finish()


def build_prompt_encoder_from_dir(model_path: str, max_len: int = 512,
                                  clip_bpe_path: Optional[str] = None, *, family=None,
                                  device="cuda", dtype=torch.bfloat16) -> PromptEncoder:
    """A ``PromptEncoder`` from a FLUX directory in the HF layout
    (``text_encoder/``, ``text_encoder_2/``, ``tokenizer/``,
    ``tokenizer_2/``), its weights read to ``device`` at ``dtype``.
    ``family`` defaults to ``presets.flux_family()``; the CLIP merges
    default to ``CLIP_BPE_PATH``, then ``tokenizer/merges.txt``."""
    from mixgrpo_tpu_torch.models.flux.load import load_safetensors_dir
    from mixgrpo_tpu_torch.models.text.clip_load import load_clip_hf_text_only
    from mixgrpo_tpu_torch.models.text.t5 import load_t5_hf
    from mixgrpo_tpu_torch.models.text.tokenizer_json import TokenizerJSON
    from mixgrpo_tpu_torch.presets import flux_family
    from mixgrpo_tpu_torch.rewards.tokenizer import CLIPTokenizer

    fam = family or flux_family()
    t5_cfg, clip_cfg = fam["t5"], fam["clip"]
    t5_params = load_t5_hf(load_safetensors_dir(os.path.join(model_path, "text_encoder_2")),
                           t5_cfg, device=device, dtype=dtype)
    clip_params = load_clip_hf_text_only(
        load_safetensors_dir(os.path.join(model_path, "text_encoder")), clip_cfg,
        device=device, dtype=dtype)
    merges = clip_bpe_path or os.environ.get("CLIP_BPE_PATH") or os.path.join(
        model_path, "tokenizer", "merges.txt")
    return PromptEncoder(t5_params, t5_cfg, TokenizerJSON(os.path.join(model_path, "tokenizer_2")),
                         clip_params, clip_cfg, CLIPTokenizer(merges), max_len=max_len,
                         dtype=dtype)


def main(argv=None, family=None):
    p = argparse.ArgumentParser(description="Encode prompts into the embedding cache")
    p.add_argument("--prompt_dir", type=str, required=True,
                   help="prompts.txt, or a directory of *.txt")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--model_path", type=str, required=True,
                   help="FLUX directory in the HF layout (text_encoder/, text_encoder_2/, "
                        "tokenizer/, tokenizer_2/)")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_len", type=int, default=512)
    p.add_argument("--clip_bpe_path", type=str, default=os.environ.get("CLIP_BPE_PATH"))
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (each rank takes cuda:<LOCAL_RANK mod cards>) or cpu")
    args = p.parse_args(argv)
    from mixgrpo_tpu_torch.parallel.mesh import init_distributed, resolve_device
    from mixgrpo_tpu_torch.utils.logging import process_count, process_index

    dev = resolve_device(args.device)  # raises without a card unless --device cpu
    init_distributed(device=dev)  # torchrun; no-op for one
    enc = build_prompt_encoder_from_dir(args.model_path, max_len=args.max_len,
                                        clip_bpe_path=args.clip_bpe_path, family=family,
                                        device=dev, dtype=compute_dtype(dev))
    return run_preprocess(read_prompts(args.prompt_dir), enc, args.output_dir,
                          args.batch_size, process_index(), process_count())


if __name__ == "__main__":
    main()

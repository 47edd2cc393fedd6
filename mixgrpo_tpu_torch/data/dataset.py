"""Prompt-embedding cache + RL dataset/loader.

Port of mixgrpo_tpu/data/dataset.py: the cache is a set of shards in the
safetensors format (an 8-byte little-endian header length, a JSON header of
dtype, shape and byte offsets, then the raw arrays) plus a
``manifest.json``, written by ``utils/safetensors_io.py``, so that the port
needs no ``safetensors`` package and its caches and the JAX package's are
the same files.  ``LatentDataset`` gives random access with the cfg-rate
dropout to zero embeddings (a pure function of seed, epoch and index).  It
reads rows through the native reader (``data/native_loader.py``, built with
``g++`` at first use) unless the caller asks for ``use_native=False``, the
numpy-memmap ``SafetensorsShard``; both give the same rows bit for bit.
JAX picks the native reader only where it builds; here there is no "auto":
the native reader is built or the dataset raises.
``LatentDataset.from_reference_cache`` converts the reference's ``.pt``
cache (``prompt.json`` + ``prompt_embed/i.pt`` + ``pooled_prompt_embeds/
i.pt``) into shards.  ``PromptLoader`` walks a seeded epoch permutation in
batches, each process taking every ``process_count``-th sample of it after
padding it so that every process sees as many samples.  FLUX ``text_ids``
are zeros and are not stored.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Iterator, List

import numpy as np
import torch

from mixgrpo_tpu_torch.data.native_loader import NativeShardReader
from mixgrpo_tpu_torch.utils.safetensors_io import save_file

_MANIFEST = "manifest.json"
_DTYPES = {"F16": np.float16, "F32": np.float32}


class SafetensorsShard:
    """Lazy row access to a safetensors file through a read-only memmap."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            self.header = json.loads(f.read(n))
        self.header.pop("__metadata__", None)
        self._mm = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)

    def array(self, name: str) -> np.ndarray:
        info = self.header[name]
        b0, b1 = info["data_offsets"]
        return self._mm[b0:b1].view(_DTYPES[info["dtype"]]).reshape(info["shape"])

    def gather_rows(self, name: str, rows) -> np.ndarray:
        """Rows as float32, as ``NativeShardReader.gather_rows`` gives them."""
        return np.asarray(self.array(name)[list(rows)], np.float32)


class EmbeddingCacheWriter:
    """Accumulate encoded prompts and write sharded safetensors + manifest."""

    def __init__(self, out_dir: str, shard_size: int = 1024):
        self.out_dir = out_dir
        self.shard_size = shard_size
        os.makedirs(out_dir, exist_ok=True)
        self._buf: List[Dict[str, np.ndarray]] = []
        self._captions: List[str] = []
        self._shards: List[dict] = []

    def add(self, prompt_embed: np.ndarray, pooled: np.ndarray, caption: str):
        self._buf.append({
            "prompt_embed": np.asarray(prompt_embed, np.float16),
            "pooled": np.asarray(pooled, np.float16),
        })
        self._captions.append(caption)
        if len(self._buf) >= self.shard_size:
            self._flush()

    def _flush(self):
        if not self._buf:
            return
        name = f"shard_{len(self._shards):05d}.safetensors"
        save_file({
            "prompt_embed": np.stack([b["prompt_embed"] for b in self._buf]),
            "pooled": np.stack([b["pooled"] for b in self._buf]),
        }, os.path.join(self.out_dir, name))
        self._shards.append({"file": name, "num": len(self._buf)})
        self._buf = []

    def finish(self) -> str:
        self._flush()
        manifest = {
            "version": 1,
            "num_samples": len(self._captions),
            "shards": self._shards,
            "captions": self._captions,
        }
        path = os.path.join(self.out_dir, _MANIFEST)
        with open(path, "w") as f:
            json.dump(manifest, f)
        return path


class LatentDataset:
    """Random access over the embedding cache with cfg-rate dropout: with
    probability ``cfg_rate`` a sample's embeddings become zeros and its
    caption empty, drawn from (seed, epoch, index).  ``use_native`` reads
    through ``NativeShardReader`` (the default), else through the numpy
    memmap."""

    def __init__(self, cache_dir: str, cfg_rate: float = 0.0, seed: int = 0,
                 use_native: bool = True):
        self.cache_dir = cache_dir
        self.cfg_rate = cfg_rate
        self.seed = seed
        self.use_native = use_native
        with open(os.path.join(cache_dir, _MANIFEST)) as f:
            self.manifest = json.load(f)
        self.captions: List[str] = self.manifest["captions"]
        self._index = []  # sample -> (shard_idx, row)
        for si, sh in enumerate(self.manifest["shards"]):
            for r in range(sh["num"]):
                self._index.append((si, r))
        self._handles: Dict[int, object] = {}

    def __len__(self) -> int:
        return self.manifest["num_samples"]

    def _shard(self, si: int):
        if si not in self._handles:
            path = os.path.join(self.cache_dir, self.manifest["shards"][si]["file"])
            self._handles[si] = (NativeShardReader if self.use_native else SafetensorsShard)(path)
        return self._handles[si]

    def get(self, i: int, epoch: int = 0) -> Dict[str, object]:
        si, row = self._index[i]
        sh = self._shard(si)
        emb = sh.gather_rows("prompt_embed", [row])[0]
        pooled = sh.gather_rows("pooled", [row])[0]
        caption = self.captions[i]
        if self.cfg_rate > 0:
            rng = np.random.default_rng((self.seed, epoch, i))
            if rng.random() < self.cfg_rate:
                emb = np.zeros_like(emb)
                pooled = np.zeros_like(pooled)
                caption = ""
        return {"prompt_embed": emb, "pooled": pooled, "caption": caption}

    @classmethod
    def from_reference_cache(cls, data_dir: str, cfg_rate: float = 0.0,
                             seed: int = 0) -> "LatentDataset":
        """Convert a reference-format cache (``prompt.json`` entries naming
        ``prompt_embed_path`` and ``pooled_prompt_embeds_path`` files saved
        with ``torch.save``) into shards under ``<data_dir>/mixgrpo_cache``,
        unless they are there already, and open it."""
        with open(os.path.join(data_dir, "prompt.json")) as f:
            entries = json.load(f)
        out = os.path.join(data_dir, "mixgrpo_cache")
        if not os.path.exists(os.path.join(out, _MANIFEST)):
            load = lambda name: torch.load(os.path.join(data_dir, name), map_location="cpu",
                                           weights_only=True).float().numpy()
            w = EmbeddingCacheWriter(out)
            for e in entries:
                w.add(load(e["prompt_embed_path"]), load(e["pooled_prompt_embeds_path"]),
                      e.get("caption", e.get("prompt", "")))
            w.finish()
        return cls(out, cfg_rate, seed)


class PromptLoader:
    """Epoch-shuffled, host-sharded batch iterator: the permutation of each
    epoch is drawn from (seed, epoch), as in JAX, padded with its own head so
    that its length is a multiple of ``process_count``, and process
    ``process_index`` takes every ``process_count``-th sample from its
    ``process_index``-th on."""

    def __init__(self, dataset: LatentDataset, batch_size: int, *, shuffle: bool = True,
                 seed: int = 0, process_index: int = 0, process_count: int = 1,
                 drop_last: bool = True):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.drop_last = drop_last

    def epoch(self, epoch: int) -> Iterator[Dict[str, object]]:
        n = len(self.ds)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(order)
        per = -(-n // self.process_count)
        padded = np.concatenate([order, order[: per * self.process_count - n]])
        mine = padded[self.process_index :: self.process_count]
        bs = self.batch_size
        nb = len(mine) // bs if self.drop_last else -(-len(mine) // bs)
        for b in range(nb):
            items = [self.ds.get(int(i), epoch) for i in mine[b * bs : (b + 1) * bs]]
            yield {
                "prompt_embed": np.stack([it["prompt_embed"] for it in items]),
                "pooled": np.stack([it["pooled"] for it in items]),
                "captions": [it["caption"] for it in items],
            }

    def __iter__(self):
        epoch = 0
        while True:
            yield from self.epoch(epoch)
            epoch += 1

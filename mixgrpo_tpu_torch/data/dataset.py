"""Prompt-embedding cache + RL dataset/loader.

Port of mixgrpo_tpu/data/dataset.py, in numpy only: the cache is a set of
shards in the safetensors format (an 8-byte little-endian header length, a
JSON header of dtype, shape and byte offsets, then the raw arrays) plus a
``manifest.json``, read and written here by hand so that the port needs no
``safetensors`` package and its caches and the JAX package's are the same
files.  ``LatentDataset`` gives random access with the cfg-rate dropout to
zero embeddings (a pure function of seed, epoch and index); ``PromptLoader``
walks a seeded epoch permutation in batches (one process: JAX's per-host
sharding of the permutation waits for the port of ``parallel/``).  FLUX
``text_ids`` are zeros and are not stored.  JAX's native C++ shard reader
and the reader of the reference's ``.pt`` layout are not ported: the numpy
reader takes their place.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Iterator, List

import numpy as np

_MANIFEST = "manifest.json"
_DTYPES = {"F16": np.float16, "F32": np.float32}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def save_safetensors(arrays: Dict[str, np.ndarray], path: str) -> None:
    """Write ``arrays`` as one safetensors file (header padded to 8 bytes)."""
    header, offset, blobs = {}, 0, []
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        if a.dtype not in _CODES:
            raise TypeError(f"{name}: dtype {a.dtype} has no safetensors code here")
        header[name] = {"dtype": _CODES[a.dtype], "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
        blobs.append(a.tobytes())
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for b in blobs:
            f.write(b)


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
        save_safetensors({
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
    caption empty, drawn from (seed, epoch, index)."""

    def __init__(self, cache_dir: str, cfg_rate: float = 0.0, seed: int = 0):
        self.cache_dir = cache_dir
        self.cfg_rate = cfg_rate
        self.seed = seed
        with open(os.path.join(cache_dir, _MANIFEST)) as f:
            self.manifest = json.load(f)
        self.captions: List[str] = self.manifest["captions"]
        self._index = []  # sample -> (shard_idx, row)
        for si, sh in enumerate(self.manifest["shards"]):
            for r in range(sh["num"]):
                self._index.append((si, r))
        self._handles: Dict[int, SafetensorsShard] = {}

    def __len__(self) -> int:
        return self.manifest["num_samples"]

    def _shard(self, si: int) -> SafetensorsShard:
        if si not in self._handles:
            path = os.path.join(self.cache_dir, self.manifest["shards"][si]["file"])
            self._handles[si] = SafetensorsShard(path)
        return self._handles[si]

    def get(self, i: int, epoch: int = 0) -> Dict[str, object]:
        si, row = self._index[i]
        sh = self._shard(si)
        emb = np.asarray(sh.array("prompt_embed")[row], np.float32)
        pooled = np.asarray(sh.array("pooled")[row], np.float32)
        caption = self.captions[i]
        if self.cfg_rate > 0:
            rng = np.random.default_rng((self.seed, epoch, i))
            if rng.random() < self.cfg_rate:
                emb = np.zeros_like(emb)
                pooled = np.zeros_like(pooled)
                caption = ""
        return {"prompt_embed": emb, "pooled": pooled, "caption": caption}


class PromptLoader:
    """Epoch-shuffled batch iterator (the permutation of each epoch drawn
    from (seed, epoch), as in JAX)."""

    def __init__(self, dataset: LatentDataset, batch_size: int, *, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last

    def epoch(self, epoch: int) -> Iterator[Dict[str, object]]:
        order = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(order)
        bs = self.batch_size
        nb = len(order) // bs if self.drop_last else -(-len(order) // bs)
        for b in range(nb):
            items = [self.ds.get(int(i), epoch) for i in order[b * bs : (b + 1) * bs]]
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

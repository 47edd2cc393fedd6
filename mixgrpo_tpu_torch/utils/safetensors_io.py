"""safetensors files without the ``safetensors`` package.

The JAX package reads and writes released checkpoints through
``safetensors.numpy`` (mixgrpo_tpu/models/flux/load.py:40-53,
utils/checkpoint.py:202-205, models/text/clip_load.py:27-30); the card's
machine has no such package, so the port handles the format itself: an
8-byte little-endian header length, a JSON header (``__metadata__`` and, per
tensor, its dtype code, shape and byte offsets into the data), then the
raw little-endian data.

Reading maps one tensor's bytes at a time (``mmap``, copy-on-write, so no
write reaches the file) and copies them straight to the target device, so a
23.8 GB bf16 transformer never has a whole-file host copy: the host holds
one tensor's pages at a time and unmaps them after the copy.  F32, F16 and
BF16 (and the integer codes I64, I32) are read; any other dtype code raises.

``stack_blocks`` and ``read_tensor`` are the helpers the loaders share: the
loaders fill a preallocated block stack one block at a time, so a stack on
the card never exists twice.
"""

from __future__ import annotations

import glob
import json
import mmap
import os
import struct
from typing import Any, Callable, Dict, Iterator, Mapping, Optional

import numpy as np
import torch

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I64": torch.int64, "I32": torch.int32}
_CODES = {v: k for k, v in DTYPES.items()}


class SafetensorsFile:
    """One safetensors file: its header, and each tensor read on demand."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        self.metadata: Dict[str, str] = header.pop("__metadata__", None) or {}
        self.header: Dict[str, dict] = header
        self._data_start = 8 + n

    def keys(self):
        return self.header.keys()

    def __contains__(self, name) -> bool:
        return name in self.header

    def get(self, name: str, device="cuda", dtype: Optional[torch.dtype] = None
            ) -> torch.Tensor:
        """Tensor ``name`` on ``device`` at ``dtype`` (its own by default)."""
        info = self.header[name]
        code = info["dtype"]
        if code not in DTYPES:
            raise ValueError(f"{self.path}: {name} has dtype {code}, which this reader "
                             f"does not take ({sorted(DTYPES)})")
        src, shape = DTYPES[code], tuple(info["shape"])
        b0, b1 = info["data_offsets"]
        numel = int(np.prod(shape, dtype=np.int64))
        if b1 - b0 != numel * src.itemsize:
            raise ValueError(f"{self.path}: {name} has {b1 - b0} bytes for shape {shape} "
                             f"of {code}")
        if numel == 0:
            return torch.empty(shape, dtype=dtype or src, device=device)
        start = self._data_start + b0
        base = start - start % mmap.ALLOCATIONGRANULARITY
        with open(self.path, "rb") as f:
            mm = mmap.mmap(f.fileno(), start - base + b1 - b0, offset=base,
                           access=mmap.ACCESS_COPY)
        try:
            mapped = torch.frombuffer(mm, dtype=src, count=numel, offset=start - base)
            out = mapped.reshape(shape).to(device=device, copy=True)
            del mapped
        finally:
            mm.close()
        return out if dtype is None or dtype == src else out.to(dtype)


class SafetensorsDir(Mapping):
    """Every ``*.safetensors`` under a directory (a sharded checkpoint), or
    one file, as a lazy mapping of tensor names.  ``state[name]`` reads a
    tensor to the CPU in its own dtype; ``state.get(name, device, dtype)``
    reads it straight to ``device``."""

    def __init__(self, path: str):
        files = ([path] if path.endswith(".safetensors")
                 else sorted(glob.glob(os.path.join(path, "*.safetensors"))))
        if not files:
            raise FileNotFoundError(f"no safetensors found at {path}")
        self.files = [SafetensorsFile(f) for f in files]
        self._where = {name: f for f in self.files for name in f.keys()}

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._where[name].get(name, device="cpu")

    def __iter__(self) -> Iterator[str]:
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)

    def __contains__(self, name) -> bool:
        return name in self._where

    def get(self, name: str, device="cuda", dtype: Optional[torch.dtype] = None):
        return self._where[name].get(name, device=device, dtype=dtype)

    def nbytes(self) -> int:
        return sum(os.path.getsize(f.path) for f in self.files)


def read_tensor(state: Mapping, name: str, device, dtype=None) -> torch.Tensor:
    """``state[name]`` on ``device`` at ``dtype``: straight from the file for
    a ``SafetensorsDir``, else from a dict of tensors or numpy arrays (a
    ``state_dict``)."""
    if isinstance(state, SafetensorsDir):
        return state.get(name, device=device, dtype=dtype)
    t = state[name]
    t = t if isinstance(t, torch.Tensor) else torch.from_numpy(np.asarray(t))
    return t.to(device=device, dtype=dtype or t.dtype)


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], (list, tuple)):
        return type(trees[0])(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def stack_blocks(n: int, block: Callable[[int], Any]):
    """Stack ``block(0) .. block(n - 1)`` (parameter trees of tensors) along a
    new leading depth axis: the stack is allocated from block 0's shapes and
    filled one block at a time, so only one block exists beside it."""
    first = block(0)
    out = _tree_map(lambda t: t.new_empty((n, *t.shape)), first)
    for i in range(n):
        b = first if i == 0 else block(i)
        _tree_map(lambda dst, src: dst[i].copy_(src), out, b)
        del b
    return out


def _as_tensor(x) -> torch.Tensor:
    return x.detach() if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


def save_file(tensors: Mapping[str, Any], path: str,
              metadata: Optional[Dict[str, Any]] = None,
              dtype: Optional[torch.dtype] = None) -> None:
    """Write ``tensors`` (torch tensors on any device, or numpy arrays) as
    one safetensors file, names in sorted order, the header padded with
    spaces so the data starts 8-byte aligned.  ``dtype`` casts every tensor
    as it is written, one at a time; metadata values are written as
    strings."""
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {k: str(v) for k, v in metadata.items()}
    names, offset = sorted(tensors), 0
    for name in names:
        t = _as_tensor(tensors[name])
        out = dtype or t.dtype
        if out not in _CODES:
            raise ValueError(f"{name}: dtype {out} has no safetensors code here")
        n = t.numel() * out.itemsize
        header[name] = {"dtype": _CODES[out], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(blob)))
        fh.write(blob)
        for name in names:
            t = _as_tensor(tensors[name])
            t = (t if dtype is None else t.to(dtype)).contiguous().cpu().reshape(-1)
            if t.numel():
                fh.write(t.view(torch.uint8).numpy().data)

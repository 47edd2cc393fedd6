"""ctypes bridge to the native cache reader (``csrc/cacheloader.cpp``).

Port of mixgrpo_tpu/data/native_loader.py over the port's own copy of the
C++ source.  Python parses each safetensors shard header once (offsets,
shapes); the library owns the hot path: mmap, madvise readahead, and a
batched f16 -> f32 row gather without numpy temporaries (f16 -> f32 is
exact, so its rows equal the numpy memmap reader's bit for bit).

There is no fallback.  JAX's build returns ``None`` when the compiler fails
and its dataset then reads through Python; here the build succeeds or raises
with the compiler's report, and ``NativeShardReader`` opens its shard or
raises.  The library is compiled at first use with ``g++ -O3 -march=native
-shared -fPIC`` into ``mixgrpo_tpu_torch/csrc/build/``, named by a hash of
the flags, the source and this CPU's model and flags (``-march=native``
binds the library to the CPU that built it).  It is written under a temporary name and moved into
place with ``os.replace``, so processes that build it at once never load a
half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import platform
import struct
import subprocess
import tempfile
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
SOURCE = os.path.join(CSRC, "cacheloader.cpp")
BUILD_DIR = os.path.join(CSRC, "build")
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _cpu_id() -> bytes:
    """This CPU's model name and feature flags (what ``-march=native`` reads)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return platform.machine().encode()
    return b"\n".join(sorted({ln for ln in lines if ln.startswith((b"model name", b"flags"))}))


def library_path() -> str:
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(_cpu_id())
    return os.path.join(BUILD_DIR, f"libcacheloader-{h.hexdigest()[:12]}.so")


def build_library() -> str:
    """The library's path, compiled first unless it exists; raises with the
    compiler's report when the build fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, "-o", tmp, SOURCE], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"native cache reader build failed: cannot run {CXX!r}: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"native cache reader build failed: {CXX} exited "
                           f"{proc.returncode}\n{proc.stdout}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The reader library, built and bound on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            lib.cl_open.restype = ctypes.c_void_p
            lib.cl_open.argtypes = [ctypes.c_char_p]
            lib.cl_close.restype = None
            lib.cl_close.argtypes = [ctypes.c_void_p]
            lib.cl_size.restype = ctypes.c_uint64
            lib.cl_size.argtypes = [ctypes.c_void_p]
            lib.cl_prefetch.restype = None
            lib.cl_prefetch.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64]
            lib.cl_read.restype = ctypes.c_int
            lib.cl_read.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
                                    ctypes.c_void_p]
            lib.cl_gather_f16_rows.restype = ctypes.c_int
            lib.cl_gather_f16_rows.argtypes = [
                ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
            ]
            _lib = lib
        return _lib


def parse_safetensors_header(path: str) -> Dict[str, dict]:
    """Tensor name -> {dtype, shape, start, end (absolute bytes)}."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        s, e = info["data_offsets"]
        out[name] = {"dtype": info["dtype"], "shape": tuple(info["shape"]),
                     "start": base + s, "end": base + e}
    return out


class NativeShardReader:
    """Zero-copy row reader over one safetensors shard (f16 tensors)."""

    def __init__(self, path: str):
        self._lib = load_library()
        self.tensors = parse_safetensors_header(path)
        self._h = self._lib.cl_open(path.encode())
        if not self._h:
            raise OSError(f"cl_open failed: {path}")
        size = self._lib.cl_size(self._h)
        for name, info in self.tensors.items():
            if info["end"] > size:
                self.close()
                raise ValueError(f"{path}: tensor {name} ends at byte {info['end']}, "
                                 f"past the file's {size}")

    def _row_layout(self, name: str) -> Tuple[int, int, int, int]:
        info = self.tensors[name]
        if info["dtype"] != "F16":
            raise TypeError(f"{name}: the native reader gathers F16 rows, not {info['dtype']}")
        shape = info["shape"]
        row_elems = int(np.prod(shape[1:]))
        return info["start"], row_elems * 2, row_elems, shape[0]

    def _rows(self, rows: Sequence[int], n: int) -> np.ndarray:
        rows_arr = np.ascontiguousarray(rows, np.int64)
        if rows_arr.size and (rows_arr.min() < 0 or rows_arr.max() >= n):
            raise IndexError(f"rows {rows_arr.tolist()} outside [0, {n})")
        return rows_arr

    def gather_rows(self, name: str, rows: Sequence[int]) -> np.ndarray:
        """Rows as float32, shape (len(rows), *tensor.shape[1:])."""
        start, stride, row_elems, n = self._row_layout(name)
        rows_arr = self._rows(rows, n)
        out = np.empty((len(rows_arr), row_elems), np.float32)
        rc = self._lib.cl_gather_f16_rows(
            self._h, start, stride, row_elems,
            rows_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(rows_arr),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise OSError(f"cl_gather_f16_rows({name}) returned {rc}")
        return out.reshape(len(rows_arr), *self.tensors[name]["shape"][1:])

    def prefetch_rows(self, name: str, rows: Sequence[int]) -> None:
        start, stride, _, n = self._row_layout(name)
        for r in self._rows(rows, n):
            self._lib.cl_prefetch(self._h, start + int(r) * stride, stride)

    def close(self):
        if self._h:
            self._lib.cl_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC timing
        if getattr(self, "_h", None):
            self.close()

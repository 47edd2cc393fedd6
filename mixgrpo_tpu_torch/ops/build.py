"""Build and load the port's hand-written CUDA kernels.

Each kernel library is one source ``mixgrpo_tpu_torch/csrc/<name>.cu`` with a
plain C interface (it may include the shared ``csrc/*.cuh`` headers).  At
first use it is compiled with ``nvcc`` for ``sm_90a`` into a shared library
under ``mixgrpo_tpu_torch/csrc/build/`` (named by a hash of the source and the
headers, so an edited file is rebuilt) and loaded with ``ctypes``.  ptxas's
report (registers, shared memory, spills and wgmma warnings per kernel) is
written beside the library as ``<library>.ptxas.txt`` and kept in ``reports``
once the library is loaded.  The JAX
package has no counterpart: XLA compiled its Pallas kernels.

Nothing here runs at import time: the CPU tests import every module, and a
machine without ``nvcc`` only fails when a kernel is actually asked for.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()  # guards _locks
_locks: Dict[str, threading.Lock] = {}  # one per library, so two libraries build at once
_loaded: Dict[str, ctypes.CDLL] = {}
reports: Dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def library_path(name: str) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(n for n in os.listdir(CSRC) if n.endswith(".cuh"))
    for path in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, path), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _compile(name: str, out: str) -> None:
    """nvcc the source into ``out``; on failure raise with nvcc's and
    ptxas's full report, on success write it beside ``out``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, os.path.join(CSRC, f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"kernel build failed: {name}: nvcc exited "
                           f"{proc.returncode}\n{proc.stdout}")
    with open(out + ".ptxas.txt", "w") as f:
        f.write(proc.stdout)
    os.replace(tmp, out)


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _loaded.get(name)
        if lib is None:
            out = library_path(name)
            if not os.path.exists(out):
                _compile(name, out)
            lib = ctypes.CDLL(out)
            _loaded[name] = lib
            if os.path.exists(out + ".ptxas.txt"):
                with open(out + ".ptxas.txt") as f:
                    reports[name] = f.read()
        return lib

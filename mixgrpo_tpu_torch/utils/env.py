"""Environment report.

Port of mixgrpo_tpu/utils/env.py: ``python -m mixgrpo_tpu_torch.utils.env``
prints the Python, platform, torch, CUDA, numpy and triton versions and the
CUDA cards this process sees.
"""

from __future__ import annotations

import importlib.metadata
import platform
import sys


def collect_env() -> dict:
    import torch

    info = {
        "python": sys.version.replace("\n", " "),
        "platform": platform.platform(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "not built with CUDA",
    }
    for pkg in ("numpy", "triton"):
        try:
            info[pkg] = importlib.metadata.version(pkg)
        except importlib.metadata.PackageNotFoundError:
            info[pkg] = "not installed"
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    info["device_count"] = n
    info["devices"] = [torch.cuda.get_device_name(i) for i in range(n)]
    return info


def main():
    for k, v in collect_env().items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()

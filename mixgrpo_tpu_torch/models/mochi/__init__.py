"""Mochi-1 text-to-video: the asymmetric DiT, its causal VAE decoder, the
loaders, the diffusers export and the CFG pipeline (mirrors
mixgrpo_tpu/models/mochi/)."""

from mixgrpo_tpu_torch.models.mochi.model import (
    MochiConfig,
    init_mochi,
    mochi_forward,
)

__all__ = ["MochiConfig", "init_mochi", "mochi_forward"]

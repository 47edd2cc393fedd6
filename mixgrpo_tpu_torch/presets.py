"""Model-geometry presets for the FLUX app stack.

Port of mixgrpo_tpu/presets.py.  ``MIXGRPO_MODEL_PRESET`` (or the ``preset``
argument) selects ``flux-dev`` (default: the released FLUX.1-dev geometry,
12B DiT, T5-XXL, CLIP-L) or ``tiny`` (a mutually consistent reduced geometry
with the same file formats and loader paths, which
``scripts/make_rehearsal_ckpts.py`` writes checkpoints for).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from mixgrpo_tpu_torch.models.flux.model import FluxConfig
from mixgrpo_tpu_torch.models.flux.vae import VAEConfig
from mixgrpo_tpu_torch.models.text.clip import CLIPConfig, CLIPTowerConfig
from mixgrpo_tpu_torch.models.text.t5 import T5Config


def flux_family(preset: Optional[str] = None) -> Dict[str, object]:
    """Returns ``{"flux", "vae", "t5", "clip"}`` config objects.  In both
    presets ``t5.d_model == flux.context_dim``, ``clip.text.width ==
    flux.pooled_dim`` and ``vae.latent_channels == flux.in_channels // 4``
    (2x2 latent packing); the tiny CLIP text vocab covers the CLIP BPE id
    range of a small merges table (512 byte tokens + merges + 2 specials)."""
    name = preset or os.environ.get("MIXGRPO_MODEL_PRESET", "flux-dev")
    if name == "flux-dev":
        return {"flux": FluxConfig.flux_dev(), "vae": VAEConfig.flux_dev(),
                "t5": T5Config.xxl(), "clip": CLIPConfig.vit_l_14()}
    if name == "tiny":
        flux = FluxConfig.tiny(context_dim=32, pooled_dim=32)
        return {
            "flux": flux,
            "vae": VAEConfig.tiny(latent_channels=flux.in_channels // 4),
            "t5": T5Config.tiny(),  # d_model=32 == flux.context_dim
            "clip": CLIPConfig(
                embed_dim=16,
                vision=CLIPTowerConfig(width=32, layers=2, heads=2, patch=8, image_size=64),
                text=CLIPTowerConfig(width=32, layers=2, heads=2, vocab=640, context=77),
                quick_gelu=True,
            ),
        }
    raise ValueError(f"unknown MIXGRPO_MODEL_PRESET {name!r} (flux-dev | tiny)")

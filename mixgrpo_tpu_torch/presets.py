"""Model-geometry presets for the FLUX app stack.

Port of mixgrpo_tpu/presets.py.  ``MIXGRPO_MODEL_PRESET`` (or the ``preset``
argument) selects ``flux-dev`` (default, the released FLUX.1-dev geometry)
or ``tiny`` (a mutually consistent reduced geometry).  Only the ``"flux"`` and
``"vae"`` entries exist so far; ``"t5"`` and ``"clip"`` wait for the port of
the text encoders.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from mixgrpo_tpu_torch.models.flux.model import FluxConfig
from mixgrpo_tpu_torch.models.flux.vae import VAEConfig


def flux_family(preset: Optional[str] = None) -> Dict[str, object]:
    """Returns ``{"flux", "vae"}`` config objects; in both presets
    ``vae.latent_channels == flux.in_channels // 4`` (2x2 latent packing)."""
    name = preset or os.environ.get("MIXGRPO_MODEL_PRESET", "flux-dev")
    if name == "flux-dev":
        return {"flux": FluxConfig.flux_dev(), "vae": VAEConfig.flux_dev()}
    if name == "tiny":
        flux = FluxConfig.tiny(context_dim=32, pooled_dim=32)
        return {"flux": flux,
                "vae": VAEConfig.tiny(latent_channels=flux.in_channels // 4)}
    raise ValueError(f"unknown MIXGRPO_MODEL_PRESET {name!r} (flux-dev | tiny)")

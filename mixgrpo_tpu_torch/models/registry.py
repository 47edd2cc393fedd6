"""Model loader registry.

Port of mixgrpo_tpu/models/registry.py: a model_type string maps to (config
factory, init fn, forward fn, checkpoint loader), so apps stay
model-agnostic.  FLUX, HunyuanVideo and Mochi are registered as in JAX:
Mochi's entry has no checkpoint loader (``models/mochi/load.py`` loads a
diffusers directory), and ``load_vae("mochi")`` raises, as JAX's does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional


class ModelEntry(NamedTuple):
    config: Callable[[], Any]
    init: Callable
    forward: Callable
    load: Optional[Callable] = None


def _flux_entry() -> ModelEntry:
    from mixgrpo_tpu_torch.models.flux.load import load_flux_params
    from mixgrpo_tpu_torch.models.flux.model import FluxConfig, flux_forward, init_flux

    return ModelEntry(FluxConfig.flux_dev, init_flux, flux_forward, load_flux_params)


def _hunyuan_entry() -> ModelEntry:
    from mixgrpo_tpu_torch.models.hunyuan.load import load_hunyuan_video
    from mixgrpo_tpu_torch.models.hunyuan.model import (
        HunyuanVideoConfig, hunyuan_video_forward, init_hunyuan_video,
    )

    return ModelEntry(HunyuanVideoConfig.hunyuan_video, init_hunyuan_video,
                      hunyuan_video_forward, load_hunyuan_video)


def _mochi_entry() -> ModelEntry:
    from mixgrpo_tpu_torch.models.mochi.model import MochiConfig, init_mochi, mochi_forward

    return ModelEntry(MochiConfig.mochi_preview, init_mochi, mochi_forward)


_REGISTRY: Dict[str, Callable[[], ModelEntry]] = {
    "flux": _flux_entry,
    "hunyuan_video": _hunyuan_entry,
    "mochi": _mochi_entry,
}


def available_models():
    return sorted(_REGISTRY)


def get_model(model_type: str) -> ModelEntry:
    if model_type not in _REGISTRY:
        raise ValueError(f"unknown model_type {model_type!r}; available: {available_models()}")
    return _REGISTRY[model_type]()


def load_vae(model_type: str) -> ModelEntry:
    """VAE (decoder) entry per model family."""
    if model_type == "flux":
        from mixgrpo_tpu_torch.models.flux.load import load_vae_decoder_params
        from mixgrpo_tpu_torch.models.flux.vae import VAEConfig, init_vae_decoder, vae_decode

        return ModelEntry(VAEConfig.flux_dev, init_vae_decoder, vae_decode,
                          load_vae_decoder_params)
    if model_type == "hunyuan_video":
        from mixgrpo_tpu_torch.models.hunyuan.vae3d import (
            CausalVAEConfig, causal_vae_decode, init_causal_vae_decoder, load_causal_vae_decoder,
        )

        return ModelEntry(CausalVAEConfig.hunyuan_video, init_causal_vae_decoder,
                          causal_vae_decode, load_causal_vae_decoder)
    raise ValueError(f"no VAE registered for {model_type!r}")

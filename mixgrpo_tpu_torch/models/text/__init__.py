from mixgrpo_tpu_torch.models.text.clip import (
    CLIPConfig,
    CLIPTowerConfig,
    clip_image_features,
    clip_text_features,
    init_clip,
)

__all__ = [
    "CLIPConfig",
    "CLIPTowerConfig",
    "init_clip",
    "clip_image_features",
    "clip_text_features",
]

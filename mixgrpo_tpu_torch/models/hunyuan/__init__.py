"""HunyuanVideo text-to-video: MMDiT with token refiner, causal 3D VAE, text
encoders, pipeline and sampler (mirrors mixgrpo_tpu/models/hunyuan/)."""

from mixgrpo_tpu_torch.models.hunyuan.load import (
    convert_hunyuan_state_dict,
    export_hunyuan_state_dict,
    infer_hunyuan_config,
    load_hunyuan_video,
)
from mixgrpo_tpu_torch.models.hunyuan.model import (
    HunyuanVideoConfig,
    hunyuan_video_forward,
    init_hunyuan_video,
    make_video_ids,
)
from mixgrpo_tpu_torch.models.hunyuan.sampler import HunyuanVideoSampler
from mixgrpo_tpu_torch.models.hunyuan.scheduler import FlowMatchDiscreteScheduler

__all__ = [
    "HunyuanVideoConfig",
    "init_hunyuan_video",
    "hunyuan_video_forward",
    "make_video_ids",
    "convert_hunyuan_state_dict",
    "export_hunyuan_state_dict",
    "infer_hunyuan_config",
    "load_hunyuan_video",
    "FlowMatchDiscreteScheduler",
    "HunyuanVideoSampler",
]

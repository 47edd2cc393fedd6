"""Video preprocessing transforms (the legacy video-dataset path).

Port of mixgrpo_tpu/data/video.py (compact counterparts of the reference's
fastvideo/dataset/transform.py: temporal frame sampling, aspect-preserving
resize + center crop, [-1, 1] normalization, stride-aligned padded
batching).  Arrays are (T, H, W, C) numpy, float in [0, 1] or uint8, on
the host.  ``center_crop_resize`` replaces ``jax.image.resize(...,
"cubic")`` by ``F.interpolate(mode="bicubic", antialias=True)``: both are
the Keys cubic (a = -0.5) with its weights renormalized at the borders and,
downscaling, stretched by the scale (tests hold them within 2e-4 on the
0-255 scale, down and up).
"""

from __future__ import annotations

import numpy as np


def temporal_sample(num_frames_total: int, num_frames: int, stride: int = 1,
                    rng: np.random.Generator | None = None):
    """Random clip of ``num_frames`` at ``stride`` (TemporalRandomCrop)."""
    span = (num_frames - 1) * stride + 1
    if num_frames_total < span:
        raise ValueError(f"video too short: {num_frames_total} < {span}")
    start = 0
    if rng is not None and num_frames_total > span:
        start = int(rng.integers(0, num_frames_total - span + 1))
    return np.arange(start, start + span, stride)


def center_crop_resize(video: np.ndarray, height: int, width: int) -> np.ndarray:
    """Resize so the target fits, then center crop (CenterCropResizeVideo);
    returns float32 (uint8 input is resized as float, as JAX resizes it)."""
    import torch
    import torch.nn.functional as F

    t, h, w, c = video.shape
    scale = max(height / h, width / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    x = torch.from_numpy(np.asarray(video, np.float32)).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(nh, nw), mode="bicubic", antialias=True, align_corners=False)
    top, left = (nh - height) // 2, (nw - width) // 2
    return x.permute(0, 2, 3, 1)[:, top : top + height, left : left + width, :].numpy()


def normalize_video(video: np.ndarray) -> np.ndarray:
    """[0, 1] -> [-1, 1] (transform.py NormalizeVideo)."""
    return video * 2.0 - 1.0


def pad_to_multiple(n: int, stride: int) -> int:
    """Next multiple of ``stride`` (dataset_utils.py:43-50)."""
    r = n % stride
    return n if r == 0 else n + stride - r


class VideoCollate:
    """Stride-aligned padded video batching with latent attention masks.

    Counterpart of the legacy video ``Collate``
    (fastvideo/utils/dataset_utils.py:53-194): pads each (T, H, W, C) clip
    so that T-1 is a multiple of the causal-VAE temporal stride x temporal
    patch (T itself padded as t-1+ae_stride_t to the stride, then -1
    +ae_stride_t inverted — causal 3D VAEs map T frames to (T-1)/s+1
    latents) and H/W to ae_stride*patch_size, stacks input_ids/cond_mask,
    and builds a (B, lt, lh, lw) attention mask marking the valid latent
    region of each clip.  Padding to a fixed grid gives one shape per bucket.
    """

    def __init__(self, ae_stride: int = 8, ae_stride_t: int = 4,
                 patch_size: int = 2, patch_size_t: int = 1):
        self.ae_stride, self.ae_stride_t = ae_stride, ae_stride_t
        self.ds = ae_stride * patch_size
        self.t_ds = ae_stride_t * patch_size_t

    def __call__(self, batch):
        import math

        tubes = [np.asarray(b["pixel_values"]) for b in batch]  # (T,H,W,C)
        max_t = max(x.shape[0] for x in tubes)
        max_h = max(x.shape[1] for x in tubes)
        max_w = max(x.shape[2] for x in tubes)
        pad_t = pad_to_multiple(max_t - 1 + self.ae_stride_t, self.t_ds)
        pad_t = pad_t + 1 - self.ae_stride_t
        pad_h = pad_to_multiple(max_h, self.ds)
        pad_w = pad_to_multiple(max_w, self.ds)

        out = np.zeros((len(tubes), pad_t, pad_h, pad_w, tubes[0].shape[-1]),
                       np.float32)
        lt = (pad_t - 1) // self.ae_stride_t + 1
        lh, lw = pad_h // self.ae_stride, pad_w // self.ae_stride
        mask = np.zeros((len(tubes), lt, lh, lw), np.float32)
        for i, x in enumerate(tubes):
            t, h, w = x.shape[:3]
            out[i, :t, :h, :w] = x
            vt = int(math.ceil((t - 1) / self.ae_stride_t)) + 1
            vh = int(math.ceil(h / self.ae_stride))
            vw = int(math.ceil(w / self.ae_stride))
            mask[i, :vt, :vh, :vw] = 1.0

        result = {"pixel_values": out, "attention_mask": mask,
                  "text": [b["text"] for b in batch]}
        if "input_ids" in batch[0]:
            result["input_ids"] = np.stack([b["input_ids"] for b in batch])
            result["cond_mask"] = np.stack([b["cond_mask"] for b in batch])
        return result

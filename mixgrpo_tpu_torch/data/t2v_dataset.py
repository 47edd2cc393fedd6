"""T2V video/image training dataset (the legacy video-zoo data path).

Port of mixgrpo_tpu/data/t2v_dataset.py (host-side, copied with the port's
own ``video`` and ``video_io``): the same ``random.Random(seed)`` draws in
JAX's call order, so one seed selects the same frames and drops the same
captions.  As JAX's, it rebuilds the reference's
fastvideo/dataset/t2v_datasets.py:80-351: a merge file lists (folder, annotation.json) pairs; each annotation entry
carries path/cap/fps/duration/resolution.  ``define_frame_index``
pre-filters entries (caption present, aspect-ratio window around the
training aspect, length tolerance) and resamples high-fps videos to
``train_fps`` with random temporal cropping of long clips — identical
selection math to the reference (:240-326).  Items decode through
:mod:`video_io` (the decord replacement), apply center-crop-resize +
[-1, 1] normalization (data/video.py), and drop captions at ``cfg_rate``
for classifier-free guidance training.

Tokenization is delegated to an optional ``tokenize_fn(texts) ->
(ids, mask)`` so T5/CLIP/LLM tokenizers stay upstream assets, matching
the rest of the data layer.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import random
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from mixgrpo_tpu_torch.data.video import (
    center_crop_resize, normalize_video, temporal_sample,
)
from mixgrpo_tpu_torch.data.video_io import read_video_frames


def filter_resolution(h, w, max_h_div_w_ratio, min_h_div_w_ratio) -> bool:
    """Aspect window check (t2v_datasets.py:73-78)."""
    return min_h_div_w_ratio <= h / w <= max_h_div_w_ratio


def read_merge_file(path: str) -> List[Dict[str, Any]]:
    """merge file: lines of "folder,annotation.json"; annotation entries
    get their paths joined onto the folder (t2v_datasets.py:336-348)."""
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        pairs = [ln.strip().split(",") for ln in f if ln.strip()]
    for folder, anno in pairs:
        with open(anno) as f:
            subs = json.load(f)
        for e in subs:
            e["path"] = os.path.join(folder, e["path"])
        out += subs
    return out


@dataclasses.dataclass
class T2VDataset:
    data_merge_path: str
    num_frames: int = 16
    train_fps: float = 24.0
    max_height: int = 480
    max_width: int = 848
    cfg_rate: float = 0.1
    speed_factor: float = 1.0
    video_length_tolerance_range: float = 2.0
    drop_short_ratio: float = 1.0
    text_max_length: int = 256
    tokenize_fn: Optional[Callable] = None
    seed: int = 0

    def __post_init__(self):
        assert self.speed_factor >= 1
        self._rng = random.Random(self.seed)
        cap_list = read_merge_file(self.data_merge_path)
        assert cap_list, self.data_merge_path
        self.cap_list, self.sample_num_frames = self.define_frame_index(
            cap_list
        )
        self.lengths = self.sample_num_frames  # LengthGroupedSampler input

    # -- filtering / frame selection (t2v_datasets.py:226-326) -------------

    def define_frame_index(self, cap_list):
        keep, sample_num_frames = [], []
        stats = {"no_cap": 0, "too_long": 0, "too_short": 0,
                 "no_resolution": 0, "resolution_mismatch": 0}
        aspect = self.max_height / self.max_width
        thr = 1.5
        for e in cap_list:
            path = e["path"]
            if e.get("cap") is None:
                stats["no_cap"] += 1
                continue
            if path.endswith(".mp4"):
                fps, duration = e.get("fps"), e.get("duration")
                if fps is None or duration is None:
                    continue
                res = e.get("resolution") or {}
                if res.get("height") is None or res.get("width") is None:
                    stats["no_resolution"] += 1
                    continue
                if not filter_resolution(
                    res["height"], res["width"],
                    max_h_div_w_ratio=thr * aspect,
                    min_h_div_w_ratio=aspect / thr,
                ):
                    stats["resolution_mismatch"] += 1
                    continue
                e["num_frames"] = math.ceil(fps * duration)
                if e["num_frames"] / fps > self.video_length_tolerance_range * (
                    self.num_frames / self.train_fps * self.speed_factor
                ):
                    stats["too_long"] += 1
                    continue
                # resample high fps down to train_fps
                interval = fps / self.train_fps
                idx = np.arange(0, e["num_frames"], interval).astype(int)
                if (len(idx) < self.num_frames
                        and self._rng.random() < self.drop_short_ratio):
                    stats["too_short"] += 1
                    continue
                if len(idx) > self.num_frames:
                    sel = temporal_sample(
                        len(idx), self.num_frames,
                        rng=np.random.default_rng(self._rng.getrandbits(32)),
                    )
                    idx = idx[sel]
                e["sample_frame_index"] = idx.tolist()
                e["sample_num_frames"] = len(idx)
                keep.append(e)
                sample_num_frames.append(len(idx))
            elif path.endswith((".jpg", ".jpeg", ".png")):
                e["sample_num_frames"] = 1
                keep.append(e)
                sample_num_frames.append(1)
            else:
                raise NameError(
                    f"Unknown file extension {path!r}: only .mp4 video and"
                    " .jpg/.png images are supported"
                )
        return keep, sample_num_frames

    # -- items --------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.cap_list)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        e = self.cap_list[idx]
        if e["path"].endswith(".mp4"):
            frames = read_video_frames(e["path"], e["sample_frame_index"])
        else:
            from PIL import Image

            frames = np.asarray(Image.open(e["path"]).convert("RGB"))[None]
        frames = center_crop_resize(frames, self.max_height, self.max_width)
        # uint8 [0, 255] -> [0, 1] (clip cubic-resize overshoot) -> [-1, 1]
        frames = np.clip(frames.astype(np.float32) / 255.0, 0.0, 1.0)
        pixel_values = normalize_video(frames)  # (T, H, W, 3) in [-1, 1]

        caps = e["cap"] if isinstance(e["cap"], list) else [e["cap"]]
        text = self._rng.choice(caps)
        if self._rng.random() < self.cfg_rate:
            text = ""
        item: Dict[str, Any] = {
            "pixel_values": pixel_values,
            "text": text,
            "path": e["path"],
        }
        if self.tokenize_fn is not None:
            ids, mask = self.tokenize_fn([text], self.text_max_length)
            item["input_ids"], item["cond_mask"] = ids[0], mask[0]
        return item

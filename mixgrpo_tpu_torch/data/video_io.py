"""Video file IO: the decord-equivalent frame reader.

Port of mixgrpo_tpu/data/video_io.py, copied as is (host numpy; the port
keeps its own copy).  The reference reads training videos through the
decord C++ library (fastvideo/utils/dataset_utils.py:10 ``DecordInit``,
fastvideo/dataset/t2v_datasets.py:327-334 ``decord_read``) or
torchvision.io (t2v_datasets.py:141-143).  This module gives the same
contract (a metadata probe and an indexed batch frame fetch) over OpenCV's
VideoCapture, in JAX's order: OpenCV first, then imageio.  Neither is a
dependency of the port: the card's machine has neither, so this layer is
checked on the CPU only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class VideoMeta:
    num_frames: int
    fps: float
    height: int
    width: int

    @property
    def duration(self) -> float:
        return self.num_frames / self.fps if self.fps > 0 else 0.0


def _cv2():
    try:
        import cv2

        return cv2
    except Exception:
        return None


def video_metadata(path: str) -> VideoMeta:
    """Probe (num_frames, fps, h, w) without decoding frames."""
    cv2 = _cv2()
    if cv2 is not None:
        cap = cv2.VideoCapture(path)
        try:
            if cap.isOpened():
                n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
                fps = float(cap.get(cv2.CAP_PROP_FPS)) or 0.0
                h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
                w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
                if n > 0:
                    return VideoMeta(n, fps, h, w)
        finally:
            cap.release()
    import imageio.v3 as iio

    frames = iio.imread(path)  # (T, H, W, C) — fallback decodes fully
    return VideoMeta(frames.shape[0], 0.0, frames.shape[1], frames.shape[2])


def read_video_frames(
    path: str, frame_indices: Optional[Sequence[int]] = None
) -> np.ndarray:
    """Fetch frames by index -> (T, H, W, 3) uint8 RGB.

    ``frame_indices=None`` reads the whole video.  Matches decord's
    ``get_batch(frame_indices)`` contract (t2v_datasets.py:327-334).
    """
    cv2 = _cv2()
    if cv2 is not None:
        cap = cv2.VideoCapture(path)
        try:
            if cap.isOpened():
                out = []
                if frame_indices is None:
                    while True:
                        ok, frame = cap.read()
                        if not ok:
                            break
                        out.append(frame[..., ::-1])  # BGR -> RGB
                else:
                    # sequential decode with skip: videos are inter-coded,
                    # so monotonically increasing indices (the training
                    # access pattern) decode in one pass without seeks
                    want = list(int(i) for i in frame_indices)
                    assert all(b >= a for a, b in zip(want, want[1:])), (
                        "frame_indices must be non-decreasing"
                    )
                    pos = 0
                    for target in want:
                        if target < pos:  # repeated index
                            out.append(out[-1])
                            continue
                        while pos <= target:
                            ok, frame = cap.read()
                            if not ok:
                                raise EOFError(
                                    f"{path}: frame {target} past end"
                                )
                            pos += 1
                        out.append(frame[..., ::-1])
                if out:
                    return np.ascontiguousarray(np.stack(out))
        finally:
            cap.release()
    import imageio.v3 as iio

    frames = np.asarray(iio.imread(path))
    if frames.ndim == 3:
        frames = frames[None]
    if frame_indices is not None:
        frames = frames[np.asarray(frame_indices, int)]
    return frames

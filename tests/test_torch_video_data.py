"""The port's video data layer (``data/video.py``, ``data/video_io.py``,
``data/t2v_dataset.py``) against the JAX package on the same inputs.

- ``temporal_sample``, ``normalize_video``, ``pad_to_multiple`` and
  ``VideoCollate``: equal.
- ``center_crop_resize`` (torch's antialiased bicubic in place of
  ``jax.image.resize(..., "cubic")``): downscaling, upscaling, one axis of
  each and the identity, on [0, 1] floats (atol 1e-6) and uint8 frames
  (atol 2e-4 on the 0-255 scale).
- ``video_io`` on mp4 files written here with OpenCV: the metadata and the
  frames, all and by index (repeated indices too), equal to JAX's; the
  imageio fallback on a GIF, with OpenCV hidden from both packages: equal.
- ``T2VDataset`` with one seed: the same entries kept, the same frames
  selected, the same captions dropped, items equal within the resize's
  tolerance.
"""

import json
import os
from dataclasses import astuple

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as conftest sets it)
import numpy as np
import pytest

from mixgrpo_tpu.data import t2v_dataset as JD
from mixgrpo_tpu.data import video as JVid
from mixgrpo_tpu.data import video_io as JIO
from mixgrpo_tpu_torch.data import t2v_dataset as D
from mixgrpo_tpu_torch.data import video as Vid
from mixgrpo_tpu_torch.data import video_io as IO

cv2 = pytest.importorskip("cv2")


def test_sampling_normalize_and_collate_match_jax():
    for total, n, stride, seed in ((100, 16, 2, 0), (31, 16, 2, 1), (16, 16, 1, 2)):
        np.testing.assert_array_equal(
            Vid.temporal_sample(total, n, stride, rng=np.random.default_rng(seed)),
            JVid.temporal_sample(total, n, stride, rng=np.random.default_rng(seed)))
    np.testing.assert_array_equal(Vid.temporal_sample(40, 8), JVid.temporal_sample(40, 8))
    with pytest.raises(ValueError, match="too short"):
        Vid.temporal_sample(10, 16, stride=2)
    v = np.asarray([0.0, 0.5, 1.0], np.float32)
    np.testing.assert_array_equal(Vid.normalize_video(v), JVid.normalize_video(v))
    for n, s in ((16, 16), (17, 16), (1, 4)):
        assert Vid.pad_to_multiple(n, s) == JVid.pad_to_multiple(n, s)
    rng = np.random.default_rng(0)
    batch = [{"pixel_values": rng.uniform(size=(5, 32, 48, 3)).astype(np.float32), "text": "a",
              "input_ids": np.arange(4), "cond_mask": np.ones(4)},
             {"pixel_values": rng.uniform(size=(9, 30, 30, 3)).astype(np.float32), "text": "b",
              "input_ids": np.arange(4) + 1, "cond_mask": np.ones(4)}]
    got = Vid.VideoCollate(ae_stride=8, ae_stride_t=4, patch_size=2)(batch)
    want = JVid.VideoCollate(ae_stride=8, ae_stride_t=4, patch_size=2)(batch)
    assert sorted(got) == sorted(want)
    assert got["pixel_values"].shape == (2, 9, 32, 48, 3)
    assert got["attention_mask"].shape == (2, 3, 4, 6)
    for k in ("pixel_values", "attention_mask", "input_ids", "cond_mask"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["text"] == want["text"]


@pytest.mark.parametrize("shape, h, w", [((3, 100, 60, 3), 48, 48), ((2, 10, 12, 3), 32, 40),
                                         ((2, 40, 20, 3), 24, 48), ((1, 16, 24, 3), 16, 24)],
                         ids=["down", "up", "down_and_up", "identity"])
def test_center_crop_resize_matches_jax(shape, h, w):
    rng = np.random.default_rng(1)
    v = rng.uniform(size=shape).astype(np.float32)
    got = Vid.center_crop_resize(v, h, w)
    want = np.asarray(JVid.center_crop_resize(v, h, w))
    assert got.shape == want.shape == (shape[0], h, w, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    u8 = rng.integers(0, 256, size=shape).astype(np.uint8)
    np.testing.assert_allclose(Vid.center_crop_resize(u8, h, w),
                               np.asarray(JVid.center_crop_resize(u8, h, w)), rtol=0, atol=2e-4)


def _write_video(path, n_frames=24, h=64, w=96, fps=24):
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    assert vw.isOpened()
    for t in range(n_frames):
        frame = np.zeros((h, w, 3), np.uint8)
        frame[:, :, 0] = min(t * 10, 255)  # the frame index in blue (BGR)
        frame[: h // 2] += 40
        vw.write(frame)
    vw.release()
    return str(path)


def test_video_io_matches_jax(tmp_path, monkeypatch):
    p = _write_video(tmp_path / "v.mp4")
    meta = IO.video_metadata(p)
    assert astuple(meta) == astuple(JIO.video_metadata(p))
    assert (meta.num_frames, meta.height, meta.width) == (24, 64, 96) and abs(meta.fps - 24) < 1
    assert meta.duration == pytest.approx(24 / meta.fps)
    for idx in (None, [0, 5, 10, 23], [2, 2, 7]):
        got = IO.read_video_frames(p, idx)
        np.testing.assert_array_equal(got, JIO.read_video_frames(p, idx))
    frames = IO.read_video_frames(p, [0, 5, 10, 23])
    assert frames.shape == (4, 64, 96, 3)
    blues = frames[:, 40, 40, 2].astype(int)  # RGB out: blue rises with the index
    assert blues[0] < blues[1] < blues[2]
    with pytest.raises(EOFError):
        IO.read_video_frames(p, [30])
    # the imageio fallback (a GIF, which imageio reads without a plugin)
    import imageio.v3 as iio

    gif = str(tmp_path / "g.gif")
    iio.imwrite(gif, np.stack([np.full((16, 24, 3), 40 * t, np.uint8) for t in range(4)]))
    monkeypatch.setattr(IO, "_cv2", lambda: None)
    monkeypatch.setattr(JIO, "_cv2", lambda: None)
    assert astuple(IO.video_metadata(gif)) == astuple(JIO.video_metadata(gif))
    assert IO.video_metadata(gif).num_frames == 4
    for idx in (None, [1, 3]):
        np.testing.assert_array_equal(IO.read_video_frames(gif, idx),
                                      JIO.read_video_frames(gif, idx))
    assert IO.read_video_frames(gif, [1, 3])[:, 0, 0, 0].tolist() == [40, 120]


def _merge_file(tmp_path):
    """Annotations over mp4s, a PNG and entries the filter drops (no caption,
    too long, a wrong aspect, too short), each kind more than once so the
    seeded draws matter."""
    from PIL import Image

    anno = []
    res = {"height": 64, "width": 96}
    for i, (n, extra) in enumerate([(24, {}), (40, {}), (12, {}), (6, {}), (30, {}),
                                    (24, {"cap": None}), (24, {"duration": 100.0}),
                                    (24, {"resolution": {"height": 640, "width": 96}})]):
        name = f"v{i}.mp4"
        _write_video(tmp_path / name, n_frames=n)
        e = {"path": name, "cap": [f"clip {i}", f"video {i}"], "fps": 24, "duration": n / 24,
             "resolution": res}
        e.update(extra)
        anno.append(e)
    Image.fromarray(np.full((64, 96, 3), 128, np.uint8)).save(tmp_path / "img.png")
    anno.append({"path": "img.png", "cap": "an image"})
    anno_file = tmp_path / "anno.json"
    anno_file.write_text(json.dumps(anno))
    merge = tmp_path / "merge.txt"
    merge.write_text(f"{tmp_path},{anno_file}\n")
    return str(merge)


def test_t2v_dataset_matches_jax(tmp_path):
    merge = _merge_file(tmp_path)

    def tok(texts, max_len):
        ids = np.zeros((len(texts), max_len), np.int32)
        ids[:, 0] = len(texts[0])
        return ids, np.ones_like(ids)

    kw = dict(num_frames=8, train_fps=12, max_height=32, max_width=48, cfg_rate=0.5,
              video_length_tolerance_range=3.0, drop_short_ratio=0.5, tokenize_fn=tok,
              text_max_length=16)
    texts, kept = [], set()
    for seed in (1, 4):
        got, want = D.T2VDataset(merge, seed=seed, **kw), JD.T2VDataset(merge, seed=seed, **kw)
        assert len(got) == len(want) >= 4
        kept.add(len(got))
        assert got.lengths == want.lengths
        assert [e["path"] for e in got.cap_list] == [e["path"] for e in want.cap_list]
        assert [e.get("sample_frame_index") for e in got.cap_list] == [
            e.get("sample_frame_index") for e in want.cap_list]
        for i in list(range(len(got))) * 2:
            a, b = got[i], want[i]
            assert sorted(a) == sorted(b)
            assert (a["text"], a["path"]) == (b["text"], b["path"])
            texts.append(a["text"])
            np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
            assert a["pixel_values"].shape == b["pixel_values"].shape
            assert -1 <= a["pixel_values"].min() and a["pixel_values"].max() <= 1
            np.testing.assert_allclose(a["pixel_values"], b["pixel_values"], rtol=0, atol=2e-6)
    # the draws mattered: captions dropped and kept, a short clip kept by one seed only
    assert "" in texts and any(texts) and len(kept) == 2
    with pytest.raises(NameError, match="extension"):
        bad = tmp_path / "bad.json"
        bad.write_text(json.dumps([{"path": "x.avi", "cap": "c"}]))
        m = tmp_path / "bad_merge.txt"
        m.write_text(f"{tmp_path},{bad}\n")
        D.T2VDataset(str(m))
    assert os.path.exists(merge)

"""The readers of the program's span record (``benchlib/spans.py`` and the
metrics that use it) on a record made by hand, on none, and on the record
that the program itself makes of a tiny cell's unit under a profiler on
the CPU."""

import pytest
import torch

import conftest
from benchlib.discover import Cell
from mixgrpo_tpu_torch.utils import profiling

TRAIN, VIDEO = "flux1-dev.grpo-flash-lora", "hunyuan-video.t2v-192x336x129"


def _e(device_s, count=1, timed=None):
    """A path's entry; ``timed`` below ``count``: a DiT call's sampled spans."""
    timed = count if timed is None else timed
    return {"count": count, "timed": timed, "host_s": 0.0,
            **({"device_s": device_s} if timed else {})}


TRAIN_RECORD = {
    "iteration": _e(20.0),
    "iteration/rollout": _e(9.0),
    "iteration/rollout/merge": _e(0.25),
    "iteration/rollout/chunk": _e(8.4, 6),
    "iteration/rollout/chunk/dit": _e(1.2, 66, 9),
    "iteration/rollout/chunk/dit/gemm": _e(0.45, 9 * 300),
    "iteration/rollout/chunk/dit/attn": _e(0.15, 9 * 57),
    "iteration/rollout/chunk/dit/norm_mod": _e(0.3, 9 * 50),
    "iteration/update": _e(10.0),
    "iteration/update/group": _e(10.0, 4),
    "iteration/update/group/merge": _e(0.5, 4),
    "iteration/update/group/dit": _e(None, 4, 0),
    "iteration/update/group/dit/merge": _e(0.5, 116),
    "iteration/update/group/backward": _e(6.0, 4),
    "iteration/update/group/backward/merge": _e(0.75, 116),
    "iteration/update/group/optim": _e(0.5, 4),
}
VIDEO_RECORD = {
    "video": _e(16.0),
    "video/denoise": _e(13.5),
    "video/denoise/dit": _e(1.82, 50, 7),
    "video/denoise/dit/gemm": _e(0.7, 7 * 400),
    "video/denoise/dit/attn": _e(0.392, 7 * 60),
    "video/decode": _e(2.5),
    "video/decode/tile": _e(2.4, 8),
    "video/decode/tile/norm": _e(1.0, 8 * 30),
}
WANT = {
    "dit_call_ms.train": (TRAIN_RECORD, 1e3 * 1.2 / 9),
    "dit_pointwise_share.train": (TRAIN_RECORD, 100 * (1.2 - 0.45 - 0.15) / 1.2),
    "lora_merge_s.train": (TRAIN_RECORD, 0.25 + 0.5 + 0.5 + 0.75),
    "backward_s.train": (TRAIN_RECORD, 6.0),
    "dit_call_ms.video": (VIDEO_RECORD, 1e3 * 1.82 / 7),
    "dit_pointwise_share.video": (VIDEO_RECORD, 100 * (1.82 - 0.7 - 0.392) / 1.82),
    "decode_norm_share.video": (VIDEO_RECORD, 100 * 1.0 / 2.5),
}


def _reader(name):
    return Cell(TRAIN if name.endswith(".train") else VIDEO).reader(name)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_record(name, monkeypatch):
    rec, want = WANT[name]
    monkeypatch.setattr(profiling, "last_unit", lambda: rec)
    assert _reader(name)({}) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", sorted(WANT))
@pytest.mark.parametrize("record", ["absent", "none", "empty", "other_unit"])
def test_reader_without_a_record_reads_none(name, record, monkeypatch):
    if record == "absent":  # a program older than its spans
        monkeypatch.delattr(profiling, "last_unit")
    else:
        other = VIDEO_RECORD if name.endswith(".train") else TRAIN_RECORD
        rec = {"none": None, "empty": {}, "other_unit": other}[record]
        monkeypatch.setattr(profiling, "last_unit", lambda: rec)
    assert _reader(name)({}) is None


def test_trainer_host_s_reads_the_windows_host_time():
    read = _reader("trainer_host_s.train")
    assert read({"units": [{"metrics": {"host_time": 0.5}},
                           {"metrics": {"host_time": 0.25}}]}) == 0.375
    assert read({"units": [{"metrics": {}}]}) is None


@pytest.mark.parametrize("name,metrics", [
    ("tiny.grpo", ("dit_call_ms.train", "dit_pointwise_share.train", "lora_merge_s.train",
                   "backward_s.train")),
    ("tinyvideo.t2v", ("dit_call_ms.video", "dit_pointwise_share.video",
                       "decode_norm_share.video"))])
def test_readers_on_the_programs_own_record(bench_copy, name, metrics, monkeypatch):
    """A tiny cell's unit under a CPU profiler: each reader finds its spans
    (on the CPU the device seconds are the host seconds)."""
    monkeypatch.setattr(profiling, "REGISTRY", profiling._Registry())
    conftest.write_tiny(bench_copy, {"start": 0.0}, {"start": 0.0})
    cell = Cell(name, bench_dir=bench_copy)
    run = cell.kind.Run(cell, 2 ** 31 + 5, torch.device("cpu"))
    run.setup()
    with torch.profiler.profile():
        run.run_unit()
    for m in metrics:
        v = cell.reader(m)({})
        assert v is not None and v > 0, m
        if "share" in m:
            assert v < 100, m

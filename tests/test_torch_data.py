"""The port's data layer against the JAX package's, on the same files.

- ``length_grouped_indices`` and ``LengthGroupedSampler`` give JAX's index
  lists, the swap of the longest sample's megabatch to the front included.
- The native reader (the port's copy of ``cacheloader.cpp``, built with
  ``g++``): the header parse equals JAX's; ``gather_rows`` equals JAX's
  ``NativeShardReader`` and the port's memmap reader bit for bit, on halves
  that include a denormal and -65504; a failed build raises, and neither
  the reader nor ``LatentDataset`` falls back.
- ``LatentDataset.from_reference_cache`` on a ``.pt`` cache written with
  ``torch.save``: the same manifest, captions and rows as JAX's.
- ``PromptLoader`` with ``process_index``/``process_count``: the same
  batches as JAX's for every process of counts 1, 2 and 3, with a sample
  count no count divides, with and without ``drop_last``.
"""

import json
import os

import numpy as np
import pytest
import torch

from mixgrpo_tpu.data import dataset as JD
from mixgrpo_tpu.data import native_loader as JNL
from mixgrpo_tpu.data import sampler as JS
from mixgrpo_tpu_torch.data import dataset as D
from mixgrpo_tpu_torch.data import native_loader as NL
from mixgrpo_tpu_torch.data import sampler as S


@pytest.mark.parametrize("n,batch_size,world_size,seed,epoch,mult", [
    (40, 4, 1, 0, 0, 2), (37, 3, 2, 5, 1, 2), (200, 2, 4, 1, 3, 50), (5, 4, 1, 9, 0, 1),
    (0, 2, 1, 0, 0, 50)])
def test_length_grouped_sampler_matches_jax(n, batch_size, world_size, seed, epoch, mult):
    lengths = np.random.default_rng(n + seed).integers(1, 100, size=n).tolist()
    rng = lambda: np.random.default_rng((seed, epoch))
    got = S.length_grouped_indices(lengths, batch_size, world_size, rng(), mult)
    assert got == JS.length_grouped_indices(lengths, batch_size, world_size, rng(), mult)
    assert sorted(got) == list(range(n))
    if n:
        assert lengths[got[0]] == max(lengths)  # the longest megabatch was swapped first
    mine = S.LengthGroupedSampler(lengths, batch_size, world_size, seed)
    ref = JS.LengthGroupedSampler(lengths, batch_size, world_size, seed)
    assert mine.epoch(epoch) == ref.epoch(epoch) and len(mine) == len(ref) == n


@pytest.fixture()
def shard(tmp_path):
    """A cache of 10 samples written by the port's writer, with a denormal
    (6e-8) and -65504 among the halves."""
    rng = np.random.default_rng(0)
    w = D.EmbeddingCacheWriter(str(tmp_path), shard_size=16)
    for i in range(10):
        emb = rng.normal(size=(6, 8)).astype(np.float32)
        emb[0, 0], emb[0, 1] = 6e-8, -65504.0
        w.add(emb, rng.normal(size=(4,)).astype(np.float32), f"p{i}")
    w.finish()
    return str(tmp_path), os.path.join(str(tmp_path), "shard_00000.safetensors")


def test_native_reader_matches_jax_and_memmap(shard):
    _, path = shard
    assert NL.parse_safetensors_header(path) == JNL.parse_safetensors_header(path)
    mine, ref, mm = NL.NativeShardReader(path), JNL.NativeShardReader(path), D.SafetensorsShard(path)
    for name, rows in (("prompt_embed", [3, 0, 7, 3]), ("pooled", list(range(10))), ("pooled", [])):
        got = mine.gather_rows(name, rows)
        assert got.dtype == np.float32
        want = mm.gather_rows(name, rows)
        np.testing.assert_array_equal(got, ref.gather_rows(name, rows))
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert mine.gather_rows("prompt_embed", [0])[0, 0, 0] == np.float32(np.float16(6e-8))
    assert mine.gather_rows("prompt_embed", [0])[0, 0, 1] == -65504.0
    mine.prefetch_rows("prompt_embed", [1, 2])
    with pytest.raises(IndexError):
        mine.gather_rows("pooled", [10])
    mine.close()
    ref.close()


def test_dataset_native_matches_memmap(shard):
    cache, _ = shard
    native, plain = D.LatentDataset(cache, cfg_rate=0.3, seed=2), \
        D.LatentDataset(cache, cfg_rate=0.3, seed=2, use_native=False)
    assert native.use_native and isinstance(native._shard(0), NL.NativeShardReader)
    ref = JD.LatentDataset(cache, cfg_rate=0.3, seed=2)
    for i in range(10):
        a, b, c = native.get(i, epoch=1), plain.get(i, epoch=1), ref.get(i, epoch=1)
        assert a["caption"] == b["caption"] == c["caption"]
        for k in ("prompt_embed", "pooled"):
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(a[k], c[k])


def test_failed_build_raises_without_fallback(shard, tmp_path, monkeypatch):
    """A compiler that is not there: the build raises, and so do the reader
    and the dataset; nothing reads through Python instead."""
    cache, path = shard
    monkeypatch.setattr(NL, "CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(NL, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(NL, "_lib", None)
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        NL.build_library()
    assert os.listdir(tmp_path / "build") == []  # no half-written library left
    with pytest.raises(RuntimeError, match="build failed"):
        NL.NativeShardReader(path)
    with pytest.raises(RuntimeError, match="build failed"):
        D.LatentDataset(cache).get(0)
    assert D.LatentDataset(cache, use_native=False).get(0)["caption"] == "p0"


def test_from_reference_cache_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    entries = []
    for d in ("mine", "ref"):
        os.makedirs(tmp_path / d / "prompt_embed")
        os.makedirs(tmp_path / d / "pooled_prompt_embeds")
    for i in range(5):
        emb = torch.from_numpy(rng.normal(size=(7, 12)).astype(np.float32)).to(torch.bfloat16)
        pooled = torch.from_numpy(rng.normal(size=(5,)).astype(np.float32))
        e = {"prompt_embed_path": f"prompt_embed/{i}.pt",
             "pooled_prompt_embeds_path": f"pooled_prompt_embeds/{i}.pt"}
        e.update({"caption": f"caption {i}"} if i != 3 else {"prompt": "only a prompt"})
        entries.append(e)
        for d in ("mine", "ref"):
            torch.save(emb, tmp_path / d / e["prompt_embed_path"])
            torch.save(pooled, tmp_path / d / e["pooled_prompt_embeds_path"])
    for d in ("mine", "ref"):
        with open(tmp_path / d / "prompt.json", "w") as f:
            json.dump(entries, f)
    mine = D.LatentDataset.from_reference_cache(str(tmp_path / "mine"), cfg_rate=0.5, seed=1)
    ref = JD.LatentDataset.from_reference_cache(str(tmp_path / "ref"), cfg_rate=0.5, seed=1)
    assert mine.manifest == ref.manifest and mine.captions[3] == "only a prompt"
    for i in range(5):
        a, b = mine.get(i, epoch=2), ref.get(i, epoch=2)
        assert a["caption"] == b["caption"]
        for k in ("prompt_embed", "pooled"):
            np.testing.assert_array_equal(a[k], b[k])
    again = D.LatentDataset.from_reference_cache(str(tmp_path / "mine"))  # reuses the shards
    assert again.manifest == mine.manifest


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("count", [1, 2, 3])
def test_prompt_loader_shards_like_jax(tmp_path, count, drop_last):
    rng = np.random.default_rng(4)
    w = D.EmbeddingCacheWriter(str(tmp_path), shard_size=4)
    for i in range(11):
        w.add(rng.normal(size=(3, 4)).astype(np.float32), rng.normal(size=(2,)).astype(np.float32),
              f"c{i}")
    w.finish()
    per = -(-11 // count)  # samples per process after padding
    seen = []
    for index in range(count):
        kw = dict(seed=7, process_index=index, process_count=count, drop_last=drop_last)
        mine = list(D.PromptLoader(D.LatentDataset(str(tmp_path)), 2, **kw).epoch(1))
        ref = list(JD.PromptLoader(JD.LatentDataset(str(tmp_path)), 2, **kw).epoch(1))
        assert len(mine) == len(ref) == (per // 2 if drop_last else -(-per // 2))
        for a, b in zip(mine, ref):
            assert a["captions"] == b["captions"]
            np.testing.assert_array_equal(a["prompt_embed"], b["prompt_embed"])
            np.testing.assert_array_equal(a["pooled"], b["pooled"])
        seen += [c for a in mine for c in a["captions"]]
    if not drop_last:  # the padded permutation covers every sample
        assert {f"c{i}" for i in range(11)} <= set(seen)

"""Port's utils (timing, profiling, env) vs the JAX package.

``robust_slope`` is a copy of JAX's: the cases of tests/test_timing.py run on
both sides and must give the same ``SlopeTiming``.  ``Stopwatch`` and
``force_sync`` on the CPU; ``trace`` writes a Chrome trace holding the
``annotate`` span; ``collect_env`` reports the port's stack.
"""

import itertools
import json
import os

import pytest
import torch

from mixgrpo_tpu.utils import timing as JTM
from mixgrpo_tpu_torch.utils import env, profiling, timing


def _schedule(values):
    it = iter(values)
    return lambda m: next(it)


SCHEDULES = {
    "clean": ([0.03, 0.07, 0.11], 3),
    "negative_then_clean": ([0.10, 0.05, 0.04, 0.03, 0.07, 0.11], 3),
    "never_settles": (list(itertools.islice(itertools.cycle([0.10, 0.05, 0.04]), 9)), 3),
    "zero_slope": ([0.05, 0.05, 0.05] * 3, 3),
    "jitter_within_tolerance": ([0.03, 0.1101, 0.110], 3),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_robust_slope_matches_jax(name):
    values, retries = SCHEDULES[name]
    got = timing.robust_slope(_schedule(values), n=4, retries=retries)
    want = JTM.robust_slope(_schedule(values), n=4, retries=retries)
    assert (got.per_iter_s, got.valid, got.attempts, got.triples, got.reason) == \
        (want.per_iter_s, want.valid, want.attempts, want.triples, want.reason)
    assert got.per_iter_ms == want.per_iter_ms
    if name == "clean":
        assert got.valid and abs(got.per_iter_ms - 10.0) < 1e-6
    if name == "never_settles":
        assert not got.valid and got.per_iter_s is None and "non-monotone" in got.reason


def test_slope_timing_and_backend_smoke_on_cpu():
    assert timing.SlopeTiming(0.002, True, 1, [(0.0, 0.008, 0.016)]).per_iter_ms == 2.0
    assert timing.backend_smoke("cpu") >= 0.0


def test_stopwatch_and_force_sync():
    sw = profiling.Stopwatch()
    x = {"a": [torch.ones(3)], "b": torch.zeros(2)}
    for _ in range(2):
        with sw.section("work", sync_on=x):
            torch.ones(8).sum()
    with sw.section("other"):
        pass
    assert sw.counts == {"work": 2, "other": 1}
    assert set(sw.summary()) == {"work", "other"} and all(v >= 0 for v in sw.summary().values())
    profiling.force_sync()
    profiling.force_sync(x)
    profiling.force_sync([1, "not a tensor"])


def test_trace_writes_chrome_trace(tmp_path):
    logdir = str(tmp_path / "profile")
    with profiling.trace(logdir) as tr:
        with profiling.annotate("span_under_test"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
        assert tr.path is None
    assert os.path.dirname(tr.path) == logdir and tr.export_seconds >= 0
    with open(tr.path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "span_under_test" for e in events)


def test_collect_env_keys(capsys):
    info = env.collect_env()
    for key in ("python", "platform", "torch", "cuda", "numpy", "triton", "device_count",
                "devices"):
        assert key in info
    assert info["torch"] == torch.__version__
    assert info["device_count"] == len(info["devices"])
    env.main()
    assert "torch: " in capsys.readouterr().out

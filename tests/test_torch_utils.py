"""Port's utils (timing, profiling, env) vs the JAX package.

``robust_slope`` is a copy of JAX's: the cases of tests/test_timing.py run on
both sides and must give the same ``SlopeTiming``.  ``span`` on the CPU:
with no profiler one shared no-op (no trace range, no CUDA event, nothing
recorded); under ``torch.profiler`` its paths, nesting, counts and units,
spans on another thread (autograd's worker) or in a checkpointed block's
recompute under ``backward``, a DiT call's stages recorded in the sampled
calls alone, and the card's event pairs.  ``trace`` writes a Chrome trace
holding the span; ``collect_env`` reports the port's stack.
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


@pytest.fixture
def registry(monkeypatch):
    """A fresh span registry for one test."""
    reg = profiling._Registry()
    monkeypatch.setattr(profiling, "REGISTRY", reg)
    return reg


def test_span_without_profiler_is_a_shared_noop(registry, monkeypatch):
    def refused(*a, **k):
        raise AssertionError("made with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    monkeypatch.setattr(profiling, "_FAST", refused)
    monkeypatch.setattr(torch.cuda, "Event", refused)
    spans = [profiling.span("a"), profiling.span("rollout"), profiling.span("gemm")]
    assert spans[0] is spans[1] is spans[2]
    with profiling.span("outer"):
        with profiling.span("inner"):
            torch.ones(4).sum()
    assert profiling.spanned("f")(lambda x: x + 1)(1) == 2
    assert profiling.last_unit() is None and registry.unit is None
    assert profiling.unit_metrics(None) == {}


def test_span_paths_counts_and_units_under_profiler(registry):
    from torch.profiler import profile

    @profiling.spanned("leaf")
    def leaf(x):
        with profiling.span("inner"):
            return x * 2

    with profile() as prof:
        with profiling.span("unit"):
            for _ in range(3):
                with profiling.span("mid"):
                    leaf(torch.ones(8))
            leaf(torch.ones(8))
        first = profiling.last_unit()
        with profiling.span("second"):
            pass
    assert sorted(first) == ["unit", "unit/leaf", "unit/leaf/inner", "unit/mid",
                             "unit/mid/leaf", "unit/mid/leaf/inner"]
    assert [first[p]["count"] for p in sorted(first)] == [1, 1, 1, 3, 3, 3]
    for e in first.values():  # on the CPU the device seconds are the host seconds
        assert e["device_s"] == e["host_s"] >= 0 and e["timed"] == e["count"]
    assert first["unit"]["host_s"] >= first["unit/mid"]["host_s"]
    assert sorted(profiling.last_unit()) == ["second"]  # the last unit only
    names = [e.name for e in prof.events()]
    assert names.count("mid") == 3 and names.count("leaf") == 4 and "unit" in names
    assert names.count("inner") == 4
    flat = profiling.unit_metrics(first)
    assert flat["span/unit/mid/leaf/count"] == 3 and "span/unit/mid/device_s" in flat


def test_span_in_recompute_and_other_threads_lands_under_backward(registry, monkeypatch):
    """A checkpointed block's spans, run again in the backward, land under
    the span around ``autograd.grad``; so do spans of another thread while
    the unit is open (autograd's worker thread on a card, which inherits the
    profiler's state: a plain thread does not, so the test lends it)."""
    import threading

    from torch.profiler import profile
    from torch.utils.checkpoint import checkpoint

    def block(x):
        with profiling.span("merge"):
            return torch.tanh(x @ x.T)

    def worker():
        with profiling.span("on_thread"):
            pass

    x = torch.randn(4, 4, requires_grad=True)
    with profile():
        with profiling.span("iteration"):
            loss = checkpoint(block, x, use_reentrant=False).sum()
            with profiling.span("backward"):
                torch.autograd.grad(loss, [x])
                with monkeypatch.context() as m:
                    m.setattr(torch.autograd, "_profiler_enabled", lambda: True)
                    t = threading.Thread(target=worker)
                    t.start()
                    t.join(timeout=30)
    assert not t.is_alive()
    rec = profiling.last_unit()
    assert rec["iteration/merge"]["count"] == 1
    assert rec["iteration/backward/merge"]["count"] == 1
    assert rec["iteration/backward/on_thread"]["count"] == 1
    assert set(rec) == {"iteration", "iteration/merge", "iteration/backward",
                        "iteration/backward/merge", "iteration/backward/on_thread"}


def test_span_dit_stages_recorded_in_sampled_calls_only(registry):
    """Of 18 DiT calls the first and the seventeenth are sampled: the
    ``dit`` spans count all 18 and time those two, the stages inside them are
    recorded and put in the trace there alone, and a span that is not a
    stage is recorded in every call."""
    from torch.profiler import profile

    assert profiling.SAMPLE_EVERY == 16
    x = torch.ones(8)
    with profile() as prof:
        with profiling.span("denoise"):
            for _ in range(18):
                with profiling.span("dit"):
                    with profiling.span("gemm"):
                        x = x * 2
                    with profiling.span("norm_mod"):
                        x = x - 1
                    with profiling.span("merge"):
                        x = x + 1
            with profiling.span("gemm"):  # outside a DiT call: nothing
                x = x / 2
    rec = profiling.last_unit()
    assert set(rec) == {"denoise", "denoise/dit", "denoise/dit/gemm", "denoise/dit/norm_mod",
                        "denoise/dit/merge"}
    assert (rec["denoise/dit"]["count"], rec["denoise/dit"]["timed"]) == (18, 2)
    assert rec["denoise/dit"]["device_s"] < rec["denoise/dit"]["host_s"]
    for stage in ("gemm", "norm_mod"):
        assert rec[f"denoise/dit/{stage}"]["count"] == rec[f"denoise/dit/{stage}"]["timed"] == 2
    assert rec["denoise/dit/merge"]["count"] == rec["denoise/dit/merge"]["timed"] == 18
    names = [e.name for e in prof.events()]
    assert names.count("gemm") == 2 and names.count("norm_mod") == 2
    assert names.count("dit") == 18 and names.count("denoise") == 1


def test_span_events_on_a_card(registry, monkeypatch):
    """The card's path with its CUDA calls stood in for: a timed span gets
    device seconds from its event pair on the unit's stream (read only when
    the record is read); a DiT call outside the sample and its stages make
    no event."""
    from torch.profiler import profile

    made, clock = [], iter(range(1000))

    class Event:
        def __init__(self, enable_timing):
            assert enable_timing
            made.append(self)

        def record(self, stream):
            assert stream == "stream"
            self.t = next(clock)

        def elapsed_time(self, end):
            return 1e3 * (end.t - self.t)  # ms: one tick a second

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: "stream")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    with profile():
        for _ in range(2):
            with profiling.span("unit"):
                for _ in range(2):
                    with profiling.span("dit"):
                        with profiling.span("gemm"):
                            pass
            rec = profiling.last_unit()
            assert rec["unit"]["device_s"] == 5.0 and rec["unit/dit"]["device_s"] == 3.0
            assert rec["unit/dit/gemm"]["device_s"] == 1.0
            assert rec["unit/dit"]["count"] == 2 and rec["unit/dit"]["timed"] == 1
    assert len(made) == 12  # two a timed span: the unit, the sampled call, its gemm


def test_trace_writes_chrome_trace(tmp_path):
    logdir = str(tmp_path / "profile")
    with profiling.trace(logdir) as tr:
        with profiling.span("span_under_test"):
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

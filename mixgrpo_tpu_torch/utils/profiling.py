"""Tracing and profiling on ``torch.profiler``.

Port of mixgrpo_tpu/utils/profiling.py, with the port's spans:

  - ``trace(logdir)``: a context manager that profiles CPU and (with a card)
    CUDA activity and, on exit, writes a Chrome trace
    ``<logdir>/trace_<ns>.json`` (viewable in Perfetto or chrome://tracing).
    Shapes, stacks and memory are not recorded: a full-depth training
    iteration already has some 10^5 device events.  It yields a ``Trace``
    whose ``path`` and ``export_seconds`` are set when the file is written;
  - ``span(name)``: a named span where the work happens.  With no profiler
    recording it is one shared no-op context manager: no trace range, no
    CUDA event, nothing allocated.  While a ``torch.profiler`` records, it
    puts a range in the trace above the kernels it launched (a user
    annotation, ``record_function``, for the ``ANNOTATIONS`` by which a
    trace's idle gaps are named; the profiler's cheaper operator range for
    every other name), and it counts into the record of the current unit
    under the ``/``-joined path of the open spans
    (``iteration/rollout/chunk/dit``): entries, host seconds and, from a
    pair of CUDA timing events on the unit's stream, device seconds (the
    host seconds on the CPU).  A span opened where none is open is a root:
    it starts a new unit, and the record keeps the last unit that closed.
    A span opened on another thread while a unit is open (autograd's worker
    thread, recomputing a checkpointed block in the backward) lands under
    the unit's innermost open span;
  - the ``STAGES`` of a DiT call (``gemm``, ``attn``, ``norm_mod``,
    ``qk_rope``, ``gate_res``, ``act``), some 700 spans a call, are recorded
    only inside one ``dit`` span of every ``SAMPLE_EVERY`` (16) in a unit (the
    first, the seventeenth, ...); everywhere else a stage is the no-op, as
    with no profiler, so that the trace's cost stays in the sampled calls.
    The ``dit`` span counts every call, and its device seconds are
    those of the same sampled calls, so that a record's ``timed`` (the
    spans of a path with device seconds) divides them;
  - ``spanned(name)``: a decorator that runs a function inside ``span``;
  - ``last_unit()``: the last closed unit's record, ``{path: {"count",
    "timed", "host_s", "device_s"}}`` (``device_s`` where ``timed``), or
    None.  Its events are turned into seconds here, once, never at a span's
    exit, so that the traced window holds no waiting on the device for them;
  - ``unit_metrics(record)``: a record as flat ``span/<path>/<key>`` numbers,
    for a metrics log.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import threading
import time
from typing import Dict, Optional

import torch

_NOOP = contextlib.nullcontext()


@dataclasses.dataclass
class Trace:
    logdir: str
    path: Optional[str] = None  # the Chrome trace, once written
    export_seconds: Optional[float] = None


@contextlib.contextmanager
def trace(logdir: str):
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = Trace(logdir)
    prof = profile(activities=acts, record_shapes=False, with_stack=False,
                   profile_memory=False)
    prof.start()
    try:
        yield out
    finally:
        prof.stop()
        t0 = time.perf_counter()
        path = os.path.join(logdir, f"trace_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        out.path, out.export_seconds = path, time.perf_counter() - t0


ANNOTATIONS = frozenset(("rollout", "decode", "reward", "update", "denoise"))
STAGES = frozenset(("gemm", "attn", "norm_mod", "qk_rope", "gate_res", "act"))
SAMPLE_EVERY = 16
_FAST = torch._C._profiler._RecordFunctionFast


class _Unit:
    """One unit's entries: path -> [count, timed, host seconds, device
    seconds of spans timed on the host clock (no card), [start, end, ...]
    CUDA events]; and the ``dit`` spans opened so far."""

    def __init__(self):
        self.entries: Dict[str, list] = {}
        self.dits = 0
        self.record: Optional[Dict[str, Dict[str, float]]] = None

    def resolve(self) -> Dict[str, Dict[str, float]]:
        """The record, its events read and dropped."""
        if self.record is None:
            if any(e[4] for e in self.entries.values()):
                torch.cuda.synchronize()
            self.record = {}
            for path, (n, timed, host, plain, evs) in self.entries.items():
                r = self.record[path] = {"count": n, "timed": timed, "host_s": host}
                if timed:
                    r["device_s"] = plain + sum(
                        evs[i].elapsed_time(evs[i + 1]) for i in range(0, len(evs), 2)) / 1e3
            self.entries = {}
        return self.record


class _Registry:
    """The process's spans: each thread's stack of open paths and whether
    its open DiT call is sampled, the open unit with the stack of the
    thread that opened it and the stream its events go on, and the last
    closed unit."""

    def __init__(self):
        self.local = threading.local()
        self.unit: Optional[_Unit] = None
        self.owner: Optional[list] = None
        self.stream = None
        self.last: Optional[_Unit] = None

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def sampled(self) -> bool:
        return getattr(self.local, "sampled", False)

    def event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        return ev


REGISTRY = _Registry()


class _Span:
    __slots__ = ("name", "path", "stack", "root", "timed", "outer", "rf", "ev", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        reg = REGISTRY
        stack = self.stack = reg.stack()
        if stack:
            parent = stack[-1]
        elif reg.unit is not None and reg.owner:  # another thread, inside the open unit
            parent = reg.owner[-1]
        else:
            parent = None
        self.root = parent is None
        if self.root:
            reg.unit, reg.owner = _Unit(), stack
            reg.stream = torch.cuda.current_stream() if torch.cuda.is_initialized() else None
        self.timed = True
        if self.name == "dit":
            self.timed = reg.unit.dits % SAMPLE_EVERY == 0
            reg.unit.dits += 1
            self.outer, reg.local.sampled = reg.sampled(), self.timed
        self.path = self.name if self.root else f"{parent}/{self.name}"
        stack.append(self.path)
        self.rf = (torch.profiler.record_function(self.name) if self.name in ANNOTATIONS
                   else _FAST(self.name))
        self.rf.__enter__()
        self.ev = reg.event() if self.timed and reg.stream is not None else None
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        reg = REGISTRY
        end = None if self.ev is None else reg.event()
        dt = time.perf_counter() - self.t0
        self.rf.__exit__(*exc)
        self.stack.pop()
        if self.name == "dit":
            reg.local.sampled = self.outer
        if reg.unit is not None:
            e = reg.unit.entries.get(self.path)
            if e is None:
                e = reg.unit.entries[self.path] = [0, 0, 0.0, 0.0, []]
            e[0] += 1
            e[2] += dt
            if self.timed:
                e[1] += 1
                if end is None:
                    e[3] += dt
                else:
                    e[4] += (self.ev, end)
            if self.root:
                reg.last, reg.unit, reg.owner = reg.unit, None, None
        return False


def span(name: str):
    """A span named ``name`` (see the module docstring)."""
    if not torch.autograd._profiler_enabled():
        return _NOOP
    if name in STAGES and not REGISTRY.sampled():
        return _NOOP
    return _Span(name)


def spanned(name: str):
    """Decorator: each call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return run
    return wrap


def last_unit() -> Optional[Dict[str, Dict[str, float]]]:
    """The record of the last unit that closed (see the module docstring)."""
    unit = REGISTRY.last
    return None if unit is None else unit.resolve()


def unit_metrics(record) -> Dict[str, float]:
    """``record`` (``last_unit()``) as
    ``span/<path>/{count,timed,host_s,device_s}``."""
    return {f"span/{path}/{k}": v for path, e in (record or {}).items()
            for k, v in e.items()}

"""Tracing and profiling helpers on ``torch.profiler``.

Port of mixgrpo_tpu/utils/profiling.py:

  - ``trace(logdir)``: a context manager that profiles CPU and (with a card)
    CUDA activity and, on exit, writes a Chrome trace
    ``<logdir>/trace_<ns>.json`` (viewable in Perfetto or chrome://tracing).
    Shapes, stacks and memory are not recorded: a full-depth training
    iteration already has some 10^5 device events.  It yields a ``Trace``
    whose ``path`` and ``export_seconds`` are set when the file is written;
  - ``annotate(name)``: a named span (``torch.profiler.record_function``);
  - ``force_sync(x)``: wait for the device of ``x``'s tensors;
  - ``Stopwatch``: wall-clock section timing that synchronizes first.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, Optional

import torch


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


def annotate(name: str):
    return torch.profiler.record_function(name)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def force_sync(x=None) -> None:
    """Wait for the card that holds ``x``'s first tensor (any tree of dicts,
    lists and tensors), or for the current card when ``x`` is None; nothing
    to wait for on the CPU."""
    if x is None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return
    for t in _tensors(x):
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        return


class Stopwatch:
    """Accumulating section timer (synchronized): ``with sw.section("rollout"):``"""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        yield
        force_sync(sync_on)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        return {k: self.totals[k] / max(self.counts[k], 1) for k in self.totals}

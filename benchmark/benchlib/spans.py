"""Readers of the program's own span record.

The program (``mixgrpo_tpu_torch/utils/profiling.py``) counts its spans
only while a profiler records, and keeps the record of the last unit that
closed (a root span: ``iteration`` around a GRPO iteration, ``video``
around a video).  Nothing else in a benchmark process runs under a
profiler, so read after the traced unit that record is the traced unit's:
``{path: {"count", "timed", "host_s", "device_s"}}``, each path the
``/``-joined names of the open spans (``iteration/rollout/chunk/dit``),
``device_s`` on the device clock, summed over the path's ``timed`` spans.
The stages inside a DiT call (``gemm``, ``attn``, ...) are recorded only in
the sampled calls, and the ``dit`` spans are timed only there, so a DiT
call's numbers all come from the same calls.  A program without the record
(one older than its spans) gives None, and so does every reader here.
"""

from __future__ import annotations


def record():
    """The traced unit's record, or None."""
    try:
        from mixgrpo_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "last_unit", None)
    return read() if callable(read) else None


def _paths(rec, name, under):
    """The paths whose last span is ``name`` and that lie under a span named
    ``under``."""
    out = []
    for path in rec or ():
        parts = path.split("/")
        if parts[-1] == name and under in parts[:-1]:
            out.append(path)
    return out


def _device(rec, paths):
    return sum(rec[p].get("device_s", 0.0) for p in paths)


def _timed(rec, paths):
    return sum(rec[p].get("timed", rec[p]["count"]) for p in paths)


def device_s(rec, name, under):
    """Device seconds of every ``name`` span under an ``under`` span, or
    None where none was timed."""
    paths = _paths(rec, name, under)
    return _device(rec, paths) if _timed(rec, paths) else None


def dit_call_ms(rec, under):
    """Device milliseconds per timed ``dit`` span (one DiT call) under
    ``under``."""
    paths = _paths(rec, "dit", under)
    n = _timed(rec, paths)
    return 1e3 * _device(rec, paths) / n if n else None


def dit_pointwise_share(rec, under):
    """100 x the device time of the timed ``dit`` spans under ``under``
    outside their ``gemm`` and ``attn`` spans, over the ``dit`` spans' time."""
    paths = _paths(rec, "dit", under)
    total = _device(rec, paths)
    if not total:
        return None
    owned = _device(rec, [f"{p}/{stage}" for p in paths for stage in ("gemm", "attn")
                          if f"{p}/{stage}" in rec])
    return 100.0 * (total - owned) / total


def share(rec, part, whole, under):
    """100 x the device time of the ``part`` spans under a ``whole`` span
    over the time of the ``whole`` spans under ``under``."""
    total, inside = device_s(rec, whole, under), device_s(rec, part, whole)
    return 100.0 * inside / total if total and inside is not None else None

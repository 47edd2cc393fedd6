"""Reading a ``torch.profiler`` Chrome trace into device numbers.

``trace_events`` and ``kernel_class`` copy ``chip_smoke.py``'s functions of
the same names; ``summarize`` extends its ``trace_summary`` with each
kernel's time, the flash-attention kernels' time and the longest idle gaps,
each named by what the host was doing when the device went idle.
"""

from __future__ import annotations

import json

FLASH_KERNELS = ("flash_fwd_kernel", "flash_bwd", "bwd_stats_kernel", "key_term_kernel")


def trace_events(path, chunk=1 << 24):
    """The ``traceEvents`` of a Chrome trace, one event at a time, decoded
    from a rolling buffer: an iteration's trace is too big to load whole."""
    dec = json.JSONDecoder()
    with open(path) as f:
        buf = f.read(chunk)
        while '"traceEvents"' not in buf:
            more = f.read(chunk)
            if not more:
                return
            buf += more
        i = buf.index("[", buf.index('"traceEvents"')) + 1
        while True:
            while i < len(buf) and buf[i] in " \t\r\n,":
                i += 1
            if i < len(buf) and buf[i] == "]":
                return
            try:
                if i >= len(buf):
                    raise ValueError("need more")
                ev, i = dec.raw_decode(buf, i)
            except ValueError:
                more = f.read(chunk)
                if not more:
                    raise
                buf, i = buf[i:] + more, 0
                continue
            yield ev


def kernel_class(name: str) -> str:
    low = name.lower()
    if any(s in low for s in FLASH_KERNELS):
        return "flash_attn"
    if any(s in low for s in ("gemm", "nvjet", "xmma", "cutlass", "sm90_", "cublas")):
        return "gemm"
    if "copy_kernel" in low or "catarray" in low:
        return "copy"  # dtype casts, contiguous copies, concatenations
    if any(s in low for s in ("elementwise", "reduce_kernel", "vectorized", "softmax", "norm",
                              "index")):
        return "elementwise"
    return "other"


def _union(intervals):
    """Total length of the union of sorted (start, end) intervals, and the
    gaps between them as (start, end)."""
    busy, gaps, cur_s, cur_e = 0.0, [], None, None
    for s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


def _host_label(t, spans, ops):
    """The annotated span and the innermost host operator running at ``t``."""
    span = next((n for s, e, n in spans if s <= t < e), "outside")
    best = None
    for s, e, n in ops:
        if s <= t < e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, n)
    return f"{span}/{best[2]}" if best else span


def summarize(path: str, spans=("rollout", "decode", "reward", "update", "denoise"),
              top: int = 10) -> dict:
    """Device numbers of one trace: busy seconds (the union of kernel,
    memcpy and memset intervals), the traced window (first to last event of
    any kind), seconds by kernel class and by kernel name, the flash
    kernels' seconds, and the ``top`` longest idle gaps, named by the
    annotated span and the innermost host operator at the gap's start."""
    classes = {}
    per_kernel = {}
    device, ann, ops = [], [], []
    lo, hi = float("inf"), 0.0
    for ev in trace_events(path):
        if ev.get("ph") != "X":
            continue
        ts, dur = float(ev.get("ts", 0)), float(ev.get("dur", 0))
        lo, hi = min(lo, ts), max(hi, ts + dur)
        cat, name = ev.get("cat", ""), ev.get("name", "")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            cls = kernel_class(name) if cat == "kernel" else "other"
            classes[cls] = classes.get(cls, 0.0) + dur / 1e6
            k = per_kernel.setdefault(name, [0.0, 0])
            k[0] += dur / 1e6
            k[1] += 1
            device.append((ts, ts + dur))
        elif cat == "user_annotation" and name in spans:
            ann.append((ts, ts + dur, name))
        elif cat == "cpu_op":
            ops.append((ts, ts + dur, name))
    device.sort()
    busy_us, gaps = _union(device)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    window_s = (hi - lo) / 1e6 if hi > lo else 0.0
    kernels = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    return {
        "busy_s": busy_us / 1e6,
        "window_s": window_s,
        "class_s": classes,
        "kernel_s": {n: v[0] for n, v in per_kernel.items()},
        "flash_s": sum(v[0] for n, v in per_kernel.items() if kernel_class(n) == "flash_attn"),
        "device_ops": [[n[:200], v[0]] for n, v in kernels[:top]],
        "idle_gaps": [[_host_label(s, ann, ops)[:200], (e - s) / 1e6] for s, e in gaps],
    }

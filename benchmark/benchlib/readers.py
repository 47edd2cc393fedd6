"""What the per-layer metric readers under ``metrics/`` share.  Each reader
returns None where its run has nothing to read, and the harness then
leaves the metric out of the line; a share of a peak or a roofline is never
reported as 0 for want of data."""

from __future__ import annotations

from benchlib import flops as F


def unit_mean(ctx, key):
    """The mean over the window's units of the program's own per-unit
    number ``key`` (a synchronised host timer of the program)."""
    vals = [u["metrics"][key] for u in ctx["units"] if key in u.get("metrics", {})]
    return sum(vals) / len(vals) if vals else None


def elementwise_share(ctx):
    """Elementwise and copy kernels' share (%) of the traced unit's summed
    kernel time."""
    tr = ctx["trace"]
    if not tr or not tr["class_s"]:
        return None
    total = sum(tr["class_s"].values())
    return 100.0 * (tr["class_s"].get("elementwise", 0.0) + tr["class_s"].get("copy", 0.0)) / total


def idle_share(ctx):
    """Share (%) of the traced window with no kernel, copy or set on the device."""
    tr = ctx["trace"]
    if not tr or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def attention_roofline(ctx):
    """The attention kernels' share (%) of their roofline in the traced unit:
    the least time of every launch (its shape's operations at the bf16 peak
    or bytes at the HBM rate, whichever is larger) over the flash kernels'
    device time."""
    tr, launches = ctx["trace"], ctx["launches"]
    if not tr or not launches or not tr["flash_s"]:
        return None
    bound = sum(n * F.bound_s(*F.attention_call(k, *ctx["attention_calls"][k]), ctx["peaks"])
                for k, n in launches.items() if n)
    return 100.0 * bound / tr["flash_s"] if bound else None


def mfu(ctx):
    """Model FLOPs of the window's units over the window's time at the bf16
    peak of the cell's cards (%)."""
    if not ctx["units"] or not ctx["elapsed"]:
        return None
    done = ctx["unit_flops"] * len(ctx["units"])
    return 100.0 * done / (ctx["elapsed"] * ctx["peaks"]["bf16_flops"] * ctx["chips"])

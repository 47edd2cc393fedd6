"""The measured window: whole units of work, back to back.

A unit is one GRPO iteration or one video.  The window always runs one
unit, and starts another only if, judged by the previous unit's time, it
would end within ``seconds``.  It never counts part of a unit: the
end-to-end value is the units' work over the units' elapsed time.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple


def run_window(run_unit: Callable[[], Dict], seconds: float,
               clock: Callable[[], float] = time.perf_counter) -> Tuple[List[Dict], float]:
    """Run ``run_unit()`` (which returns a record with its ``work`` and waits
    for the device before it returns) under the whole-unit rule.  Returns
    the records, each with its ``seconds``, and the window's elapsed seconds
    from the first unit's start to the last one's end."""
    units: List[Dict] = []
    t0 = clock()
    while True:
        start = clock()
        rec = dict(run_unit())
        end = clock()
        rec["seconds"] = end - start
        units.append(rec)
        if end - t0 + rec["seconds"] > seconds:
            return units, end - t0


def end_to_end_value(form: str, units: List[Dict], elapsed: float) -> float:
    """The end-to-end value of a window: ``work_per_s`` (the units' work
    over the elapsed time) or ``s_per_unit`` (the elapsed time over the
    units)."""
    if form == "work_per_s":
        return sum(u["work"] for u in units) / elapsed
    if form == "s_per_unit":
        return elapsed / len(units)
    raise ValueError(f"unknown end-to-end form {form!r}")

"""Robust timing: a per-iteration cost as a validated slope.

Port of mixgrpo_tpu/utils/timing.py (``SlopeTiming`` and ``robust_slope``
copied as they are: pure Python):

- time only work that ends in a host synchronization;
- estimate the per-iteration cost as the SLOPE over loop lengths (0, n, 2n),
  which cancels a fixed dispatch overhead;
- validate the triple: reject non-monotone timings (t0 <= t1 <= t2 up to a
  small tolerance) and non-positive slopes, retry up to ``retries`` times,
  and report ``valid=False`` rather than a poisoned number.

``backend_smoke`` runs one small bf16 matmul on the card and checks it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional


@dataclass
class SlopeTiming:
    """Result of :func:`robust_slope`.

    ``per_iter_s`` is None when no valid triple was obtained; consumers must
    check ``valid`` before publishing the number.
    """

    per_iter_s: Optional[float]
    valid: bool
    attempts: int
    triples: list  # [(t0, t1, t2), ...] raw wall-clock per attempt
    reason: str = ""

    @property
    def per_iter_ms(self) -> Optional[float]:
        return None if self.per_iter_s is None else self.per_iter_s * 1e3


def robust_slope(
    timed: Callable[[int], float],
    n: int,
    retries: int = 3,
    rel_tol: float = 0.02,
) -> SlopeTiming:
    """Slope-based per-iteration timing with monotonicity validation.

    ``timed(m)`` must run the program for ``m`` iterations and return the
    wall-clock seconds (including a synchronization).  Calls
    ``timed(0), timed(n), timed(2n)``; a valid triple satisfies
    ``t0 <= t1 <= t2`` within ``rel_tol * t2`` slack and yields a strictly
    positive slope ``(t2 - t0) / (2n)``.  Invalid triples are retried.
    """
    assert n > 0
    triples = []
    reason = ""
    for attempt in range(1, retries + 1):
        t0, t1, t2 = timed(0), timed(n), timed(2 * n)
        triples.append((t0, t1, t2))
        slack = rel_tol * max(t2, 1e-9)
        if t1 < t0 - slack or t2 < t1 - slack:
            reason = f"non-monotone triple ({t0:.4f}, {t1:.4f}, {t2:.4f})"
            continue
        slope = (t2 - t0) / (2 * n)
        if slope <= 0:
            reason = f"non-positive slope {slope:.6f}"
            continue
        return SlopeTiming(slope, True, attempt, triples)
    return SlopeTiming(None, False, retries, triples, reason)


def backend_smoke(device="cuda") -> float:
    """A 256x256 bf16 matmul of ones on ``device``, its sum fetched to the
    host and checked (256^3); returns the elapsed seconds.  Raises what the
    device raises; a wedged device hangs rather than raises, so bound the
    call from outside."""
    import torch

    t0 = time.perf_counter()
    x = torch.ones((256, 256), dtype=torch.bfloat16, device=device)
    val = float((x @ x).float().sum())
    if val != 256.0 * 256 * 256:
        raise RuntimeError(f"backend smoke on {device}: sum {val} != {256 ** 3}")
    return time.perf_counter() - t0

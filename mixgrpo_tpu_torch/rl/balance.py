"""Positive/negative advantage sample reordering.

Port of mixgrpo_tpu/rl/balance.py, copied (numpy): a permutation of the
samples, either a full shuffle or positive- and negative-advantage samples
interleaved so gradient-accumulation groups see balanced signs.
"""

from __future__ import annotations

import numpy as np


def balance_pos_neg(advantages, rng: np.random.Generator, use_random: bool = False):
    """Return a permutation of ``range(len(advantages))``.

    ``use_random=True``: uniform shuffle.  Otherwise: shuffle positives and
    negatives independently, interleave starting with the smaller sign
    group, and append the remainder (zero-advantage samples keep their
    position semantics of the reference, which drops them from both groups —
    they are appended at the end here to avoid losing samples).
    """
    adv = np.asarray(advantages)
    n = adv.shape[0]
    idx = np.arange(n)
    if use_random:
        perm = idx.copy()
        rng.shuffle(perm)
        return perm

    pos = idx[adv > 0]
    neg = idx[adv < 0]
    zero = idx[adv == 0]
    rng.shuffle(pos)
    rng.shuffle(neg)
    small, large = (pos, neg) if len(pos) < len(neg) else (neg, pos)
    out = []
    for i in range(len(small)):
        out.append(small[i])
        out.append(large[i])
    out.extend(large[len(small):])
    out.extend(zero)
    return np.asarray(out, dtype=np.int64)

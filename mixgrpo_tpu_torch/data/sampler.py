"""Length-grouped batch sampling.

Port of mixgrpo_tpu/data/sampler.py (pure numpy, copied so that the port
imports nothing of the JAX package): indices are shuffled, partitioned into
megabatches of ``batch_size * world_size * mega_batch_mult``, each megabatch
sorted by sample length, longest first, so batches see similar lengths, and
the megabatch holding the globally longest sample is swapped to the front
(an out-of-memory failure shows on the first batch).  Epoch ``e`` draws
from ``np.random.default_rng((seed, e))``, as in JAX, so both packages give
the same index lists.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def length_grouped_indices(
    lengths: Sequence[int],
    batch_size: int,
    world_size: int = 1,
    generator: np.random.Generator | None = None,
    mega_batch_mult: int = 50,
) -> List[int]:
    rng = generator or np.random.default_rng()
    n = len(lengths)
    mega = batch_size * world_size * mega_batch_mult
    order = rng.permutation(n)
    megabatches = [order[i : i + mega] for i in range(0, n, mega)]
    lengths = np.asarray(lengths)
    sorted_mbs = [
        mb[np.argsort(-lengths[mb], kind="stable")] for mb in megabatches
    ]
    # move the globally longest sample to the very front (OOM fail-fast)
    if sorted_mbs:
        maxes = [lengths[mb[0]] for mb in sorted_mbs]
        top = int(np.argmax(maxes))
        sorted_mbs[0], sorted_mbs[top] = sorted_mbs[top], sorted_mbs[0]
    return [int(i) for mb in sorted_mbs for i in mb]


class LengthGroupedSampler:
    def __init__(
        self,
        lengths: Sequence[int],
        batch_size: int,
        world_size: int = 1,
        seed: int = 0,
    ):
        self.lengths = list(lengths)
        self.batch_size = batch_size
        self.world_size = world_size
        self.seed = seed

    def epoch(self, epoch: int = 0) -> List[int]:
        rng = np.random.default_rng((self.seed, epoch))
        return length_grouped_indices(
            self.lengths, self.batch_size, self.world_size, rng
        )

    def __len__(self) -> int:
        return len(self.lengths)

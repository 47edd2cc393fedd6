"""Seeds for the benchmark's own draws, each derived from the run's
``--seed`` and a tuple of parts (which input, which step, which chunk), so
that any whole number given as the seed gives the same inputs again."""

import numpy as np


def derive(*parts) -> int:
    """A 63-bit seed from whole numbers ``parts`` of any size."""
    return int(np.random.SeedSequence([int(p) for p in parts]).generate_state(1, np.uint64)[0]
               & ((1 << 63) - 1))

"""Device seconds of the traced iteration's LoRA merges: every ``merge``
span (the rollout's whole-tree merge, each block's merge in the update's
forward and in its recompute)."""

from benchlib import spans


def read(ctx):
    return spans.device_s(spans.record(), "merge", "iteration")

"""Device seconds of the traced iteration's backward passes: the
``backward`` spans under ``update`` (``torch.autograd.grad``, with the
checkpointed blocks' recompute)."""

from benchlib import spans


def read(ctx):
    return spans.device_s(spans.record(), "backward", "update")

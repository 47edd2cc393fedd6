"""Device milliseconds per DiT call of the traced iteration's rollout: the
program's timed ``dit`` spans under ``rollout`` (one call of every
``SAMPLE_EVERY`` of the program's spans)."""

from benchlib import spans


def read(ctx):
    return spans.dit_call_ms(spans.record(), "rollout")

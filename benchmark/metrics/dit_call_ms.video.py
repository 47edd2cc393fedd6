"""Device milliseconds per DiT call of the traced video's denoise: the
program's timed ``dit`` spans under ``denoise`` (one call of every
``SAMPLE_EVERY`` of the program's spans)."""

from benchlib import spans


def read(ctx):
    return spans.dit_call_ms(spans.record(), "denoise")

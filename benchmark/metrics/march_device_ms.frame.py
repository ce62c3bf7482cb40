"""Device milliseconds per frame launched under the program's
``crt.shade.march`` spans: the transmissive branch of a glass scene's
shadows, the glass-flag split pass and the bend-walk with their traces."""

from harness.program_trace import program_spans
from harness.trace import device_ms_under, per_unit


def read(ctx):
    t = program_spans(ctx.trace)
    if t is None:
        return None
    return per_unit(device_ms_under(t, "crt.shade.march"), ctx.trace)

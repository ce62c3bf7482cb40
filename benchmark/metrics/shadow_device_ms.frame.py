"""Device milliseconds per frame launched under the program's
``crt.trace.shadow`` spans: the opaque point-light shadow pass with its
Phase A (on the cluster path ``bin_apex_shared`` and K2, on the
streaming path its shaft calls and K9)."""

from harness.program_trace import program_spans
from harness.trace import device_ms_under, per_unit


def read(ctx):
    t = program_spans(ctx.trace)
    if t is None:
        return None
    return per_unit(device_ms_under(t, "crt.trace.shadow"), ctx.trace)

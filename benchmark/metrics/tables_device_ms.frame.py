"""Device milliseconds per frame launched under the program's
``crt.tables`` spans: the scene tables that the trace factories build
anew every frame (cluster, stream, rank, row and glass tables)."""

from harness.program_trace import program_spans
from harness.trace import device_ms_under, per_unit


def read(ctx):
    t = program_spans(ctx.trace)
    if t is None:
        return None
    return per_unit(device_ms_under(t, "crt.tables"), ctx.trace)

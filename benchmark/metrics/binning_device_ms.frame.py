"""Device milliseconds per frame launched under the binning spans
(Phase A: ops/binning.py, ops/stream_binning.py)."""

from harness.trace import device_ms_under, per_unit


def read(ctx):
    return per_unit(device_ms_under(ctx.trace, "bench.binning"), ctx.trace)

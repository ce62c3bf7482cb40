"""Device milliseconds per step launched by autograd's backward."""

from harness.trace import device_ms_under, per_unit


def read(ctx):
    return per_unit(device_ms_under(ctx.trace, "bench.backward"), ctx.trace)

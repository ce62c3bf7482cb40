"""Device milliseconds per frame launched by the shading entry itself:
under the ``bench.shade`` spans, less what the intersection backend and
the binning launched inside them."""

from harness.trace import device_ms_under, per_unit


def read(ctx):
    return per_unit(device_ms_under(ctx.trace, "bench.shade",
                                    exclude=("bench.trace", "bench.binning")),
                    ctx.trace)

"""The camera rays' closest hit as a share of its roofline: the least time
the frozen partition and binning say the frame's primary hit needs
(harness/roofline.py), over the device time launched under the
``bench.trace.primary`` spans, summed over the traced frames."""

from harness.trace import device_ms_under


def read(ctx):
    spent = device_ms_under(ctx.trace, "bench.trace.primary")
    bound = ctx.primary_bound_ms()
    if not spent or bound is None:
        return None
    return 100.0 * bound / spent

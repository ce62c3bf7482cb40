"""Device milliseconds per frame launched under the program's
``crt.tree.walk`` spans: the ``tree`` backend's lock-step KD walks (the
camera rays', the mirror bounces' and the shadow rays'), in a cell that
reports ``gi_frame_ms``."""

from harness.program_trace import program_spans
from harness.trace import device_ms_under, per_unit


def read(ctx):
    t = program_spans(ctx.trace)
    if t is None:
        return None
    return per_unit(device_ms_under(t, "crt.tree.walk"), ctx.trace)

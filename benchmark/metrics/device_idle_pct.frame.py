"""Share of the traced window in which no device operation ran."""

from harness.trace import busy_us


def read(ctx):
    if not ctx.trace.ops or ctx.trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - busy_us(ctx.trace) / ctx.trace.window_us)

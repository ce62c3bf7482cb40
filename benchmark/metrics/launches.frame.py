"""Kernel launches per frame in the traced window."""

from harness.trace import per_unit


def read(ctx):
    return per_unit(sum(1 for o in ctx.trace.ops if o.is_kernel) or None,
                    ctx.trace)

"""Device milliseconds per frame of the hand-written trace kernels, found
by the ``__global__`` names of the program's CUDA sources (every source
but the segment sum's, which runs in a backward)."""

from harness.trace import per_unit


def read(ctx):
    names = ctx.kernel_names(exclude_sources=("segsum.cu",))
    ms = sum(o.dur for o in ctx.trace.ops
             if any(n in o.name for n in names)) / 1e3
    return per_unit(ms or None, ctx.trace)

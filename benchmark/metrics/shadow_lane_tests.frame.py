"""Member tests per frame that the cluster path's shadow kernels issue:
the program's ``crt.shadow.lane_tests`` over the traced frames, the tests
of every lane of each warp that tested a batch (finished lanes included).
Fewer read means blocked lanes hold fewer warps; ``shadow_bound.py`` counts
what the answer needs."""

from harness.program_trace import counted
from harness.trace import per_unit


def read(ctx):
    return per_unit(counted("crt.shadow.lane_tests") or None, ctx.trace)

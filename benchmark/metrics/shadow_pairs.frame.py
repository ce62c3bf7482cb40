"""(Tile, cluster) pairs per frame of the cluster path's shadow lists:
the program's ``crt.shadow.pairs`` over the traced frames.  Tighter shaft
lists read fewer."""

from harness.program_trace import counted
from harness.trace import per_unit


def read(ctx):
    return per_unit(counted("crt.shadow.pairs") or None, ctx.trace)

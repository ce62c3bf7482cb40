"""Device-to-host reads per frame of the program's hot path: its
``crt.host_reads.*`` counters over the traced frames."""

from harness.program_trace import counted
from harness.trace import per_unit


def read(ctx):
    return per_unit(counted("crt.host_reads"), ctx.trace)

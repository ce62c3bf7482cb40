"""Share of the lanes the iterative wavefront shades that are live: the
program's ``crt.shade.live_lanes`` over ``crt.shade.lanes``, counted over
the traced frames."""

from harness.program_trace import program_counters


def read(ctx):
    c = program_counters()
    if not c or not c["crt.shade.lanes"]:
        return None
    return 100.0 * c["crt.shade.live_lanes"] / c["crt.shade.lanes"]

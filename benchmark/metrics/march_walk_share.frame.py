"""Share of the shadow lanes that enter the transmissive branch which the
split pass leaves to the bend-walk: the program's ``crt.march.walk_lanes``
over ``crt.march.lanes``, counted over the traced frames."""

from harness.program_trace import program_counters


def read(ctx):
    c = program_counters()
    if not c or not c["crt.march.lanes"]:
        return None
    return 100.0 * c["crt.march.walk_lanes"] / c["crt.march.lanes"]

"""Host milliseconds per step inside the program's ``crt.fit.backward``
spans: autograd's backward and the gradients' reduce, as the caller
waits for them."""

from harness.program_trace import program_spans
from harness.trace import per_unit, union_length


def read(ctx):
    t = program_spans(ctx.trace)
    if t is None or "crt.fit.backward" not in t.spans:
        return None
    return per_unit(union_length(t.spans["crt.fit.backward"]) / 1e3,
                    ctx.trace)

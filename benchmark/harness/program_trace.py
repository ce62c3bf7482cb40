"""What the program records of itself, as the per-layer readers take it:
its ``crt.`` spans (``crt_tpu_torch/utils/trace.py``), which the trace
keeps among its host operations, and its counters, which count while the
traced window's profiler records.

A checkout whose program has no such registry reads None here, never an
error: its readers then report nothing.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

from harness.trace import Trace

PREFIX = "crt."


def program_spans(trace: Trace) -> Trace | None:
    """``trace`` with the program's spans in place of the benchmark's, so
    that ``device_ms_under`` and ``spans_of`` read them; None where the
    trace holds none."""
    spans = defaultdict(list)
    for name, start, end in trace.host_ops:
        if name.startswith(PREFIX):
            spans[name].append((start, end))
    if not spans:
        return None
    return dataclasses.replace(
        trace, spans={k: sorted(v) for k, v in spans.items()})


def program_counters():
    """The program's counters (name -> int), or None where the program has
    no registry."""
    try:
        from crt_tpu_torch.utils import trace as tracing
    except ImportError:
        return None
    return tracing.counters()


def counted(prefix: str):
    """The sum of the program's counters named ``prefix`` or
    ``prefix.*``; None where the program has no registry."""
    c = program_counters()
    if c is None:
        return None
    return sum(v for k, v in c.items()
               if k == prefix or k.startswith(prefix + "."))

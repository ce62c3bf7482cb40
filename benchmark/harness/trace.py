"""The traced window as plain records, and the interval arithmetic the
per-layer readers share.

From ``torch.profiler`` the benchmark keeps three things (times in
microseconds on the profiler's clock):

  - device operations (kernels, copies, fills): name, start, end, and the
    time of the host call that launched them (matched by correlation id;
    the operation's own start where no launch is found);
  - the benchmark's spans (``record_function`` names starting "bench."):
    name, start, end, on the host;
  - the window: the first unit span's start to the last one's end.

A device operation is "under" a span when its launch lies inside one of
that span's intervals, whatever the thread (autograd's backward launches
from a thread of its own while the caller waits inside its span).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

SPAN_PREFIX = "bench."
_COPY_PREFIXES = ("Memcpy", "Memset")


@dataclass
class DeviceOp:
    name: str
    start: float
    end: float
    launch: float

    @property
    def dur(self) -> float:
        return self.end - self.start

    @property
    def is_kernel(self) -> bool:
        return not self.name.startswith(_COPY_PREFIXES)


@dataclass
class Trace:
    ops: list  # [DeviceOp], sorted by start
    spans: dict  # name -> [(start, end)]
    window: tuple  # (start, end)
    units: int
    host_ops: list = field(default_factory=list)  # [(name, start, end)]

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]


def _is_device(ev) -> bool:
    return str(ev.device_type).endswith(("CUDA", "PrivateUse1"))


def from_events(events, unit_span: str) -> Trace:
    """A Trace from ``prof.events()``; ``unit_span`` names the spans that
    mark the units of work."""
    launches = {}
    spans = defaultdict(list)
    dev = []
    host_ops = []
    for ev in events:
        start, end = ev.time_range.start, ev.time_range.end
        if _is_device(ev):
            if not getattr(ev, "is_user_annotation", False):
                dev.append(ev)
            continue
        if ev.name.startswith(SPAN_PREFIX):
            spans[ev.name].append((start, end))
        elif ev.name.startswith("cu"):
            launches[ev.id] = start
        else:
            host_ops.append((ev.name, start, end))
    ops = sorted((DeviceOp(ev.name, ev.time_range.start, ev.time_range.end,
                           launches.get(ev.id, ev.time_range.start))
                  for ev in dev), key=lambda o: o.start)
    units = sorted(spans.get(unit_span, []))
    window = (units[0][0], units[-1][1]) if units else (0.0, 0.0)
    return Trace(ops=ops, spans={k: sorted(v) for k, v in spans.items()},
                 window=window, units=len(units), host_ops=host_ops)


def union(intervals) -> list:
    """Sorted, merged copy of [(start, end)]."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def union_length(intervals, clip=None) -> float:
    """Length of the union of [(start, end)], within ``clip``."""
    total = 0.0
    for s, e in union(intervals):
        if clip is not None:
            s, e = max(s, clip[0]), min(e, clip[1])
        total += max(0.0, e - s)
    return total


class Cover:
    """Membership of points in the union of a set of intervals."""

    def __init__(self, intervals):
        self.iv = union(intervals)
        self.starts = [s for s, _ in self.iv]

    def __contains__(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.iv[i][1]


def spans_of(trace: Trace, prefix: str) -> list:
    """Every interval of every span whose name starts with ``prefix``."""
    return [iv for name, ivs in trace.spans.items() if name.startswith(prefix)
            for iv in ivs]


def device_ms_under(trace: Trace, prefix: str, exclude=()) -> float | None:
    """Device milliseconds of the operations launched under spans named
    ``prefix``*, less those launched under any span of ``exclude``
    (prefixes); None where no such span or no device operation was
    recorded."""
    inside = spans_of(trace, prefix)
    if not inside or not trace.ops:
        return None
    cover = Cover(inside)
    skip = Cover([iv for p in exclude for iv in spans_of(trace, p)])
    return sum(o.dur for o in trace.ops
               if o.launch in cover and o.launch not in skip) / 1e3


def busy_us(trace: Trace) -> float:
    """Time in the window in which some device operation ran."""
    return union_length([(o.start, o.end) for o in trace.ops], trace.window)


def per_unit(value, trace: Trace):
    return None if value is None or trace.units == 0 else value / trace.units


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps of
    the window summed by what the host was doing: the innermost benchmark
    span around the gap and the longest host operation overlapping it."""
    by_name = defaultdict(float)
    for o in trace.ops:
        by_name[o.name] += o.dur
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = union([(o.start, o.end) for o in trace.ops])
    gaps, t = [], trace.window[0]
    for s, e in busy:
        if s > t:
            gaps.append((t, min(s, trace.window[1])))
        t = max(t, e)
    if t < trace.window[1]:
        gaps.append((t, trace.window[1]))
    spans = sorted(((s, e, n) for n, ivs in trace.spans.items()
                    for s, e in ivs), key=lambda x: x[0])
    host = sorted(trace.host_ops, key=lambda x: x[1])
    host_starts = [h[1] for h in host]
    by_gap = defaultdict(float)
    for s, e in gaps:
        if e <= s:
            continue
        mid = 0.5 * (s + e)
        around = [(b - a, n) for a, b, n in spans if a <= mid <= b]
        label = min(around)[1] if around else "-"
        best, best_len = "-", 0.0
        i = bisect.bisect_right(host_starts, e)
        for name, hs, he in host[max(0, i - 400):i]:
            ov = min(he, e) - max(hs, s)
            if ov > best_len and not name.startswith(SPAN_PREFIX):
                best, best_len = name, ov
        by_gap[f"{label} / {best}"] += e - s
    gaps_top = sorted(by_gap.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v / 1e6] for n, v in ops],
            "idle_gaps": [[n, v / 1e6] for n, v in gaps_top]}

"""The idle union and the span arithmetic on synthetic intervals."""

import bench_setup  # noqa: F401  (the import path)

from harness.registry import metric_reader
from harness.trace import (Cover, DeviceOp, Trace, busy_us, device_ms_under,
                           union_length)


def _trace():
    ops = [DeviceOp("k_shade", 10, 20, 5), DeviceOp("k_trace", 25, 35, 22),
           DeviceOp("k_bin", 30, 40, 24), DeviceOp("Memcpy HtoD", 50, 52, 49),
           DeviceOp("k_late", 90, 100, 80)]
    spans = {"bench.frame": [(0, 60), (60, 120)],
             "bench.shade": [(2, 58)],
             "bench.trace.primary": [(21, 30)],
             "bench.binning": [(23, 26)]}
    return Trace(ops=ops, spans=spans, window=(0, 120), units=2)


def test_union_and_cover():
    assert union_length([(0, 10), (5, 15), (20, 25)]) == 20
    assert union_length([(0, 10), (5, 15)], clip=(8, 12)) == 4
    c = Cover([(0, 10), (5, 15), (20, 25)])
    assert 12 in c and 20 in c and 17 not in c and -1 not in c


def test_busy_and_idle():
    t = _trace()
    # 10-20, 25-40, 50-52, 90-100: 37 us busy of 120
    assert busy_us(t) == 37
    ctx = type("Ctx", (), {"trace": t})
    idle = metric_reader("device_idle_pct.frame")(ctx)
    assert abs(idle - 100 * (1 - 37 / 120)) < 1e-12


def test_self_time_under_spans():
    t = _trace()
    # shade's self time: k_shade and the copy; k_trace (under the trace
    # span) and k_bin (under binning) are excluded; k_late is outside
    assert device_ms_under(t, "bench.shade",
                           exclude=("bench.trace", "bench.binning")) == 0.012
    assert device_ms_under(t, "bench.trace") == 0.020
    assert device_ms_under(t, "bench.binning") == 0.010
    assert device_ms_under(t, "bench.backward") is None
    ctx = type("Ctx", (), {"trace": t})
    assert metric_reader("shade_device_ms.frame")(ctx) == 0.006
    assert metric_reader("launches.frame")(ctx) == 2.0


def test_nothing_to_read_reads_nothing():
    t = Trace(ops=[], spans={"bench.frame": [(0, 1)]}, window=(0, 1),
              units=1)
    ctx = type("Ctx", (), {"trace": t})
    for name in ("launches.frame", "device_idle_pct.frame",
                 "shade_device_ms.frame", "binning_device_ms.frame"):
        assert metric_reader(name)(ctx) is None

"""The ``shadow_lane_tests.frame`` reader: nothing from a program whose
shadow kernels count no lane tests (the CPU's plain versions, or a parent
without the counter), and the counted tests a traced frame where they
count."""

import torch

from bench_setup import tiny_cell  # noqa: F401  (the import path)

from harness.registry import load_benchmark, metric_reader
from harness.trace import DeviceOp, Trace


class _Ctx:
    unit = "frame"

    def __init__(self, trace):
        self.trace = trace


def _trace(units):
    ops = [DeviceOp("k", 0.0, 4.0, 1.0)]
    return Trace(ops=ops, spans={}, window=(0.0, 10.0), units=units,
                 host_ops=[])


def test_reads_nothing_without_the_counter():
    from crt_tpu_torch.utils import trace as tracing

    tracing.reset()
    assert metric_reader("shadow_lane_tests.frame")(_Ctx(_trace(2))) is None


def test_reads_the_counted_tests_a_frame():
    from crt_tpu_torch.utils import trace as tracing

    tracing.reset()
    with tracing.recording():
        tracing.count("crt.shadow.lane_tests", torch.tensor([6144]))
        ctx = _Ctx(_trace(3))
        assert metric_reader("shadow_lane_tests.frame")(ctx) == 2048
    tracing.reset()


def test_the_entry_lists_the_65536_triangle_cell():
    entry = {m["name"]: m for m in load_benchmark()["per_layer"]}[
        "shadow_lane_tests.frame"]
    assert entry["workloads"] == ["tri65k.frames"]
    assert entry["moves"] == "gi_frame_ms"

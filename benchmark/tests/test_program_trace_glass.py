"""The readers of a glass frame's program spans and counters:
``march_device_ms.frame`` (the ``crt.shade.march`` spans),
``march_walk_share.frame`` (``crt.march.walk_lanes`` over
``crt.march.lanes``) and ``shade_live_share.frame`` (the pool's live
lanes, ``pool_live_share.gi_frame``'s reader) on synthetic traces and
planted counters, on a program that records none of them (they read
nothing, and raise nothing), and in a traced CPU run of the tiny glass
cell."""

import sys

import pytest
import torch

from bench_setup import tiny_cell

import run
from harness.registry import metric_reader
from harness.trace import DeviceOp, Trace

from crt_tpu_torch import utils as program_utils
from crt_tpu_torch.utils import trace as tracing

GLASS_METRICS = ("march_device_ms.frame", "march_walk_share.frame",
                 "shade_live_share.frame")


def _ctx(trace):
    return type("Ctx", (), {"trace": trace})


def _trace():
    """Two frames; device ops launched at 5, 22, 24, 49 and 80 us; the
    march spans hold the launches at 22 and 24 (inside a trace span of
    their own) and 80."""
    ops = [DeviceOp("k_sort", 10, 20, 5), DeviceOp("k_glass", 25, 35, 22),
           DeviceOp("k_walk", 30, 40, 24), DeviceOp("Memcpy HtoD", 50, 52, 49),
           DeviceOp("k_late", 90, 96, 80)]
    host = [("crt.frame", 0, 60), ("crt.shade.bounce.0", 1, 59),
            ("crt.shade.march", 20, 30), ("crt.trace", 21, 23),
            ("aten::nonzero", 40, 45), ("crt.frame", 60, 120),
            ("crt.shade.march", 75, 85)]
    return Trace(ops=ops, spans={"bench.frame": [(0, 60), (60, 120)]},
                 window=(0, 120), units=2, host_ops=host)


@pytest.fixture
def planted():
    """Counters as a traced glass window leaves them."""
    tracing.reset()
    with tracing.recording():
        tracing.count("crt.shade.lanes", 800)
        tracing.count("crt.shade.live_lanes",
                      torch.ones(100, dtype=torch.bool))
        tracing.count("crt.march.lanes", torch.ones(400, dtype=torch.bool))
        tracing.count("crt.march.walk_lanes",
                      torch.ones(8, dtype=torch.bool))
        yield
    tracing.reset()


def test_march_device_ms_reads_the_march_spans():
    # k_glass (10 us), k_walk (10) and k_late (6): 26 us over two frames
    assert metric_reader("march_device_ms.frame")(_ctx(_trace())) == 0.013


def test_counter_readers_on_planted_counters(planted):
    ctx = _ctx(_trace())
    assert metric_reader("march_walk_share.frame")(ctx) == 2.0
    assert metric_reader("shade_live_share.frame")(ctx) == 12.5
    assert metric_reader("shade_live_share.frame")(ctx) == \
        metric_reader("pool_live_share.gi_frame")(ctx)


def test_nothing_to_read_reads_nothing():
    """A frame with no glass: no march span and no march lanes."""
    t = Trace(ops=[DeviceOp("k", 0, 1, 0)], spans={"bench.frame": [(0, 1)]},
              window=(0, 1), units=1, host_ops=[("crt.frame", 0, 1)])
    tracing.reset()
    for name in GLASS_METRICS:
        assert metric_reader(name)(_ctx(t)) is None


def test_a_program_without_the_registry_reads_nothing(monkeypatch, planted):
    monkeypatch.delattr(program_utils, "trace")
    monkeypatch.setitem(sys.modules, "crt_tpu_torch.utils.trace", None)
    t = Trace(ops=[DeviceOp("k", 0, 1, 0)], spans={"bench.frame": [(0, 1)]},
              window=(0, 1), units=1, host_ops=[("aten::add", 0, 1)])
    for name in GLASS_METRICS:
        assert metric_reader(name)(_ctx(t)) is None


def test_traced_cpu_run_of_the_glass_cell_reads_the_program():
    """The counter readers read the program; the CPU trace has no device
    operations, so the device-time reader reads nothing."""
    tracing.reset()
    res = run.run_cell(tiny_cell("quads64.glass_frames"), 2 ** 31 + 11, 0.2,
                       True, torch.device("cpu"))
    m = res["metrics"]
    assert 0 < m["march_walk_share.frame"]["value"] < 100
    assert 0 < m["shade_live_share.frame"]["value"] < 100
    assert m["host_reads.gi_frame"]["value"] > 0
    assert "march_device_ms.frame" not in m
    tracing.reset()

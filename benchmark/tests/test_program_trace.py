"""The readers of the program's own spans and counters: on synthetic
traces with ``crt.`` host spans and planted counters, on a program with
no registry (they read nothing, and raise nothing), and in a traced CPU
run of the tiny cells."""

import sys

import pytest
import torch

from bench_setup import tiny_cell

import run
from harness.registry import metric_reader
from harness.trace import DeviceOp, Trace

from crt_tpu_torch import utils as program_utils
from crt_tpu_torch.utils import trace as tracing

FRAME_METRICS = ("tables_device_ms.frame", "pool_live_share.gi_frame",
                 "host_reads.frame")
STEP_METRICS = ("host_reads.step", "backward_host_ms.step")


def _ctx(trace):
    return type("Ctx", (), {"trace": trace})


def _trace():
    """Two frames; device ops launched at 5, 22, 24, 49 and 80 us."""
    ops = [DeviceOp("k_sort", 10, 20, 5), DeviceOp("k_trace", 25, 35, 22),
           DeviceOp("k_fuse", 30, 40, 24), DeviceOp("Memcpy HtoD", 50, 52, 49),
           DeviceOp("k_late", 90, 100, 80)]
    host = [("crt.frame", 0, 60), ("crt.tables.cluster", 2, 8),
            ("crt.trace.primary", 21, 30), ("crt.tables.stream", 23, 26),
            ("aten::nonzero", 40, 45), ("crt.frame", 60, 120),
            ("crt.tables.cluster", 75, 85), ("crt.fit.backward", 61, 71),
            ("crt.fit.backward", 100, 104)]
    return Trace(ops=ops, spans={"bench.frame": [(0, 60), (60, 120)]},
                 window=(0, 120), units=2, host_ops=host)


@pytest.fixture
def planted():
    """Counters as a traced window leaves them."""
    tracing.reset()
    with tracing.recording():
        tracing.count("crt.shade.lanes", 400)
        tracing.count("crt.shade.live_lanes",
                      torch.ones(100, dtype=torch.bool))
        tracing.count("crt.host_reads.stream_nonzero", 30)
        tracing.count("crt.host_reads.march.any", 4)
        tracing.count("crt.launches.closest_hit", 9)
        yield
    tracing.reset()


def test_span_readers_on_synthetic_spans():
    ctx = _ctx(_trace())
    # k_sort (launch 5, in 2-8), k_fuse (24, in 23-26, inside the primary
    # trace), k_late (80, in 75-85): 30 us over two frames
    assert metric_reader("tables_device_ms.frame")(ctx) == 0.015
    # 10 + 4 us of backward spans over two units
    assert metric_reader("backward_host_ms.step")(ctx) == 0.007


def test_counter_readers_on_planted_counters(planted):
    ctx = _ctx(_trace())
    assert metric_reader("pool_live_share.gi_frame")(ctx) == 25.0
    assert metric_reader("host_reads.frame")(ctx) == 17.0
    assert metric_reader("host_reads.step")(ctx) == 17.0


@pytest.mark.parametrize("name", [
    "frame_ms", "launches.frame", "device_idle_pct.frame",
    "shade_device_ms.frame", "binning_device_ms.frame",
    "trace_kernel_ms.frame", "primary_hit_roofline",
    "tables_device_ms.frame", "host_reads.frame"])
def test_the_gi_cell_reads_as_the_other_frame_cells(name, planted):
    """Its metrics are the frame cells' readers under names of its own."""
    gi = "gi_frame_ms" if name == "frame_ms" \
        else name.removesuffix(".frame") + ".gi_frame"
    ctx = _ctx(_trace())
    ctx.window = type("W", (), {"seconds": 0.5, "units": 2})
    ctx.primary_bound_ms = staticmethod(lambda: 0.001)
    ctx.kernel_names = staticmethod(lambda exclude_sources: {"k_trace"})
    assert metric_reader(gi)(ctx) == metric_reader(name)(ctx)


def test_nothing_to_read_reads_nothing():
    t = Trace(ops=[], spans={"bench.frame": [(0, 1)]}, window=(0, 1),
              units=1, host_ops=[("aten::add", 0, 1)])
    tracing.reset()
    for name in ("tables_device_ms.frame", "pool_live_share.gi_frame",
                 "backward_host_ms.step"):
        assert metric_reader(name)(_ctx(t)) is None
    # a registry that counted no read: none a unit
    assert metric_reader("host_reads.frame")(_ctx(t)) == 0.0


def test_a_program_without_the_registry_reads_nothing(monkeypatch, planted):
    """The parent of the registry: its readers return None, never raise."""
    monkeypatch.delattr(program_utils, "trace")
    monkeypatch.setitem(sys.modules, "crt_tpu_torch.utils.trace", None)
    t = Trace(ops=[DeviceOp("k", 0, 1, 0)], spans={"bench.frame": [(0, 1)]},
              window=(0, 1), units=1, host_ops=[("aten::add", 0, 1)])
    for name in FRAME_METRICS + STEP_METRICS:
        assert metric_reader(name)(_ctx(t)) is None


@pytest.mark.parametrize("name", ["quads64.gi_frames", "quads64.fit"])
def test_traced_cpu_run_reads_the_program(name):
    """A tiny traced run on the CPU: the counter readers and the host-time
    reader read the program (the CPU trace has no device operations, so
    the device-time reader reads nothing)."""
    tracing.reset()
    res = run.run_cell(tiny_cell(name), 2 ** 31 + 11, 0.2, True,
                       torch.device("cpu"))
    m = res["metrics"]
    if name == "quads64.gi_frames":
        assert 0 < m["pool_live_share.gi_frame"]["value"] <= 100
        # the GI streams' salts and the pool's pad, copied to the device
        assert m["host_reads.gi_frame"]["value"] > 0
        assert "tables_device_ms.gi_frame" not in m
    else:
        # the loss a step (float(loss) in fit_scene)
        assert m["host_reads.step"]["value"] == 1.0
        assert m["backward_host_ms.step"]["value"] > 0
    tracing.reset()

"""The ``tri65k_1080p`` configuration and its ``tri65k.frames`` cell at the
tests' size: a soup cell on the cluster path runs ``correct`` against the
reference and the shadow-list fault fails its limit; the frozen shadow
bound counts what a brute-force trace and the port's shaft lists count;
and the new per-layer readers read nothing from a program without the
shadow span and counters."""

import json

import numpy as np
import pytest
import torch

from bench_setup import BENCH, tiny_cell

import run
from harness import driver, roofline, scenes
from harness import shadow_bound as sb
from harness.faults_shadow import SHADOW_FAULTS, planted
from harness.registry import metric_reader
from harness.trace import DeviceOp, Trace
from reference.render import Renderer, camera_rays

CPU = torch.device("cpu")
LIMIT = json.loads((BENCH / "checks" / "tri65k.frames.json").read_text()
                   )["limits"]["px_off_share"]


def _cell(width, height, triangles, frames=2, warmup=None):
    cell = tiny_cell("tri65k.frames")
    cell.config["scene"].update(width=width, height=height,
                                num_triangles=triangles)
    cell.config["settings"]["backend"] = "cluster"
    cell.check.update(pixels=width * height, frames=frames)
    if warmup is not None:
        cell.traffic["warmup_units"] = warmup
    return cell


def test_the_configuration_is_the_soup_at_65536_triangles():
    cell = tiny_cell("tri65k.frames")
    full = json.loads((BENCH / "configs" / "tri65k_1080p.json").read_text())
    assert full["scene"] == {"kind": "soup", "width": 1920, "height": 1080,
                             "num_triangles": 65536, "layout_seed": 0}
    assert full["clusters"] == 65536 // roofline.CLUSTER_SIZE
    from crt_tpu_torch.renderer import auto_backend

    assert auto_backend(full["clusters"], on_card=True) == "cluster"
    assert cell.traffic["unit"] == "frame" and not cell.traffic["gi"]
    # host-bound enough that it reports the rate of the host-bound frame
    # cells, with their bound
    assert {m["name"] for m in cell.end_to_end} == {"gi_frame_ms",
                                                    "peak_mem_gib", "setup_s"}


def test_a_small_cluster_soup_cell_is_correct():
    res = run.run_cell(_cell(64, 48, 4096), 2 ** 31 + 17, 0.3, False, CPU)
    assert res["correct"], res["checks"]


def test_cut_shadow_lists_is_caught():
    """At 65,536 triangles, where the soup casts enough shadows for a
    64 x 48 frame to hold some; one frame checked, no warm-up, to keep the
    CPU's plain trace short."""
    cell = _cell(64, 48, 65536, frames=1, warmup=0)
    with planted("cut_shadow_lists"):
        res = run.run_cell(cell, 7, 0.0, False, CPU)
    assert not res["correct"], res["checks"]
    assert res["checks"]["px_off_share"]["value"] > LIMIT


def test_the_fault_is_put_back_and_the_others_pass_through():
    from crt_tpu_torch import renderer
    from crt_tpu_torch.ops import cluster_trace

    before = cluster_trace.bin_apex_shared
    with planted(SHADOW_FAULTS[0]):
        assert cluster_trace.bin_apex_shared is not before
    assert cluster_trace.bin_apex_shared is before
    real = renderer.render_image
    with planted("altered"):
        assert renderer.render_image is not real
    assert renderer.render_image is real


def _soup(width, height, triangles):
    desc = scenes.soup_arrays({"kind": "soup", "width": width,
                               "height": height,
                               "num_triangles": triangles, "layout_seed": 0})
    return desc, scenes.reference_scene("soup", desc)


def test_partition_is_roofline_and_the_ports():
    from crt_tpu_torch.ops.cluster_tables import build_cluster_tables

    desc, ref_scene = _soup(64, 64, 5000)
    r = Renderer(ref_scene, dtype=torch.float32)
    ids, real, lo, hi = sb.partition(r.params["vertices"], r.tri)
    rlo, rhi, members = roofline.cluster_boxes(r.params["vertices"], r.tri)
    assert torch.equal(lo, rlo) and torch.equal(hi, rhi)
    assert torch.equal(real.sum(dim=1), members)
    t = build_cluster_tables(scenes.program_scene("soup", desc, CPU))
    assert torch.equal(torch.where(real, ids, -1), t.tri_id.long())
    assert torch.equal(lo, t.cl_min) and torch.equal(hi, t.cl_max)


def test_member_tests_equal_a_brute_force_count():
    """Hits and blockers by the reference's brute force over every
    triangle, lists by the port's ``bin_apex_shared``: the same rule
    counts the same tests, pairs, active and blocked lanes."""
    from crt_tpu_torch.ops.binning import bin_apex_shared
    from crt_tpu_torch.ops.cluster_tables import build_cluster_tables

    W = H = 64
    desc, ref_scene = _soup(W, H, 20000)
    r = Renderer(ref_scene, dtype=torch.float32)
    rot = np.eye(3, dtype=np.float32)
    got = sb.shadow_hit_bound(r, rot)

    px, py, real = sb._tiles(H, W, CPU)
    assert bool(real.all())
    o, d = camera_rays(px.reshape(-1), py.reshape(-1), W, H,
                       ref_scene.tan_half_fov, r.params["cam_position"], rot)
    t, tri = r.closest(o, d)
    hit = tri >= 0
    n = r.g_n[tri.clamp(min=0)]
    p = torch.where(hit[:, None], o + d * t[:, None], 0.0)
    lv = r.light_pos[0] - p
    r2 = (lv * lv).sum(-1)
    ld = lv / torch.sqrt(r2)[:, None]
    active = hit & ((ld * n).sum(-1) > 0.0)
    so = p + n * sb.SHADOW_BIAS
    st, _ = r.closest(so, ld)
    blocked = active & torch.isfinite(st) & (st * st <= r2)

    tables = build_cluster_tables(scenes.program_scene("soup", desc, CPU))
    cl, cnt = bin_apex_shared(tables, so.contiguous(), r.light_pos,
                              active[None], 1024, sb.ORIGIN_SLACK)
    members = (tables.tri_id >= 0).sum(dim=1)
    on = torch.arange(cl.shape[1])[None] < cnt[:, None]
    per_tile = (members[cl.long()] * on).sum(dim=1)
    a, b = active.reshape(-1, 1024), blocked.reshape(-1, 1024)
    tests = int(((a & ~b).sum(dim=1) * per_tile).sum() + b.sum())
    assert int(blocked.sum()) > 0
    assert got["member_tests"] == tests > 0
    assert got["pairs"] == int(cnt.sum())
    assert got["active"] == int(active.sum())
    assert got["blocked"] == int(blocked.sum())
    assert got["bound_ms"] > 0


def _trace_with(spans):
    ops = [DeviceOp("k", 10.0 * i, 10.0 * i + 4.0, 10.0 * i + 1.0)
           for i in range(10)]
    return Trace(ops=ops, spans={}, window=(0.0, 100.0), units=2,
                 host_ops=[(n, s, e) for n, s, e in spans])


class _Ctx:
    unit = "frame"

    def __init__(self, trace):
        self.trace = trace


@pytest.mark.parametrize("name", ["shadow_device_ms.frame",
                                  "shadow_device_ms.gi_frame",
                                  "shadow_pairs.frame",
                                  "shadow_hit_roofline.frame"])
def test_readers_read_nothing_without_the_span_and_counters(name):
    """The parent program records no ``crt.trace.shadow`` span and no
    ``crt.shadow.*`` counter: its runs read None, and raise nothing."""
    from crt_tpu_torch.utils import trace as tracing

    tracing.reset()
    ctx = _Ctx(_trace_with([("crt.trace", 0.0, 50.0)]))
    assert metric_reader(name)(ctx) is None


def test_shadow_device_ms_reads_the_span():
    ctx = _Ctx(_trace_with([("crt.trace.shadow", 0.0, 25.0),
                            ("crt.trace", 30.0, 50.0)]))
    # kernels 0-2 launch inside the span, 4 us each, over 2 frames
    assert metric_reader("shadow_device_ms.frame")(ctx) == pytest.approx(
        3 * 4.0 / 1e3 / 2)


def test_traced_tiny_cell_reads_the_shadow_counters():
    res = run.run_cell(_cell(64, 48, 4096), 2 ** 31 + 17, 0.3, True, CPU)
    assert res["correct"], res["checks"]
    assert res["metrics"]["shadow_pairs.frame"]["value"] > 0
    assert {m["name"] for m in _cell(8, 8, 16).per_layer} >= {
        "shadow_device_ms.gi_frame", "shadow_pairs.frame",
        "shadow_hit_roofline.frame"}


def test_bound_and_reader_on_a_traced_window():
    """The reader's bound: the first traced frame's, once a frame."""
    cell = _cell(64, 32, 4096)
    r = driver.make(cell, CPU, 11, 0.0)
    w = r.run(0.0, False)
    ref = Renderer(r.ref_scene, dtype=torch.float32)
    one = sb.shadow_hit_bound(ref, r.traced_cameras(w)[0])["bound_ms"]
    w.trace = _trace_with([("crt.trace.shadow", 0.0, 100.0)])

    class Ctx(_Ctx):
        runner, window = r, w

    got = metric_reader("shadow_hit_roofline.frame")(Ctx(w.trace))
    assert got == pytest.approx(100.0 * one * w.units / (10 * 4.0 / 1e3))

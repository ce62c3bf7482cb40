"""The ``quads64_tree_1080p`` configuration and its ``quads64.tree_frames``
cell at the tests' size: the quads scene through the KD tree runs
``correct`` against the reference and the shrunk-box fault fails its
limit; the frozen builder of ``harness/tree_bound.py`` gives the
program's tree, and its bound prunes at the hits the program finds; and
the new per-layer readers read nothing from a program without the walk's
span and counter."""

import json
import math

import numpy as np
import pytest
import torch

from bench_setup import BENCH, added_cell, tiny_cell

import run
from harness import driver, scenes
from harness import tree_bound as tb
from harness.faults_tree import TREE_FAULTS, planted
from harness.registry import load_benchmark, metric_reader
from harness.trace import DeviceOp, Trace
from reference.render import Renderer, camera_rays

CPU = torch.device("cpu")
CHECK = json.loads((BENCH / "checks" / "quads64.tree_frames.json").read_text())
LIMIT = CHECK["limits"]["px_off_share"]
NEW = ("tree_walk_device_ms.gi_frame", "tree_leaf_lanes.frame",
       "tree_primary_roofline.frame")
FIELDS = ("node_min", "node_max", "node_children", "node_leaf_id",
          "leaf_tris")


def _config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def _cell(width, height, frames=2, warmup=None):
    cell = tiny_cell("quads64.tree_frames")
    cell.config["scene"].update(width=width, height=height)
    cell.check.update(pixels=width * height, frames=frames)
    if warmup is not None:
        cell.traffic["warmup_units"] = warmup
    return cell


def test_the_configuration_is_the_quads_scene_through_the_tree():
    tree, quads = _config("quads64_tree_1080p"), _config("quads64_1080p")
    assert tree["scene"] == quads["scene"]
    assert tree["settings"] == {**quads["settings"], "backend": "tree"}
    assert tree["reduced"] == [] and tree["triangles"] == quads["triangles"]
    cell = tiny_cell("quads64.tree_frames")
    assert cell.traffic["unit"] == "frame" and not cell.traffic["gi"]
    assert {m["name"] for m in cell.end_to_end} == {"gi_frame_ms",
                                                    "peak_mem_gib", "setup_s"}
    layer = {m["name"] for m in cell.per_layer}
    assert layer >= set(NEW) | {"launches.gi_frame", "host_reads.gi_frame",
                                "shadow_device_ms.gi_frame"}
    # the tree launches no Phase A and no trace kernel, and the primary
    # roofline's bound is the cluster path's
    assert not layer & {"primary_hit_roofline.gi_frame",
                        "trace_kernel_ms.gi_frame",
                        "binning_device_ms.gi_frame"}
    for m in load_benchmark()["per_layer"]:
        if m["name"] in NEW:
            assert m["workloads"] == ["quads64.tree_frames"]
            assert m["moves"] == "gi_frame_ms"


def test_a_small_tree_cell_is_correct_through_added_cell(tmp_path):
    cell = added_cell(tmp_path, "quads64.tree_small",
                      ("quads64_tree_small", _config("quads64_tree_1080p")),
                      ("frames", None), CHECK)
    cell.config["scene"].update(width=64, height=48)
    cell.check.update(pixels=64 * 48)
    assert driver.make(cell, CPU, 3, 0.0).scene.accel is not None
    res = run.run_cell(cell, 2 ** 31 + 17, 0.3, False, CPU)
    assert res["correct"], res["checks"]


def test_shrunk_boxes_is_caught():
    cell = _cell(64, 48, frames=1, warmup=0)
    with planted("shrunk_boxes"):
        res = run.run_cell(cell, 7, 0.0, False, CPU)
    assert not res["correct"], res["checks"]
    assert res["checks"]["px_off_share"]["value"] > LIMIT


def test_the_fault_is_put_back_and_the_others_pass_through():
    from crt_tpu_torch import renderer
    from crt_tpu_torch.ops import traverse

    before = traverse.closest_hit_tree
    with planted(TREE_FAULTS[0]):
        assert traverse.closest_hit_tree is not before
    assert traverse.closest_hit_tree is before
    real = renderer.render_image
    with planted("altered"):
        assert renderer.render_image is not real
    assert renderer.render_image is real


def _scene(kind):
    if kind == "quads":
        desc = scenes.quads_description(
            {**_config("quads64_tree_1080p")["scene"], "width": 64,
             "height": 48})
    else:
        desc = scenes.soup_arrays({"width": 64, "height": 48,
                                   "num_triangles": 4096, "layout_seed": 0})
    return scenes.reference_scene(kind, desc)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("kind", ["quads", "soup"])
def test_frozen_builder_is_the_programs(kind, native):
    from crt_tpu_torch.scene.accel import build_accel_tree

    s = _scene(kind)
    v = s.params["vertices"].astype(np.float32)
    want = build_accel_tree(v, s.tri, use_native=native, device="cpu")
    got = tb.build_tree(v, s.tri)
    for f in FIELDS:
        assert np.array_equal(got[f], getattr(want, f).numpy()), f
    assert got["leaf_tris"].shape[1] == want.leaf_size


def _rays(s, ref, rot):
    py, px = torch.meshgrid(torch.arange(s.height), torch.arange(s.width),
                            indexing="ij")
    o, d = camera_rays(px.reshape(-1), py.reshape(-1), s.width, s.height,
                       s.tan_half_fov, ref.params["cam_position"], rot)
    return o.contiguous(), d


def _frozen(s):
    v = s.params["vertices"].astype(np.float32)
    return {k: torch.from_numpy(a) for k, a in tb.build_tree(v, s.tri).items()}


def _unpruned(tree, o, d):
    return tb.entered(tree, o, d, torch.full((o.shape[0],), math.inf))


@pytest.mark.parametrize("kind", ["quads", "soup"])
def test_bound_takes_the_hits_the_program_finds(kind):
    """The reference's closest hits, at which the bound prunes, are the
    triangles the program's walk finds; the bound counts fewer box and
    member tests than a walk that does not prune, and fewer member tests
    than the program's leaf tests take slots."""
    from crt_tpu_torch.ops import traverse
    from crt_tpu_torch.scene.accel import build_accel_tree
    from crt_tpu_torch.utils import trace as tracing

    s = _scene(kind)
    ref = Renderer(s, dtype=torch.float32)
    o, d = _rays(s, ref, np.eye(3, dtype=np.float32))
    v = s.params["vertices"].astype(np.float32)
    accel = build_accel_tree(v, s.tri, device="cpu")
    table = traverse.build_triangle_gather(
        torch.from_numpy(v), torch.from_numpy(s.tri), ref.t_backface)
    with tracing.recording() as counts:
        hit = traverse.closest_hit_tree(accel, table, o, d)
    t_ref, tri_ref = ref.closest(o, d)
    assert torch.equal(hit.tri.long(), tri_ref)
    assert (tri_ref >= 0).any() and (tri_ref < 0).any()
    tree = _frozen(s)
    boxes, tests = tb.entered(tree, o, d, t_ref)
    all_boxes, all_tests = _unpruned(tree, o, d)
    assert 0 < boxes < all_boxes and 0 < tests < all_tests
    assert tests < counts["crt.tree.leaf_lanes"] * accel.leaf_size


def test_bound_counts_what_an_exact_walk_enters():
    s = _scene("quads")
    ref = Renderer(s, dtype=torch.float32)
    rot = np.eye(3, dtype=np.float32)
    b = tb.primary_walk_bound(ref, rot)
    tree = _frozen(s)
    assert b["rays"] == s.width * s.height and 0 < b["hits"] < b["rays"]
    assert (b["box_tests"], b["member_tests"]) == tb.entered(
        tree, *_rays(s, ref, rot), ref.closest(*_rays(s, ref, rot))[0])
    assert b["bound_ms"] == tb.bound_ms(
        b["bytes"], b["box_tests"] * tb.FLOPS_PER_BOX
        + b["member_tests"] * tb.FLOPS_PER_MEMBER)["bound_ms"] > 0
    # a camera turned up, away from the scene: every ray misses, and an
    # exact walk tests every box it meets
    away = np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0]], np.float32)
    miss = tb.primary_walk_bound(ref, away)
    assert miss["hits"] == 0
    assert (miss["box_tests"], miss["member_tests"]) == _unpruned(
        tree, *_rays(s, ref, away))


def _trace_with(spans):
    ops = [DeviceOp("k", 10.0 * i, 10.0 * i + 4.0, 10.0 * i + 1.0)
           for i in range(10)]
    return Trace(ops=ops, spans={}, window=(0.0, 100.0), units=2,
                 host_ops=[(n, s, e) for n, s, e in spans])


class _Ctx:
    unit = "frame"

    def __init__(self, trace):
        self.trace = trace


@pytest.mark.parametrize("name", NEW)
def test_readers_read_nothing_without_the_span_and_counters(name):
    """The parent program records no ``crt.tree.walk`` span and no
    ``crt.tree.leaf_lanes`` counter: its runs read None, and raise
    nothing, though its camera walk runs under ``crt.trace.primary``."""
    from crt_tpu_torch.utils import trace as tracing

    tracing.reset()
    ctx = _Ctx(_trace_with([("crt.trace.primary", 0.0, 50.0)]))
    assert metric_reader(name)(ctx) is None


def test_tree_walk_device_ms_reads_the_span():
    ctx = _Ctx(_trace_with([("crt.trace.primary", 0.0, 45.0),
                            ("crt.tree.walk", 0.0, 25.0),
                            ("crt.trace.shadow", 50.0, 70.0),
                            ("crt.tree.walk", 55.0, 65.0)]))
    # kernels 0-2 and 6 launch inside the walk spans, 4 us each, 2 frames
    assert metric_reader("tree_walk_device_ms.gi_frame")(ctx) == \
        pytest.approx(4 * 4.0 / 1e3 / 2)


def test_traced_tiny_cell_reads_the_leaf_lanes():
    from crt_tpu_torch.utils import trace as tracing

    tracing.reset()
    res = run.run_cell(_cell(48, 32), 2 ** 31 + 17, 0.3, True, CPU)
    assert res["correct"], res["checks"]
    assert res["metrics"]["tree_leaf_lanes.frame"]["value"] > 0
    assert res["metrics"]["host_reads.gi_frame"]["value"] > 0


def test_roofline_reader_on_a_traced_window():
    """The reader's bound: the first traced frame's, once a frame, over
    the device time under ``crt.trace.primary``."""
    cell = _cell(64, 32)
    r = driver.make(cell, CPU, 11, 0.0)
    w = r.run(0.0, False)
    ref = Renderer(r.ref_scene, dtype=torch.float32)
    one = tb.primary_walk_bound(ref, r.traced_cameras(w)[0])["bound_ms"]
    w.trace = _trace_with([("crt.trace.primary", 0.0, 100.0),
                           ("crt.tree.walk", 5.0, 95.0)])

    class Ctx(_Ctx):
        runner, window = r, w

    got = metric_reader("tree_primary_roofline.frame")(Ctx(w.trace))
    assert got == pytest.approx(100.0 * one * w.units / (10 * 4.0 / 1e3))
    assert 0 < got

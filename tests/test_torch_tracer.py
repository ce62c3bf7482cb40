"""The intersection backend's type (``ops/tracer.py``), on the CPU.

Every backend's ``shadow`` gives the masks of the base class's pass (the
closest hit of the stacked wavefront and a t^2 <= r^2 compare) on the
active lanes, on a wavefront of whole tiles, where the cluster and
streaming tracers take their kernels' plain versions, and on one that is
not, where they fall back to it.  Exact, except that the w form (K2) tests
parallelism with |n.w| where the closest hit tests |n.d|: its masks are
held to the base ones on all but a thousandth of the lanes, as
tests/test_torch_occlusion_d.py holds them to K5's.

A dropped tracer frees its tables when its last reference goes, with the
garbage collector off: no tracer refers to itself.
"""

import gc
import weakref

import pytest

from crt_tpu_torch import RenderSettings
from crt_tpu_torch.ops import camera, shade
from crt_tpu_torch.ops import cluster_trace as ttr
from crt_tpu_torch.ops import stream_trace as tst
from crt_tpu_torch.ops.tracer import Tracer
from crt_tpu_torch.parallel.scene_sharded import (
    build_partitioned_tables,
    make_partitioned_rows_fn,
    make_partitioned_trace_fn,
)
from crt_tpu_torch.parallel.sharded import OneDeviceMesh
from crt_tpu_torch.renderer import make_tiler, make_trace_fn
from crt_tpu_torch.scene.procedural import make_test_scene
from torch_port_fixtures import _one_torch_thread, _release_heap  # noqa: F401

SLACK = 2e-2


@pytest.fixture(scope="module")
def scene():
    return make_test_scene(64, 32, num_quads=16, with_edges=True,
                           device="cpu")


def _partitioned(scene, backend):
    tables, packed, shard_tris = build_partitioned_tables(
        scene, OneDeviceMesh(("rays", "scene")))
    return make_partitioned_trace_fn(
        tables, None, backend,
        read_rows=make_partitioned_rows_fn(packed, shard_tris, None, 0))


BACKENDS = {
    "empty": lambda s: make_trace_fn(s.replace(
        tri_vidx=s.tri_vidx[:0], tri_material=s.tri_material[:0]),
        RenderSettings()),
    "bruteforce": lambda s: make_trace_fn(s, RenderSettings(
        backend="bruteforce")),
    "tree": lambda s: make_trace_fn(s, RenderSettings(backend="tree")),
    "cluster_w": lambda s: ttr.make_cluster_trace_fn(s),
    "cluster_d": lambda s: ttr.make_cluster_trace_fn(s, shadow_kernel="d"),
    "cluster_anyhit": lambda s: ttr.make_cluster_trace_fn(
        s, shadow_kernel="anyhit"),
    "stream": lambda s: tst.make_stream_trace_fn(s),
    "stream_one_phase": lambda s: tst.make_stream_trace_fn(s, shadow_k=0),
    "partitioned_cluster": lambda s: _partitioned(s, "cluster"),
    "partitioned_stream": lambda s: _partitioned(s, "stream"),
}


def shadow_wavefront(scene, rays):
    """The two-light shadow wavefront of the first ``rays`` primary hits,
    as ``shade._occlusion_masks`` builds it: the arguments of
    ``Tracer.shadow``."""
    rx, ry, _ = make_tiler(scene.height, scene.width, device="cpu")
    o, d = camera.generate_rays(scene.cam_position, scene.cam_rotation,
                                scene.cam_tan_half_fov, scene.width,
                                scene.height, rx, ry)
    o, d = o[:rays].contiguous(), d[:rays].contiguous()
    hit = make_trace_fn(scene, RenderSettings(backend="bruteforce"))(o, d)
    attrs = shade.hit_attributes(scene, o, d, hit)
    lights = scene.light_position
    lv = lights[:, None, :] - attrs.point[None]
    ldir = lv / lv.norm(dim=-1, keepdim=True)
    facing = (ldir * attrs.normal[None]).sum(-1) > 0.0
    return (attrs.point, attrs.point + attrs.normal * (SLACK / 2), lights,
            ldir, (lv * lv).sum(-1), attrs.valid[None] & facing, SLACK)


@pytest.mark.parametrize("rays", [2048, 2000], ids=["tiles", "ragged"])
@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_shadow_equals_the_base_pass(scene, backend, rays):
    tracer = BACKENDS[backend](scene)
    args = shadow_wavefront(scene, rays)
    act = args[5]
    assert act.any() and not act.all()
    got = tracer.shadow(*args)
    want = Tracer.shadow(tracer, *args)
    assert got.shape == want.shape == act.shape
    differ = (got != want) & act
    if backend == "cluster_w" and rays % 1024 == 0:
        assert differ.float().mean() < 1e-3
    else:
        assert not differ.any()
    if backend != "empty":
        assert want[act].any() and not want[act].all()


@pytest.mark.parametrize("kind", ["cluster", "stream"])
def test_a_dropped_tracer_frees_its_tables(kind):
    """After a frame's calls (closest hit, rows, shadows), dropping the
    tracer frees its tables at once, without the garbage collector."""
    glass = make_test_scene(64, 32, num_quads=6, with_refractive=True,
                            device="cpu")
    args = shadow_wavefront(glass, 2048)
    o, d = args[1], args[3][0]
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        if kind == "cluster":
            tracer = ttr.make_cluster_trace_fn(glass)
            table = weakref.ref(tracer.tables.n)
            tracer.with_rows(o, d)
            assert tracer.shadow_glass(*args[:3], *args[5:]) is not None
        else:
            tracer = tst.make_stream_trace_fn(glass)
            table = weakref.ref(tracer.st.fused)
        tracer(o, d)
        tracer.shadow(*args)
        assert table() is not None
        del tracer
        assert table() is None
    finally:
        if was_enabled:
            gc.enable()

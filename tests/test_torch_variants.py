"""The tile-merged closest hit (K7) and the lane and rows table layouts of
the streaming kernels (K10, K11) vs crt_tpu.

``closest_hit_merged`` takes its plain version on CPU tensors; here it is
held to ``pallas_trace._closest_hit_binned_merged`` in Pallas interpret
mode at merge 2 and 4 (t, tri and emitted rows) and to K1's plain version
on the same lists.  The streaming wrappers in the lane and rows layouts are
held to interpret-mode ``closest_hit_stream_flat`` / ``occluded_stream_flat``
with ``layout=`` on tests/test_pallas_stream.py's setup and to the port's
fused results.  The cluster tracer built with ``tile_merge`` takes K7
where crt_tpu takes it (a tile count that divides by the merge, not the
compacted launch), so a frame with the merge equals the default image,
and equals ``crt_tpu.render_image(jit=False)`` run with
``CRT_TILE_MERGE=2``; a streaming frame in each layout equals the fused
frame.  (The CUDA kernels
themselves are held to the plain versions on the card by chip_smoke.py and
tests/test_torch_cuda.py.)

Tolerance: EXACT for lists, t, tri, rows and masks.  The JAX side runs in
two subprocesses side by side, whose XLA CPU target is capped below FMA
(``--xla_cpu_max_isa=AVX``), as tests/test_torch_trace_kernels.py explains;
crt_tpu reads ``CRT_TILE_MERGE`` when it is imported and bakes it into its
jit caches, so the subprocesses get it in their environment.  The crt_tpu
image is held at rtol 1e-5 / atol 1e-6 (tests/test_torch_render.py's
tolerance: its shading runs through XLA, the port's through torch).
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from crt_tpu_torch import RenderSettings, render_image
from crt_tpu_torch.renderer import _render_flat
from crt_tpu_torch.ops import binning as tbin
from crt_tpu_torch.ops import cluster_tables as tct
from crt_tpu_torch.ops import cluster_trace as ttr
from crt_tpu_torch.ops import stream_trace as tst
from crt_tpu_torch.scene.procedural import make_test_scene
from torch_port_fixtures import _one_torch_thread, _release_heap  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
MERGES = (2, 4)
# 4 tiles of 1024 rays; tile 1 switched off, so it has no list
MERGE_SCENE = dict(width=64, height=64, num_quads=16)
# tests/test_pallas_stream.py:109's setup: 2 tiles of 256 rays, sc = 4
STREAM_SCENE = dict(width=32, height=16, num_quads=40, with_reflective=False)
STREAM_TR, STREAM_SC = 256, 4
STREAM_APEX = [1.5, 2.5, 1.0]
# the opaque test scene at 2 tiles, so a merge of 2 applies
RENDER_SCENE = dict(width=64, height=32)

# Runs in two subprocesses side by side (CRT_TILE_MERGE=2), each taking
# parts of the JAX side ("merge", "stream", "render"), saved to an .npz.
_REF_SCRIPT = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
import crt_tpu
from crt_tpu import renderer
from crt_tpu.ops import camera
from crt_tpu.ops import pallas_stream as ps
from crt_tpu.ops import pallas_trace as pt
from crt_tpu.scene.procedural import make_test_scene

out_path, spec_path, parts = sys.argv[1:4]
parts = parts.split(",")
spec = json.load(open(spec_path))
assert pt._TILE_MERGE == 2
res = {}


def rays(s):
    rx, ry, _ = renderer.make_tiler(s.height, s.width)
    return camera.generate_rays(s.cam_position, s.cam_rotation,
                                s.cam_tan_half_fov, s.width, s.height, rx, ry)


if "merge" in parts:
    # K7: the merged launch on lists with empty tiles, tables built eagerly
    s = make_test_scene(**spec["merge_scene"])
    o, d = rays(s)
    tables = pt.build_cluster_tables(s)
    rows_table = pt.emit_rows_table(s, tables)
    R = o.shape[0]
    tiles = R // 1024
    act = (jnp.arange(R) // 1024) % 3 != 1
    res["merge/o"], res["merge/d"], res["merge/act"] = o, d, act

    def planes(x):
        return x.reshape(tiles, 1024, 3).swapaxes(1, 2)

    @jax.jit
    def merged(o, d, act):
        out = {}
        cl, cnt = pt.bin_rays(tables, o, d, 1024, act)
        out["cl"], out["cnt"] = cl[:, 0], cnt
        for m in spec["merges"]:
            bt, bi, br = pt._closest_hit_binned_merged(
                tables, planes(o), planes(d), cl, cnt, 1024, True,
                rows_table=rows_table, merge=m)
            out[f"{m}/t"], out[f"{m}/tri"] = bt.reshape(-1), bi.reshape(-1)
            out[f"{m}/rows"] = jnp.moveaxis(br, 1, 0).reshape(
                br.shape[1], -1)
        return out

    for k, v in merged(o, d, act).items():
        res["merge/" + k] = v

if "stream" in parts:
    # the lane and rows layouts (tests/test_pallas_stream.py:109); the
    # fused layout is held to crt_tpu by tests/test_torch_stream.py
    s = make_test_scene(**spec["stream_scene"])
    o, d = rays(s)
    TR = spec["tr"]
    tables, sc_min, sc_max = ps.build_supercluster_boxes(
        pt.build_cluster_tables(s), spec["sc"])
    r2 = jnp.full((o.shape[0],), 1e6, jnp.float32)
    active = jnp.ones((o.shape[0],), bool)
    apex = jnp.tile(jnp.asarray([spec["apex"]], jnp.float32),
                    (o.shape[0] // TR, 1))
    res["stream/o"], res["stream/d"] = o, d
    fused = ps.build_fused_table(tables)
    res["stream/lane"] = fused.reshape(-1, spec["sc"] * 16, 18).transpose(
        0, 2, 1)
    for layout in ("rows", "lane"):
        hit, total = ps.closest_hit_stream_flat(
            tables, sc_min, sc_max, o, d, None, tile_rays=TR, interpret=True,
            layout=layout)
        res[f"stream/{layout}/t"] = hit.t
        res[f"stream/{layout}/tri"] = hit.tri
        res[f"stream/{layout}/total"] = total
        res[f"stream/{layout}/occ"] = ps.occluded_stream_flat(
            tables, sc_min, sc_max, o, d, r2, active, apex,
            jnp.float32(0.02), tile_rays=TR, interpret=True, layout=layout)

if "render" in parts:
    # render_image with the merge: count the merged launches crt_tpu traces
    calls = []
    real = pt._closest_hit_binned_merged

    def counting(*args, **kw):
        calls.append(kw.get("merge"))
        return real(*args, **kw)

    pt._closest_hit_binned_merged = counting
    orig = renderer.make_trace_fn
    renderer.make_trace_fn = (lambda scn, st: pt.make_pallas_trace_fn(
        scn, interpret=True) if st.backend == "pallas" else orig(scn, st))
    res["render"] = crt_tpu.render_image(
        make_test_scene(**spec["render_scene"]),
        crt_tpu.RenderSettings(backend="pallas"), jit=False)
    res["render_merged_traces"] = np.asarray(len(calls))
np.savez(out_path, **{k: np.asarray(v) for k, v in res.items()})
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_variants_ref")
    spec = {"merge_scene": MERGE_SCENE, "merges": MERGES,
            "stream_scene": STREAM_SCENE, "tr": STREAM_TR, "sc": STREAM_SC,
            "apex": STREAM_APEX, "render_scene": RENDER_SCENE}
    (tmp / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ, JAX_PLATFORMS="cpu", CRT_TILE_MERGE="2",
               XLA_FLAGS="--xla_cpu_max_isa=AVX "
                         "--xla_cpu_multi_thread_eigen=false",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    parts = ("merge,stream", "render")  # ~30 s each, ~0.8 GB each
    procs = []
    try:
        for part in parts:
            argv = [sys.executable, "-c", _REF_SCRIPT,
                    str(tmp / f"{part}.npz"), str(tmp / "spec.json"), part]
            with open(tmp / f"{part}.err", "w") as err:
                procs.append(subprocess.Popen(
                    argv, env=env, cwd=ROOT, stdout=subprocess.DEVNULL,
                    stderr=err))
        for proc in procs:
            proc.wait(timeout=600)
    finally:
        for proc in procs:
            proc.kill()
    res = {}
    for part, proc in zip(parts, procs):
        assert proc.returncode == 0, (tmp / f"{part}.err").read_text()[-4000:]
        with np.load(tmp / f"{part}.npz") as z:
            res.update(z)
    return res


def T(a):
    return torch.from_numpy(np.array(a))


def eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), want)


def _merge_case(ref):
    scene = make_test_scene(**MERGE_SCENE, device="cpu")
    tables = tct.build_cluster_tables(scene)
    rows_table = tct.emit_rows_table(scene, tables)
    o, d = T(ref["merge/o"]), T(ref["merge/d"])
    cl, cnt = tbin.bin_rays(tables, o, d, 1024, T(ref["merge/act"]))
    return tables, rows_table, o, d, cl, cnt


@pytest.mark.parametrize("merge", MERGES)
def test_closest_hit_merged_plain_matches_pallas(ref, merge):
    """K7's plain version vs ``_closest_hit_binned_merged`` and vs K1's
    plain version on the same lists, empty ones among them."""
    tables, rows_table, o, d, cl, cnt = _merge_case(ref)
    eq(cl, ref["merge/cl"])
    eq(cnt, ref["merge/cnt"])
    assert cnt.shape[0] == 4 and (cnt == 0).any() and (cnt > 0).any()
    t, tri, rows = ttr.closest_hit_merged(tables, o, d, cl, cnt, rows_table,
                                          merge=merge)
    eq(tri, ref[f"merge/{merge}/tri"])
    eq(t, ref[f"merge/{merge}/t"])
    eq(rows, ref[f"merge/{merge}/rows"])
    k1 = ttr.closest_hit_plain(tables, o, d, cl, cnt, rows_table)
    assert all(torch.equal(a, b) for a, b in zip((t, tri, rows), k1))
    assert (tri >= 0).any() and (tri < 0).any()


def test_closest_hit_merged_refuses_a_ragged_merge(ref):
    tables, rows_table, o, d, cl, cnt = _merge_case(ref)
    for merge in (3, 0):  # 4 tiles do not divide by 3; 0 is no merge
        with pytest.raises(ValueError):
            ttr.closest_hit_merged(tables, o, d, cl, cnt, rows_table,
                                   merge=merge)
        with pytest.raises(ValueError):
            ttr.closest_hit_merged_plain(tables, o, d, cl, cnt, rows_table,
                                         merge=merge)


@pytest.mark.parametrize("merge,compact,k7", [
    (2, False, True),
    (3, False, False),  # 4 tiles do not divide by 3
    (2, True, False),   # the compacted launch is never merged
    (1, False, False),  # no merge
])
def test_trace_factory_takes_k7_where_crt_tpu_does(monkeypatch, merge,
                                                   compact, k7):
    """K7 serves a trace when the merge is above 1, the padded tile count
    divides by it and the launch is not the compacted one; the hits and
    rows equal K1's either way."""
    from crt_tpu_torch.ops import camera
    from crt_tpu_torch.renderer import make_tiler

    scene = make_test_scene(device="cpu")  # 64x36 in 32x32 blocks: 4 tiles
    rx, ry, _ = make_tiler(scene.height, scene.width, device=scene.device)
    o, d = camera.generate_rays(scene.cam_position, scene.cam_rotation,
                                scene.cam_tan_half_fov, scene.width,
                                scene.height, rx, ry)
    act = torch.arange(o.shape[0]) % 5 != 0
    calls = []
    real = ttr.closest_hit_merged_plain

    def spy(*args, **kw):
        calls.append(args[-1])
        return real(*args, **kw)

    monkeypatch.setattr(ttr, "closest_hit_merged_plain", spy)
    trace = ttr.make_cluster_trace_fn(scene, compact_masked=compact,
                                      tile_merge=merge)
    hit, rows = trace.with_rows(o, d, act)
    assert calls == ([merge] if k7 else [])
    base, base_rows = ttr.make_cluster_trace_fn(
        scene, tile_merge=1).with_rows(o, d, act)
    assert torch.equal(hit.tri, base.tri) and torch.equal(hit.t, base.t)
    assert torch.equal(rows, base_rows)
    # the default takes no merge; the argument sets it
    calls.clear()
    ttr.make_cluster_trace_fn(scene)(o, d)
    assert calls == []
    ttr.ClusterTracer(trace.tables, tile_merge=4)(o, d)
    assert calls == [4]


def _stream_case(ref):
    scene = make_test_scene(**STREAM_SCENE, device="cpu")
    st = tst.build_stream_tables(tct.build_cluster_tables(scene), STREAM_SC,
                                 layout="lane")
    o, d = T(ref["stream/o"]), T(ref["stream/d"])
    R = o.shape[0]
    apex = torch.tensor([STREAM_APEX]).expand(R // STREAM_TR, 3)
    return st, o, d, torch.full((R,), 1e6), torch.ones(R, dtype=torch.bool), \
        apex


@pytest.mark.parametrize("layout", ["lane", "rows"])
def test_stream_layouts_match_pallas_and_fused(ref, layout):
    """Closest hit and any-hit in the lane and rows layouts vs crt_tpu's
    kernels of that layout in interpret mode, and vs the port's fused
    results; the lane slab vs crt_tpu's, with a padding member in its last
    supercluster."""
    st, o, d, r2, active, apex = _stream_case(ref)
    real = st.tables.tri_id.shape[0] - int((st.tables.tri_id < 0).all(
        dim=1).sum())
    assert real % STREAM_SC != 0  # the last supercluster ends in padding
    eq(st.lane, ref["stream/lane"])
    seen = []
    plain = tst.closest_hit_stream_plain

    def spy(*args, **kw):
        seen.append(args[-1])
        return plain(*args, **kw)

    tst.closest_hit_stream_plain = spy
    try:
        hit, total = tst.closest_hit_stream_flat(st, o, d, None, STREAM_TR,
                                                 layout=layout)
    finally:
        tst.closest_hit_stream_plain = plain
    assert seen == [layout]
    assert total == int(ref[f"stream/{layout}/total"])
    eq(hit.tri, ref[f"stream/{layout}/tri"])
    eq(hit.t, ref[f"stream/{layout}/t"])
    occ = tst.occluded_stream_flat(st, o, d, r2, active, apex, 0.02,
                                   STREAM_TR, layout=layout)
    eq(occ, ref[f"stream/{layout}/occ"])
    fused, _ = tst.closest_hit_stream_flat(st, o, d, None, STREAM_TR,
                                           layout="fused")
    assert torch.equal(hit.tri, fused.tri) and torch.equal(hit.t, fused.t)
    assert torch.equal(occ, tst.occluded_stream_flat(
        st, o, d, r2, active, apex, 0.02, STREAM_TR, layout="fused"))
    assert (hit.tri >= 0).any() and (hit.tri < 0).any()
    assert occ.any() and not occ.all()


def test_unknown_layout_raises(ref):
    """The ``layout=`` argument rejects an unknown name, and "fused" is
    every default."""
    st, o, d, r2, active, apex = _stream_case(ref)
    with pytest.raises(ValueError):
        tst.closest_hit_stream_flat(st, o, d, None, STREAM_TR,
                                    layout="columns")
    with pytest.raises(ValueError):
        tst.build_stream_tables(st.tables, STREAM_SC, layout="columns")
    bounds = tbin.tile_bounds(o, d, STREAM_TR, None)
    pairs = tst.bin_stream_pairs(st, bounds)
    with pytest.raises(ValueError):  # the wrappers read no environment
        tst.closest_hit_stream(st.fused, st.tables.tri_id, o, d, *pairs,
                               STREAM_SC, STREAM_TR, layout=None)
    with pytest.raises(ValueError):  # a fused table named as the lane slab
        tst.closest_hit_stream(st.fused, st.tables.tri_id, o, d, *pairs,
                               STREAM_SC, STREAM_TR, layout="lane")
    with pytest.raises(ValueError):
        tst.StreamTracer(st.tables, STREAM_TR, STREAM_SC, layout="columns")
    with pytest.raises(ValueError):
        tst.occluded_stream_flat(st, o, d, r2, active, apex, 0.02, STREAM_TR,
                                 layout="columns")
    assert tst.StreamTracer(st.tables, STREAM_TR, STREAM_SC,
                            layout="rows").layout == "rows"
    assert tst.StreamTracer(st.tables, STREAM_TR, STREAM_SC).layout == "fused"
    assert tst.build_stream_tables(st.tables, STREAM_SC).lane is None


def test_render_with_tile_merge_matches_default_and_crt_tpu(ref,
                                                            monkeypatch):
    """The opaque test scene at two tiles: with a tracer built with
    ``tile_merge=2`` every closest hit of the frame takes K7, and the image
    equals the default one bit for bit and crt_tpu's merged render."""
    scene = make_test_scene(**RENDER_SCENE, device="cpu")
    default = render_image(scene)
    calls = []
    real = ttr.closest_hit_merged_plain

    def spy(*args, **kw):
        calls.append(args[-1])
        return real(*args, **kw)

    monkeypatch.setattr(ttr, "closest_hit_merged_plain", spy)
    img = _render_flat(scene, RenderSettings(),
                       trace_fn=ttr.make_cluster_trace_fn(scene, tile_merge=2))
    assert calls == [2] * 4  # the primary trace and three bounces
    assert torch.equal(img, default)
    assert int(ref["render_merged_traces"]) > 0  # crt_tpu took K7 too
    np.testing.assert_allclose(img.numpy(), ref["render"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("layout", ["lane", "rows"])
def test_stream_render_layout_matches_fused(monkeypatch, layout):
    """A small streaming frame through a tracer built with ``layout=``
    equals the fused frame bit for bit; every kernel call of the frame
    read the layout's table."""
    scene = make_test_scene(64, 32, num_quads=16, with_edges=True,
                            device="cpu")
    settings = RenderSettings(backend="stream")
    fused = render_image(scene, settings)
    seen = []
    for name in ("closest_hit_stream_plain", "occlusion_stream_plain"):
        real = getattr(tst, name)

        def spy(*args, real=real, **kw):
            seen.append(args[-1])
            return real(*args, **kw)

        monkeypatch.setattr(tst, name, spy)
    img = _render_flat(scene, settings,
                       trace_fn=tst.make_stream_trace_fn(scene, layout=layout))
    assert len(seen) == 4 * 3 and set(seen) == {layout}
    assert torch.equal(img, fused)

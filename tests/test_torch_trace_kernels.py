"""The cluster kernels' plain versions vs crt_tpu's Pallas kernels.

closest_hit (K1), closest_hit_compact (K4) and occlusion_w (K2, every
mode) take their plain PyTorch versions on CPU tensors; here they are held
to ``_closest_hit_binned``, ``_closest_hit_binned_compact`` and
``_occluded_binned_compact_w`` run in Pallas interpret mode, and the trace
factory to ``make_pallas_trace_fn(scene, interpret=True)``.  (The CUDA
kernels themselves are held to the plain versions on the card by
chip_smoke.py.)

Tolerance: EXACT (tri, t, rows and masks equal).  The JAX reference runs
in a subprocess whose XLA CPU target is capped below FMA
(``--xla_cpu_max_isa=AVX``): compiled XLA otherwise contracts the edge
tests' ``(mo - c) + t * md`` into FMAs, which moves t and the edge values
by an ulp and flips exact-t ties at shared edges.  Without FMA both sides
round every op identically, as the CUDA kernels (built with -fmad=false)
do.  This is stricter than test_pallas_trace.py's rtol 1e-6 / atol 1e-7.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from crt_tpu_torch import scene_from_dict
from crt_tpu_torch.ops import binning as tbin
from crt_tpu_torch.ops import cluster_tables as tct
from crt_tpu_torch.ops import cluster_trace as ttr
from crt_tpu_torch.scene.procedural import make_test_scene
from torch_port_fixtures import _one_torch_thread, _release_heap  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


# One scene keeps the JAX reference subprocess short; the default
# make_test_scene is held end to end by test_torch_render.py.
SCENES = {
    "edges": dict(width=96, height=64, num_quads=16, with_edges=True),
    "glass": dict(width=64, height=32, num_quads=6, with_refractive=True),
}


def tie_scene_dict():
    """Two coplanar (z = -5) overlapping triangles: A (id 16) sorts into
    cluster 0 after 15 far filler triangles, B (id 15) into cluster 1.
    Rays through the overlap hit both at exactly the same t."""
    objects = []
    for i in range(15):  # fillers at the low corner, all behind the camera
        x = -10.0 - 0.1 * i
        objects.append({"material_index": 0, "triangles": [0, 1, 2],
                        "vertices": [x, -10, -20, x + 0.05, -10, -20,
                                     x, -9.95, -20]})
    objects.append({"material_index": 0, "triangles": [0, 1, 2],  # B, id 15
                    "vertices": [0.2, 0.2, -5, 2.2, 0.2, -5, 0.2, 2.2, -5]})
    objects.append({"material_index": 0, "triangles": [0, 1, 2],  # A, id 16
                    "vertices": [0, 0, -5, 2, 0, -5, 0, 2, -5]})
    return {
        "settings": {"background_color": [0, 0, 0],
                     "image_settings": {"width": 32, "height": 32}},
        "camera": {"matrix": [1, 0, 0, 0, 1, 0, 0, 0, 1],
                   "position": [0, 0, 0]},
        "lights": [{"intensity": 10, "position": [0, 5, 0]}],
        "materials": [{"type": "diffuse", "albedo": [1, 1, 1],
                       "smooth_shading": False}],
        "objects": objects,
    }


def tie_rays():
    """1024 rays from the origin through the overlap of A and B."""
    g = np.linspace(0.4, 0.9, 32, dtype=np.float32)
    x, y = np.meshgrid(g, g, indexing="ij")
    d = np.stack([x.ravel(), y.ravel(), np.full(1024, -5.0, np.float32)], -1)
    d = d / np.sqrt((d.astype(np.float64) ** 2).sum(-1, keepdims=True))
    return np.zeros((1024, 3), np.float32), d.astype(np.float32)


# Runs in the subprocess: the JAX side, saved to an .npz.
_REF_SCRIPT = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from crt_tpu import renderer
from crt_tpu.ops import camera
from crt_tpu.ops import pallas_trace as pt
from crt_tpu.scene.json_loader import scene_from_dict
from crt_tpu.scene.procedural import make_test_scene


def scene_ref(s):
    # Tables and rays are built eagerly (one XLA op at a time, as the port
    # is compared in test_torch_binning.py); under jit XLA rewrites parts
    # of the table build and moves normals by an ulp.
    rx, ry, _ = renderer.make_tiler(s.height, s.width)
    o, d = camera.generate_rays(s.cam_position, s.cam_rotation,
                                s.cam_tan_half_fov, s.width, s.height, rx, ry)
    tables = pt.build_cluster_tables(s)
    rows_table = pt.emit_rows_table(s, tables)
    trace = pt.make_pallas_trace_fn(s, interpret=True)
    res = jax.jit(lambda o, d: scene_ref_jit(s, tables, rows_table, trace,
                                             o, d))(o, d)
    res["o"], res["d"] = o, d
    return res


def scene_ref_jit(s, tables, rows_table, trace, o, d):
    res = {}
    R = o.shape[0]
    tiles = R // 1024

    def planes(x):
        return x.reshape(tiles, 1024, 3).swapaxes(1, 2)

    def k1(prefix, o, d, act):
        cl, cnt = pt.bin_rays(tables, o, d, 1024, act)
        bt, bi, br = pt._closest_hit_binned(
            tables, planes(o), planes(d), cl, cnt, 1024, True,
            rows_table=rows_table)
        res[prefix + "/cl"], res[prefix + "/cnt"] = cl[:, 0], cnt
        res[prefix + "/t"], res[prefix + "/tri"] = bt.reshape(-1), bi.reshape(-1)
        res[prefix + "/rows"] = jnp.moveaxis(br, 1, 0).reshape(br.shape[1], -1)
        return bt.reshape(-1), bi.reshape(-1)

    t, tri = k1("primary", o, d, None)
    valid = tri >= 0
    point = o + d * jnp.where(valid, t, 0.0)[:, None]
    up = jnp.zeros_like(point).at[:, 1].set(1.0)
    b_o = point + 1e-2 * up
    b_d = d * jnp.asarray([1.0, -1.0, 1.0], jnp.float32)
    b_act = valid & (jnp.arange(R) % 4 != 0)
    res["bounce_o"], res["bounce_d"], res["bounce_act"] = b_o, b_d, b_act
    k1("bounce", b_o, b_d, b_act)

    shadow_o = point + 1e-2 * up
    lights = s.light_position
    act = jnp.stack([valid, valid & (point[:, 0] > 0)])
    res["point"], res["shadow_o"], res["shadow_act"] = point, shadow_o, act
    cl, cnt = pt.bin_apex_shared(tables, shadow_o, lights, act, 1024, 0.02)
    apex = jnp.repeat(lights, tiles, axis=0)[:, None, :]
    occ = pt._occluded_binned_compact_w(
        tables, planes(shadow_o), planes(point), apex, cl, cnt, 1024, True)
    res["occ_cl"], res["occ_cnt"] = cl[:, 0], cnt
    res["occ"] = occ.reshape(-1)

    # end to end through the trace factory
    hit, rows = trace.with_rows(o, d, jnp.ones(R, bool))
    res["e2e_t"], res["e2e_tri"], res["e2e_rows"] = hit.t, hit.tri, rows
    hit = trace(b_o, b_d, b_act)
    res["e2e_bounce_t"], res["e2e_bounce_tri"] = hit.t, hit.tri
    hit = trace(o[: R - 100], d[: R - 100])  # padded to a tile multiple
    res["e2e_pad_t"], res["e2e_pad_tri"] = hit.t, hit.tri
    res["e2e_occ"] = trace.shadow_apex_w(point, shadow_o, lights, act, 0.02)

    # K4: the live-tile compacted launch, on the masked bounce wavefront
    # (half of its tiles switched off) and, with tile_mod, on a wavefront of
    # two direction sets over one copy of the origins
    c_act = b_act & ((jnp.arange(R) // 1024) % 2 == 0)
    cl, cnt = pt.bin_rays(tables, b_o, b_d, 1024, c_act)
    bt, bi, br = pt._closest_hit_binned_compact(
        tables, planes(b_o), planes(b_d), cl, cnt, 1024, True,
        rows_table=rows_table)
    res["compact_act"] = c_act
    res["compact/t"], res["compact/tri"] = bt.reshape(-1), bi.reshape(-1)
    res["compact/rows"] = jnp.moveaxis(br, 1, 0).reshape(br.shape[1], -1)
    o2 = jnp.concatenate([b_o, b_o])
    d2 = jnp.concatenate([b_d, d])
    a2 = jnp.concatenate([c_act, b_act])
    cl, cnt = pt.bin_rays(tables, o2, d2, 1024, a2)
    d2_t = d2.reshape(2 * tiles, 1024, 3).swapaxes(1, 2)
    bt, bi = pt._closest_hit_binned_compact(
        tables, planes(b_o), d2_t, cl, cnt, 1024, True, tile_mod=tiles)
    res["mod/t"], res["mod/tri"] = bt.reshape(-1), bi.reshape(-1)

    # K4 on the primary wavefront with no live tile and with one, and the
    # live-first order its launcher builds (pallas_trace.py
    # _closest_hit_binned_compact: live = counts > 0, a stable argsort)
    tile = jnp.arange(R) // 1024
    for wave, a in (("dead", jnp.zeros(R, bool)),
                    ("one", valid & (tile == tiles // 2))):
        cl, cnt = pt.bin_rays(tables, o, d, 1024, a)
        bt, bi, br = pt._closest_hit_binned_compact(
            tables, planes(o), planes(d), cl, cnt, 1024, True,
            rows_table=rows_table)
        live = cnt > 0
        res[wave + "_act"] = a
        res[wave + "/order"] = jnp.argsort(~live, stable=True).astype(jnp.int32)
        res[wave + "/n_live"] = jnp.sum(live, dtype=jnp.int32)
        res[wave + "/t"], res[wave + "/tri"] = bt.reshape(-1), bi.reshape(-1)
        res[wave + "/rows"] = jnp.moveaxis(br, 1, 0).reshape(br.shape[1], -1)

    if s.has_refractive:
        # K2's other modes, with the factory's glass subset rebuilt here
        ids = jnp.maximum(tables.tri_id, 0)
        is_glass = (s.mat_type[s.tri_material] == 2)[ids] & (tables.tri_id >= 0)
        pts = s.vertices[s.tri_vidx[ids]]
        g = is_glass[..., None, None]
        gmin = jnp.where(g, pts, 3.4e38).min(axis=(1, 2))
        gmax = jnp.where(g, pts, -3.4e38).max(axis=(1, 2))
        gm = is_glass.astype(jnp.float32)
        res["gm"], res["gmin"], res["gmax"] = gm, gmin, gmax
        cl, cnt = pt.bin_apex_shared(tables, shadow_o, lights, act, 1024,
                                     0.02, glass_boxes=(gmin, gmax))
        occ, glass = pt._occluded_binned_compact_w(
            tables, planes(shadow_o), planes(point), apex, cl, cnt, 1024,
            True, member_mask=gm, glass_flag=True)
        res["glass_cl"], res["glass_cnt"] = cl[:, 0], cnt
        res["glass_occ"], res["glass_flag"] = occ.reshape(-1), glass.reshape(-1)
        cl, cnt = pt.bin_apex_shared(tables, shadow_o, lights, act, 1024,
                                     0.02, boxes=(gmin, gmax), capped=False)
        occ = pt._occluded_binned_compact_w(
            tables, planes(shadow_o), planes(point), apex, cl, cnt, 1024,
            True, capped=False, member_mask=gm)
        res["unc_cl"], res["unc_cnt"] = cl[:, 0], cnt
        res["unc_occ"] = occ.reshape(-1)
        occ, glass = trace.shadow_apex_w_glass(point, shadow_o, lights, act,
                                               0.02)
        res["e2e_glass_occ"], res["e2e_glass_flag"] = occ, glass
        res["e2e_gate"] = trace.refr_ray_hit_w(point, shadow_o, lights, act,
                                               0.02)
    return res


out_path, spec_path = sys.argv[1], sys.argv[2]
spec = json.load(open(spec_path))
res = {}
for name, kw in spec["scenes"].items():
    for k, v in scene_ref(make_test_scene(**kw)).items():
        res[name + "/" + k] = np.asarray(v)

tie = scene_from_dict(spec["tie_scene"], build_accel=False)
trace = pt.make_pallas_trace_fn(tie, interpret=True)
hit = jax.jit(trace)(jnp.asarray(spec["tie_o"], jnp.float32),
                     jnp.asarray(spec["tie_d"], jnp.float32))
res["tie/t"], res["tie/tri"] = np.asarray(hit.t), np.asarray(hit.tri)
res["tie/tri_id"] = np.asarray(pt.build_cluster_tables(tie).tri_id)
np.savez(out_path, **res)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_ref")
    o, d = tie_rays()
    spec = {"scenes": SCENES, "tie_scene": tie_scene_dict(),
            "tie_o": o.tolist(), "tie_d": d.tolist()}
    (tmp / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX "
                         "--xla_cpu_multi_thread_eigen=false",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", _REF_SCRIPT, str(tmp / "ref.npz"),
         str(tmp / "spec.json")],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(tmp / "ref.npz") as z:
        return dict(z)


def T(a):
    return torch.from_numpy(np.array(a))


def _tables(name):
    scene = make_test_scene(**SCENES[name], device="cpu")
    tables = tct.build_cluster_tables(scene)
    return scene, tables, tct.emit_rows_table(scene, tables)


@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("wave", ["primary", "bounce"])
def test_closest_hit_plain_matches_pallas(ref, name, wave):
    _, tables, rows_table = _tables(name)
    if wave == "primary":
        o, d, act = T(ref[name + "/o"]), T(ref[name + "/d"]), None
    else:
        o, d = T(ref[name + "/bounce_o"]), T(ref[name + "/bounce_d"])
        act = T(ref[name + "/bounce_act"])
    cl, cnt = tbin.bin_rays(tables, o, d, 1024, act)
    p = f"{name}/{wave}"
    np.testing.assert_array_equal(cl.numpy(), ref[p + "/cl"])
    np.testing.assert_array_equal(cnt.numpy(), ref[p + "/cnt"])
    ttr.closest_hit_launches = 0
    t, tri, rows = ttr.closest_hit(tables, o, d, cl, cnt, rows_table)
    assert ttr.closest_hit_launches == 0  # CPU tensors: the plain version
    np.testing.assert_array_equal(tri.numpy(), ref[p + "/tri"])
    np.testing.assert_array_equal(t.numpy(), ref[p + "/t"])
    np.testing.assert_array_equal(rows.numpy(), ref[p + "/rows"])
    assert (tri >= 0).any() and (tri < 0).any()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_occlusion_w_plain_matches_pallas(ref, name):
    scene, tables, _ = _tables(name)
    so, pt_ = T(ref[name + "/shadow_o"]), T(ref[name + "/point"])
    act = T(ref[name + "/shadow_act"])
    lights = scene.light_position
    cl, cnt = tbin.bin_apex_shared(tables, so, lights, act, 1024, 0.02)
    np.testing.assert_array_equal(cl.numpy(), ref[name + "/occ_cl"])
    np.testing.assert_array_equal(cnt.numpy(), ref[name + "/occ_cnt"])
    ttr.occlusion_w_launches = 0
    occ = ttr.occlusion_w(tables, so, pt_, lights, cl, cnt)
    assert ttr.occlusion_w_launches == 0
    np.testing.assert_array_equal(occ.numpy(), ref[name + "/occ"])
    assert occ.any() and not occ.all()


@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("wave", ["compact", "mod"])
def test_closest_hit_compact_plain_matches_pallas(ref, name, wave):
    """K4's plain version vs ``_closest_hit_binned_compact`` and vs the
    port's K1 plain version on the same lists: t, tri and rows equal."""
    _, tables, rows_table = _tables(name)
    o, d = T(ref[name + "/bounce_o"]), T(ref[name + "/bounce_d"])
    act = T(ref[name + "/compact_act"])
    tile_mod = 0
    if wave == "mod":
        tile_mod = o.shape[0] // 1024
        d = torch.cat([d, T(ref[name + "/d"])])
        act = torch.cat([act, T(ref[name + "/bounce_act"])])
        rows_table = None
    o_full = torch.cat([o, o]) if tile_mod else o
    cl, cnt = tbin.bin_rays(tables, o_full, d, 1024, act)
    assert (cnt == 0).any() and (cnt > 0).any()
    ttr.closest_hit_compact_launches = 0
    t, tri, rows = ttr.closest_hit_compact(tables, o, d, cl, cnt, rows_table,
                                           tile_mod=tile_mod)
    assert ttr.closest_hit_compact_launches == 0
    p = f"{name}/{wave}"
    np.testing.assert_array_equal(tri.numpy(), ref[p + "/tri"])
    np.testing.assert_array_equal(t.numpy(), ref[p + "/t"])
    t1, tri1, rows1 = ttr.closest_hit_plain(tables, o_full, d, cl, cnt,
                                            rows_table)
    assert torch.equal(tri, tri1) and torch.equal(t, t1)
    if rows_table is not None:
        np.testing.assert_array_equal(rows.numpy(), ref[p + "/rows"])
        assert torch.equal(rows, rows1)
    assert (tri >= 0).any() and (tri < 0).any()


@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("wave", ["dead", "one"])
def test_compact_plain_and_live_list_match_pallas_sparse(ref, name, wave):
    """K4's tile list (``live_tiles``, its plain version on CPU tensors) vs
    the live-first order ``_closest_hit_binned_compact`` builds, and K4's
    plain version vs that launch in interpret mode, on a wavefront with no
    live tile and on one with a single live tile: t, tri and rows equal."""
    _, tables, rows_table = _tables(name)
    o, d = T(ref[name + "/o"]), T(ref[name + "/d"])
    cl, cnt = tbin.bin_rays(tables, o, d, 1024, T(ref[f"{name}/{wave}_act"]))
    assert int((cnt > 0).sum()) == (0 if wave == "dead" else 1)
    p = f"{name}/{wave}"
    ttr.live_tiles_launches = ttr.closest_hit_compact_launches = 0
    ids, n_live = ttr.live_tiles(cnt)
    np.testing.assert_array_equal(ids.numpy(), ref[p + "/order"])
    assert int(n_live) == int(ref[p + "/n_live"])
    t, tri, rows = ttr.closest_hit_compact(tables, o, d, cl, cnt, rows_table)
    assert ttr.live_tiles_launches == ttr.closest_hit_compact_launches == 0
    np.testing.assert_array_equal(tri.numpy(), ref[p + "/tri"])
    np.testing.assert_array_equal(t.numpy(), ref[p + "/t"])
    np.testing.assert_array_equal(rows.numpy(), ref[p + "/rows"])
    assert (tri >= 0).any() == (wave == "one")


def test_glass_subset_matches_crt_tpu(ref):
    scene, tables, _ = _tables("glass")
    gm, gmin, gmax = tct.glass_subset(scene, tables)
    np.testing.assert_array_equal(gm.numpy(), ref["glass/gm"])
    np.testing.assert_array_equal(gmin.numpy(), ref["glass/gmin"])
    np.testing.assert_array_equal(gmax.numpy(), ref["glass/gmax"])
    assert 0 < gm.sum() < (tables.tri_id >= 0).sum()


@pytest.mark.parametrize("mode", ["glass_flag", "uncapped_masked"])
def test_occlusion_w_modes_plain_match_pallas(ref, mode):
    """K2's plain version in the glass-flag mode (both outputs) and in the
    uncapped member-masked mode, on lists that must equal crt_tpu's."""
    scene, tables, _ = _tables("glass")
    so, pt_ = T(ref["glass/shadow_o"]), T(ref["glass/point"])
    act = T(ref["glass/shadow_act"])
    lights = scene.light_position
    gm, gmin, gmax = tct.glass_subset(scene, tables)
    ttr.occlusion_w_launches = 0
    if mode == "glass_flag":
        cl, cnt = tbin.bin_apex_shared(tables, so, lights, act, 1024, 0.02,
                                       glass_boxes=(gmin, gmax))
        np.testing.assert_array_equal(cl.numpy(), ref["glass/glass_cl"])
        np.testing.assert_array_equal(cnt.numpy(), ref["glass/glass_cnt"])
        occ, glass = ttr.occlusion_w(tables, so, pt_, lights, cl, cnt,
                                     member_mask=gm, glass_flag=True)
        np.testing.assert_array_equal(occ.numpy(), ref["glass/glass_occ"])
        np.testing.assert_array_equal(glass.numpy(), ref["glass/glass_flag"])
        assert glass.any() and not glass.all()
    else:
        cl, cnt = tbin.bin_apex_shared(tables, so, lights, act, 1024, 0.02,
                                       boxes=(gmin, gmax), capped=False)
        np.testing.assert_array_equal(cl.numpy(), ref["glass/unc_cl"])
        np.testing.assert_array_equal(cnt.numpy(), ref["glass/unc_cnt"])
        occ = ttr.occlusion_w(tables, so, pt_, lights, cl, cnt, capped=False,
                              member_mask=gm)
        np.testing.assert_array_equal(occ.numpy(), ref["glass/unc_occ"])
    assert ttr.occlusion_w_launches == 0
    assert occ.any() and not occ.all()


def test_glass_router_functions_match_pallas(ref):
    """``shadow_apex_w_glass`` and ``refr_ray_hit_w`` of the trace factory,
    offered only when the scene has refractive materials."""
    scene, _, _ = _tables("glass")
    trace = ttr.make_cluster_trace_fn(scene)
    args = (T(ref["glass/point"]), T(ref["glass/shadow_o"]),
            scene.light_position, T(ref["glass/shadow_act"]), 0.02)
    occ, glass = trace.shadow_apex_w_glass(*args)
    np.testing.assert_array_equal(occ.numpy(), ref["glass/e2e_glass_occ"])
    np.testing.assert_array_equal(glass.numpy(), ref["glass/e2e_glass_flag"])
    gate = trace.refr_ray_hit_w(*args)
    np.testing.assert_array_equal(gate.numpy(), ref["glass/e2e_gate"])
    # the two routes to the flag agree wherever a lane is active, and the
    # merged pass keeps the capped mode's occlusion bits
    act = args[3]
    assert torch.equal(glass & act, gate & act)
    assert torch.equal(occ & act, trace.shadow_apex_w(*args) & act)
    short = (args[0][:100], args[1][:100], args[2], act[:, :100], 0.02)
    assert trace.shadow_apex_w_glass(*short) is None
    assert trace.refr_ray_hit_w(*short) is None
    opaque = ttr.make_cluster_trace_fn(_tables("edges")[0])
    assert not hasattr(opaque, "shadow_apex_w_glass")
    assert not hasattr(opaque, "refr_ray_hit_w")


@pytest.mark.parametrize("name", sorted(SCENES))
def test_trace_factory_matches_pallas(ref, name):
    scene, _, _ = _tables(name)
    trace = ttr.make_cluster_trace_fn(scene)
    o, d = T(ref[name + "/o"]), T(ref[name + "/d"])
    R = o.shape[0]
    hit, rows = trace.with_rows(o, d, torch.ones(R, dtype=torch.bool))
    np.testing.assert_array_equal(hit.tri.numpy(), ref[name + "/e2e_tri"])
    np.testing.assert_array_equal(hit.t.numpy(), ref[name + "/e2e_t"])
    np.testing.assert_array_equal(rows.numpy(), ref[name + "/e2e_rows"])

    hit = trace(T(ref[name + "/bounce_o"]), T(ref[name + "/bounce_d"]),
                T(ref[name + "/bounce_act"]))
    np.testing.assert_array_equal(hit.tri.numpy(), ref[name + "/e2e_bounce_tri"])
    np.testing.assert_array_equal(hit.t.numpy(), ref[name + "/e2e_bounce_t"])

    # compact_masked sends the masked trace through K4: the same hits
    compact = ttr.make_cluster_trace_fn(scene, compact_masked=True)
    chit = compact(T(ref[name + "/bounce_o"]), T(ref[name + "/bounce_d"]),
                   T(ref[name + "/bounce_act"]))
    assert torch.equal(chit.tri, hit.tri) and torch.equal(chit.t, hit.t)

    hit = trace(o[:R - 100], d[:R - 100])  # padded to a tile multiple
    np.testing.assert_array_equal(hit.tri.numpy(), ref[name + "/e2e_pad_tri"])
    np.testing.assert_array_equal(hit.t.numpy(), ref[name + "/e2e_pad_t"])

    occ = trace.shadow_apex_w(T(ref[name + "/point"]),
                              T(ref[name + "/shadow_o"]), scene.light_position,
                              T(ref[name + "/shadow_act"]), 0.02)
    np.testing.assert_array_equal(occ.numpy(), ref[name + "/e2e_occ"])
    assert trace.shadow_apex_w(T(ref[name + "/point"])[:100],
                               T(ref[name + "/shadow_o"])[:100],
                               scene.light_position,
                               T(ref[name + "/shadow_act"])[:, :100],
                               0.02) is None


def test_exact_t_tie_first_walked_cluster_wins(ref):
    scene = scene_from_dict(tie_scene_dict(), device="cpu")
    tables = tct.build_cluster_tables(scene)
    np.testing.assert_array_equal(tables.tri_id.numpy(), ref["tie/tri_id"])
    assert tables.tri_id[0, 15] == 16 and tables.tri_id[1, 0] == 15
    o, d = map(T, tie_rays())
    hit = ttr.make_cluster_trace_fn(scene)(o, d)
    # A (id 16, cluster 0, walked first) wins every exact tie with B (id
    # 15): a global smallest-id rule would pick B
    assert (hit.tri == 16).all()
    np.testing.assert_array_equal(hit.tri.numpy(), ref["tie/tri"])
    np.testing.assert_array_equal(hit.t.numpy(), ref["tie/t"])
    # the walk order decides: walked the other way round, B wins
    cl, cnt = tbin.bin_rays(tables, o, d, 1024)
    assert cl[0, :2].tolist() == [0, 1] and cnt[0] == 2
    t2, tri2, _ = ttr.closest_hit_plain(tables, o, d, cl.flip(1), cnt)
    assert (tri2 == 15).all()
    np.testing.assert_array_equal(t2.numpy(), hit.t.numpy())


def test_wrappers_check_inputs():
    _, tables, rows_table = _tables("edges")
    o = torch.zeros((1024, 3))
    d = torch.zeros((1024, 3))
    cl = torch.zeros((1, tables.n.shape[0]), dtype=torch.int32)
    cnt = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError):
        ttr.closest_hit(tables, o[:1000], d[:1000], cl, cnt)
    with pytest.raises(ValueError):
        ttr.closest_hit(tables, o.double(), d, cl, cnt)
    with pytest.raises(ValueError):
        ttr.closest_hit(tables, o, d, cl.long(), cnt)
    with pytest.raises(ValueError):
        ttr.occlusion_w(tables, o, d, torch.zeros((2, 3)), cl, cnt)
    with pytest.raises(ValueError):  # the glass flag needs the member mask
        ttr.occlusion_w(tables, o, d, torch.zeros((1, 3)), cl, cnt,
                        glass_flag=True)
    with pytest.raises(ValueError):
        ttr.occlusion_w(tables, o, d, torch.zeros((1, 3)), cl, cnt,
                        member_mask=torch.zeros((3, 16)))
    with pytest.raises(ValueError):
        ttr.closest_hit_compact(tables, o, d, cl.long(), cnt)
    t, tri, rows = ttr.closest_hit_compact(tables, o, d, cl, cnt, rows_table)
    assert torch.isinf(t).all() and (tri == -1).all() and (rows == 0).all()
    t, tri, rows = ttr.closest_hit(tables, o, d, cl, cnt, rows_table)
    assert torch.isinf(t).all() and (tri == -1).all() and (rows == 0).all()

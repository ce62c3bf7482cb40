"""The streaming backend of crt_tpu_torch vs crt_tpu.ops.pallas_stream.

Phase A (supercluster boxes, pair lists in every mode, member masks, the
per-lane exact mask, the fused table) and the plain versions of the two
kernels (closest hit K8, any-hit K9 with the two-phase shadow resolve) are
held to ``crt_tpu`` on the same inputs at ``tile_rays = 256`` and
``sc_clusters`` 4 and 32; the kernels' reference is ``crt_tpu``'s Pallas
kernels in interpret mode.  (The CUDA kernels themselves are held to the
plain versions on the card by chip_smoke.py and tests/test_torch_cuda.py.)

Tolerance: EXACT for lists, masks, t and tri.  The JAX side runs in a
subprocess whose XLA CPU target is capped below FMA
(``--xla_cpu_max_isa=AVX``), as tests/test_torch_trace_kernels.py explains.
crt_tpu lists pairs at a static capacity (tiles x superclusters) and the
port lists exactly the live ones, so a list is compared with the first
``total`` entries of crt_tpu's; crt_tpu packs each pair's live members as a
5-bit live-first permutation and the port as a 32-bit mask, so the mask's
set bits, lowest first, are compared with the permutation's first
``count`` entries.

The image of ``render_image(backend="pallas_stream")`` is held to
``crt_tpu.render_image`` (its streaming backend in interpret mode) at rtol
1e-5 / atol 1e-6, tests/test_torch_render.py's tolerance (the JAX render is
jitted, with FMAs), and its gradients to ``jax.grad`` of
``render_image(jit=False)`` with the bruteforce backend at
tests/test_torch_grad.py's tolerance (rtol 1e-5, atol 2e-6 of the largest
entry).
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import crt_tpu
import crt_tpu.ops.pallas_stream as jps
import crt_tpu.renderer as jrenderer
from crt_tpu.scene.procedural import make_test_scene as jmake_test_scene
from crt_tpu_torch import RenderSettings, render_image, scene_from_dict
from crt_tpu_torch import renderer as trenderer
from crt_tpu_torch.ops import binning as tbin
from crt_tpu_torch.ops import cluster_tables as tct
from crt_tpu_torch.ops import cluster_trace as ttr
from crt_tpu_torch.ops import intersect as tint
from crt_tpu_torch.ops import stream_binning as tsb
from crt_tpu_torch.ops import stream_trace as tst
from crt_tpu_torch.scene.procedural import make_test_scene
from crt_tpu_torch.utils import trace as tracing
from test_torch_grad import (
    GROUPS,
    assert_grads_close,
    carry,
    jax_value_and_grads,
    torch_value_and_grads,
    trainable,
)
from test_torch_trace_kernels import tie_rays, tie_scene_dict
from torch_port_fixtures import _one_torch_thread, _release_heap  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
TR = 256
SCENE = dict(width=64, height=32, num_quads=600, with_reflective=False)
LIGHTS = [[1.5, 6.0, 1.0], [-4.0, 5.0, -2.0]]
SLACK = 0.02
SCS = (4, 32)

# Runs in the subprocess: the JAX side, saved to an .npz.
_REF_SCRIPT = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from crt_tpu import renderer
from crt_tpu.ops import camera, vecmath
from crt_tpu.ops import pallas_stream as ps
from crt_tpu.ops import pallas_trace as pt
from crt_tpu.scene.json_loader import scene_from_dict
from crt_tpu.scene.procedural import make_test_scene

out_path, spec_path = sys.argv[1], sys.argv[2]
spec = json.load(open(spec_path))
TR, SLACK = spec["tr"], spec["slack"]
res = {}

s = make_test_scene(**spec["scene"])
rx, ry, _ = renderer.make_tiler(s.height, s.width)
o, d = camera.generate_rays(s.cam_position, s.cam_rotation,
                            s.cam_tan_half_fov, s.width, s.height, rx, ry)
R = o.shape[0]
tiles = R // TR
res["o"], res["d"] = o, d
base = pt.build_cluster_tables(s)
# some lanes off everywhere, and tile 1 off as a whole
act = (jnp.arange(R) % 3 != 0) & (jnp.arange(R) // TR != 1)
res["act"] = act
lp = jnp.asarray(spec["lights"], jnp.float32)
Ll = lp.shape[0]


def pairs(prefix, out):
    pt_, psc, valid, total = out
    n = int(total)
    assert int(valid.sum()) == n
    res[prefix + "/tile"], res[prefix + "/sc"] = pt_[:n], psc[:n]
    return pt_[:n], psc[:n]


for sc in spec["scs"]:
    p = f"sc{sc}/"
    tables, sc_min, sc_max = ps.build_supercluster_boxes(base, sc)
    res[p + "sc_min"], res[p + "sc_max"] = sc_min, sc_max
    for f in ("n", "nv0", "m", "c", "nobf", "tri_id", "cl_min", "cl_max"):
        res[p + "tables/" + f] = getattr(tables, f)
    res[p + "fused"] = ps.build_fused_table(tables)
    L2 = sc_min.shape[0]
    cap = tiles * L2

    first = sc == spec["scs"][0]
    for name, a in ((("all", None), ("masked", act)) if first
                    else (("all", None),)):
        q = p + name
        bounds = ps._tile_bounds(o, d, TR, a)
        pt_, psc = pairs(q, ps.bin_pairs(sc_min, sc_max, o, d, cap, TR, a))
        res[q + "/member"] = ps._member_mask(bounds, pt_, psc, tables.cl_min,
                                             tables.cl_max, sc)
        cnt, perm = ps._member_runs(bounds, pt_, psc, tables.cl_min,
                                    tables.cl_max, sc)
        res[q + "/count"], res[q + "/perm"] = cnt, perm
        hit, total = ps.closest_hit_stream_flat(
            tables, sc_min, sc_max, o, d, a, tile_rays=TR, interpret=True)
        assert int(total) == pt_.shape[0]
        res[q + "/t"], res[q + "/tri"] = hit.t, hit.tri
        if name == "all":
            primary = hit

    # the shadow wavefront behind the primary hits, two lights
    valid = primary.tri >= 0
    point = o + d * jnp.where(valid, primary.t, 0.0)[:, None]
    shadow_o = point + jnp.asarray([[0.0, 1e-2, 0.0]], jnp.float32)
    lv = lp[:, None, :] - point[None]
    r2 = vecmath.length_squared(lv)
    ldir = vecmath.safe_normalize(lv)
    sact = jnp.stack([valid, valid & (point[:, 0] > 0)])
    res[p + "shadow_o"], res[p + "ldir"], res[p + "r2"] = shadow_o, ldir, r2
    res[p + "sact"] = sact
    tpl = R // TR
    apex = jnp.repeat(lp, tpl, axis=0)
    o_f = jnp.broadcast_to(shadow_o[None], (Ll, R, 3)).reshape(-1, 3)
    d_f, r2_f, a_f = ldir.reshape(-1, 3), r2.reshape(-1), sact.reshape(-1)
    scap = Ll * tpl * L2
    sl = jnp.float32(SLACK)

    extra = ps.lane_exact_sc_mask(o_f, d_f, r2_f, a_f, SLACK, sc_min, sc_max,
                                  TR)
    res[p + "lane_exact"] = extra
    sbounds = ps._tile_bounds(o_f, d_f, TR, a_f)
    for name, kw in (("apex", dict()),
                     ("near", dict(near_first=True)),
                     ("near_cap", dict(near_first=True, per_tile_cap=2)),
                     ("near_extra", dict(near_first=True, extra_mask=extra))):
        if not first and name in ("apex", "near"):
            continue
        q = p + name
        pt_, psc = pairs(q, ps.bin_pairs(sc_min, sc_max, o_f, d_f, scap, TR,
                                         a_f, apex=apex, apex_slack=SLACK,
                                         **kw))
        if name == "near_extra":
            res[q + "/member"] = ps._member_mask(
                sbounds, pt_, psc, tables.cl_min, tables.cl_max, sc,
                apex=apex, apex_slack=SLACK)

    def occ(**kw):
        return ps.occluded_stream_flat(tables, sc_min, sc_max, o_f, d_f, r2_f,
                                       a_f, apex, sl, tile_rays=TR,
                                       interpret=True, **kw)

    res[p + "occ"] = occ()
    res[p + "occ_cap"] = occ(per_tile_cap=2)
    if first:
        res[p + "occ_hull"] = occ(lane_exact=False)
    for k in spec["ks"][:1] if first else spec["ks"][1:]:
        res[p + f"two{k}"] = ps.occluded_stream_twophase(
            tables, sc_min, sc_max, shadow_o, ldir, r2, lp, sact, sl,
            tile_rays=TR, interpret=True, phase1_k=k)

tie = scene_from_dict(spec["tie_scene"], build_accel=False)
trace = ps.make_stream_trace_fn(tie, tile_rays=TR, interpret=True,
                                sc_clusters=1)
hit = trace(jnp.asarray(spec["tie_o"], jnp.float32),
            jnp.asarray(spec["tie_d"], jnp.float32))
res["tie/t"], res["tie/tri"] = hit.t, hit.tri
np.savez(out_path, **{k: np.asarray(v) for k, v in res.items()})
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_stream_ref")
    o, d = tie_rays()
    spec = {"scene": SCENE, "tr": TR, "slack": SLACK, "lights": LIGHTS,
            "scs": SCS, "ks": (1, 2), "tie_scene": tie_scene_dict(),
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
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(tmp / "ref.npz") as z:
        return dict(z)


def T(a):
    return torch.from_numpy(np.array(a))


def eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.fixture(scope="module")
def base_tables():
    return tct.build_cluster_tables(make_test_scene(**SCENE, device="cpu"))


def _stream_tables(base_tables, sc):
    return tst.build_stream_tables(base_tables, sc)


def _shadow(ref, sc):
    """The flat two-light shadow wavefront of the reference run."""
    p = f"sc{sc}/"
    shadow_o, ldir = T(ref[p + "shadow_o"]), T(ref[p + "ldir"])
    r2, sact = T(ref[p + "r2"]), T(ref[p + "sact"])
    Ll, R = r2.shape
    lp = torch.tensor(LIGHTS)
    apex = lp.repeat_interleave(R // TR, dim=0)
    o_f = shadow_o.expand(Ll, R, 3).reshape(-1, 3).contiguous()
    return dict(shadow_o=shadow_o, ldir=ldir, r2=r2, sact=sact, lp=lp,
                apex=apex, o_f=o_f, d_f=ldir.reshape(-1, 3).contiguous(),
                r2_f=r2.reshape(-1).contiguous(), a_f=sact.reshape(-1))


@pytest.mark.parametrize("sc", SCS)
def test_supercluster_boxes_and_fused_table(ref, base_tables, sc):
    st = _stream_tables(base_tables, sc)
    p = f"sc{sc}/"
    assert st.tables.n.shape[0] % sc == 0
    assert st.tables.n.shape[0] > base_tables.n.shape[0]  # padded
    eq(st.sc_min, ref[p + "sc_min"])
    eq(st.sc_max, ref[p + "sc_max"])
    for f in ("n", "nv0", "m", "c", "nobf", "tri_id", "cl_min", "cl_max"):
        eq(getattr(st.tables, f), ref[p + "tables/" + f])
    eq(st.fused, ref[p + "fused"])
    assert st.fused.shape[1:] == (16, 18)
    with pytest.raises(ValueError):
        tsb.build_supercluster_boxes(base_tables, 33)


@pytest.mark.parametrize("sc,name", [(4, "all"), (4, "masked"), (32, "all")])
def test_generic_pairs_members_and_closest_hit(ref, base_tables, sc, name):
    """bin_pairs, _member_mask / _member_runs and K8's plain version on the
    primary wavefront, without and with an active mask."""
    st = _stream_tables(base_tables, sc)
    q = f"sc{sc}/{name}"
    o, d = T(ref["o"]), T(ref["d"])
    act = None if name == "all" else T(ref["act"])
    bounds = tbin.tile_bounds(o, d, TR, act)
    pair_tile, pair_sc, tile_start = tsb.bin_pairs(st.sc_min, st.sc_max,
                                                   bounds)
    eq(pair_tile, ref[q + "/tile"])
    eq(pair_sc, ref[q + "/sc"])
    tiles = o.shape[0] // TR
    eq(tile_start[1:] - tile_start[:-1],
       np.bincount(ref[q + "/tile"], minlength=tiles))
    assert (torch.diff(pair_tile) >= 0).all()  # tile-major
    if act is not None:
        assert tile_start[1] == tile_start[2]  # the switched-off tile

    member = tsb._member_mask(bounds, pair_tile, pair_sc, st.tables.cl_min,
                              st.tables.cl_max, sc)
    eq(member, ref[q + "/member"])
    count, bits = tsb._member_runs(bounds, pair_tile, pair_sc,
                                   st.tables.cl_min, st.tables.cl_max, sc)
    eq(count, ref[q + "/count"])
    # the mask's set bits, lowest first == the live prefix of crt_tpu's
    # 5-bit-packed live-first permutation
    W = -(-sc // jps._PERM_PER_WORD)
    words = ref[q + "/perm"].reshape(-1, W).astype(np.uint64)
    idx = np.arange(sc)
    unpacked = (words[:, idx // jps._PERM_PER_WORD]
                >> ((idx % jps._PERM_PER_WORD) * jps._PERM_BITS
                    ).astype(np.uint64)) & np.uint64(31)
    b = bits.numpy().astype(np.int64) & 0xFFFFFFFF
    for p in range(b.shape[0]):
        live = [m for m in range(sc) if (b[p] >> m) & 1]
        assert live == unpacked[p, :len(live)].astype(int).tolist()
        assert len(live) == count[p]
    assert (count > 0).any() and (count < sc).any()

    hit, total = tst.closest_hit_stream_flat(st, o, d, act, TR)
    assert total == pair_tile.shape[0]
    eq(hit.tri, ref[q + "/tri"])
    eq(hit.t, ref[q + "/t"])
    assert (hit.tri >= 0).any() and (hit.tri < 0).any()


@pytest.mark.parametrize("sc", SCS)
def test_lane_exact_mask_and_shadow_pairs(ref, base_tables, sc):
    """lane_exact_sc_mask, and bin_pairs in its apex modes (plain,
    near_first, per_tile_cap, extra_mask) with their member masks."""
    st = _stream_tables(base_tables, sc)
    p = f"sc{sc}/"
    w = _shadow(ref, sc)
    extra = tsb.lane_exact_sc_mask(w["o_f"], w["d_f"], w["r2_f"], w["a_f"],
                                   SLACK, st.sc_min, st.sc_max, TR)
    eq(extra, ref[p + "lane_exact"])
    bounds = tbin.tile_bounds(w["o_f"], w["d_f"], TR, w["a_f"])
    hull = tsb.pair_mask(st.sc_min, st.sc_max, bounds, w["apex"], SLACK)
    # restricted to the hull's survivors it is the same mask there
    part = tsb.lane_exact_sc_mask(w["o_f"], w["d_f"], w["r2_f"], w["a_f"],
                                  SLACK, st.sc_min, st.sc_max, TR, where=hull)
    assert torch.equal(part, extra & hull)
    assert (hull & ~extra).any() or sc == 32  # it drops pairs the hull keeps

    for name, kw in (("apex", dict()),
                     ("near", dict(near_first=True)),
                     ("near_cap", dict(near_first=True, per_tile_cap=2)),
                     ("near_extra", dict(near_first=True, extra_mask=extra))):
        q = p + name
        if q + "/tile" not in ref:  # the reference lists fewer at sc 32
            continue
        pair_tile, pair_sc, tile_start = tsb.bin_pairs(
            st.sc_min, st.sc_max, bounds, w["apex"], SLACK, **kw)
        eq(pair_tile, ref[q + "/tile"])
        eq(pair_sc, ref[q + "/sc"])
        assert tile_start[-1] == pair_tile.shape[0]
        if name == "near_extra":
            eq(tsb._member_mask(bounds, pair_tile, pair_sc, st.tables.cl_min,
                                st.tables.cl_max, sc, w["apex"], SLACK),
               ref[q + "/member"])
        if name == "near_cap":
            assert (tile_start[1:] - tile_start[:-1]).max() <= 2
    with pytest.raises(ValueError):
        tsb.bin_pairs(st.sc_min, st.sc_max, bounds, w["apex"], SLACK,
                      per_tile_cap=2)


@pytest.mark.parametrize("mode", tsb.MODES)
@pytest.mark.parametrize("sc", SCS)
def test_bin_stream_equals_the_plain_composition(ref, base_tables, sc, mode):
    """``bin_stream`` on CPU tensors, in each mode, lists what the plain
    functions compose to (``tile_bounds``, ``pair_mask``,
    ``lane_exact_sc_mask``, ``bin_pairs``, ``_member_runs``) and, where the
    reference holds the list, crt_tpu's: the primary wavefront with its
    active mask in "rays", the two-light shadow wavefront in the shaft
    modes."""
    st = _stream_tables(base_tables, sc)
    boxes = (st.sc_min, st.sc_max, st.tables.cl_min, st.tables.cl_max)
    if mode == "rays":
        o, d, act = T(ref["o"]), T(ref["d"]), T(ref["act"])
        r2 = apex = None
    else:
        w = _shadow(ref, sc)
        o, d, r2, act, apex = (w["o_f"], w["d_f"], w["r2_f"], w["a_f"],
                               w["apex"])
    cap = 2 if mode == "shaft_capped" else None
    got = tsb.bin_stream(*boxes, o, d, TR, act, apex, SLACK, r2, cap,
                         lane_exact=mode != "shaft")

    bounds = tbin.tile_bounds(o, d, TR, act)
    extra = None
    if mode == "shaft_exact":
        hull = tsb.pair_mask(st.sc_min, st.sc_max, bounds, apex, SLACK)
        extra = tsb.lane_exact_sc_mask(o, d, r2, act, SLACK, st.sc_min,
                                       st.sc_max, TR, where=hull)
    pair_tile, pair_sc, tile_start = tsb.bin_pairs(
        st.sc_min, st.sc_max, bounds, apex, SLACK,
        near_first=apex is not None, per_tile_cap=cap, extra_mask=extra)
    _, bits = tsb._member_runs(bounds, pair_tile, pair_sc, st.tables.cl_min,
                               st.tables.cl_max, sc, apex, SLACK)
    assert got[0].dtype == got[1].dtype == got[2].dtype == torch.int32
    assert torch.equal(got[0], pair_sc.to(torch.int32))
    assert torch.equal(got[1], bits) and torch.equal(got[2], tile_start)
    assert got[0].shape[0] > 0
    q = f"sc{sc}/" + {"rays": "masked", "shaft_capped": "near_cap",
                      "shaft_exact": "near_extra", "shaft": "near"}[mode]
    if q + "/sc" in ref:
        eq(got[0], ref[q + "/sc"])
    if mode == "rays":
        with pytest.raises(ValueError):  # a cap needs the shaft
            tsb.bin_stream(*boxes, o, d, TR, act, per_tile_cap=2)


@pytest.mark.parametrize("sc", SCS)
def test_occlusion_stream_plain_matches_pallas(ref, base_tables, sc):
    """K9's plain version through occluded_stream_flat (complete walk with
    and without the per-lane admission, truncated walk) and through the
    two-phase resolve, lane for lane, inactive-lane convention included."""
    st = _stream_tables(base_tables, sc)
    p = f"sc{sc}/"
    w = _shadow(ref, sc)
    args = (st, w["o_f"], w["d_f"], w["r2_f"], w["a_f"], w["apex"], SLACK, TR)
    occ = tst.occluded_stream_flat(*args)
    eq(occ, ref[p + "occ"])
    eq(tst.occluded_stream_flat(*args, per_tile_cap=2), ref[p + "occ_cap"])
    assert occ[~w["a_f"]].all()  # inactive lanes return True
    act = w["a_f"]
    assert occ[act].any() and not occ[act].all()
    if sc == SCS[0]:
        hull = tst.occluded_stream_flat(*args, lane_exact=False)
        eq(hull, ref[p + "occ_hull"])
        assert torch.equal(hull, occ)  # the admission test changes no lane
    for k in ((1,) if sc == SCS[0] else (2,)):
        two = tst.occluded_stream_twophase(
            st, w["shadow_o"], w["ldir"], w["r2"], w["lp"], w["sact"], SLACK,
            TR, phase1_k=k)
        eq(two, ref[p + f"two{k}"])
        assert torch.equal(two.reshape(-1)[act], occ[act])


def test_exact_t_tie_first_walked_pair_wins(ref):
    """Two coplanar triangles in different clusters (and, at one cluster
    per supercluster, in different pairs): the cluster walked first wins
    every exact-t tie, as in the cluster backend."""
    scene = scene_from_dict(tie_scene_dict(), device="cpu")
    o, d = map(T, tie_rays())
    hit = tst.make_stream_trace_fn(scene, tile_rays=TR, sc_clusters=1)(o, d)
    assert (hit.tri == 16).all()
    eq(hit.tri, ref["tie/tri"])
    eq(hit.t, ref["tie/t"])
    chit = ttr.make_cluster_trace_fn(scene)(o, d)
    assert torch.equal(hit.tri, chit.tri) and torch.equal(hit.t, chit.t)


@pytest.mark.parametrize("sc", SCS)
def test_stream_hits_equal_cluster_and_bruteforce(base_tables, sc):
    """Streaming hits == the port's cluster hits (bit for bit, active mask
    and ragged padding included) == the all-pairs hits."""
    scene = make_test_scene(**SCENE, device="cpu")
    from crt_tpu_torch.ops import camera
    from crt_tpu_torch.renderer import make_tiler

    rx, ry, _ = make_tiler(scene.height, scene.width, device=scene.device)
    o, d = camera.generate_rays(scene.cam_position, scene.cam_rotation,
                                scene.cam_tan_half_fov, scene.width,
                                scene.height, rx, ry)
    stream = tst.make_stream_trace_fn(scene, sc_clusters=sc)
    cluster = ttr.make_cluster_trace_fn(scene)
    act = torch.arange(o.shape[0]) % 3 != 0
    for oo, dd, aa in ((o, d, None), (o, d, act),
                       (o[:1900], d[:1900], None)):
        h, c = stream(oo, dd, aa), cluster(oo, dd, aa)
        assert torch.equal(h.tri, c.tri) and torch.equal(h.t, c.t)
    h = stream(o, d)
    bf = tint.closest_hit_bruteforce(
        tint.build_triangle_data(
            scene.vertices, scene.tri_vidx,
            scene.mat_backface[scene.tri_material.long()]), o, d)
    # ids may differ only on exact-t ties (the floor's shared diagonal),
    # where the first cluster walked wins here and the smallest id there
    assert torch.equal(h.t, bf.t)
    assert (h.tri != bf.tri).float().mean() < 0.01
    assert stream.rank is not None and not stream.emits_rows


def test_wrappers_check_inputs(base_tables):
    st = _stream_tables(base_tables, 4)
    o = torch.zeros((TR, 3))
    d = torch.zeros((TR, 3))
    none = torch.zeros((0,), dtype=torch.int32)
    start = torch.zeros((2,), dtype=torch.int32)
    t, tri = tst.closest_hit_stream(st.fused, st.tables.tri_id, o, d, none,
                                    none, start, 4, TR)
    assert torch.isinf(t).all() and (tri == -1).all()  # no pair: all miss
    seed = torch.arange(TR) % 2 == 0
    occ = tst.occlusion_stream(st.fused, o, d, torch.ones(TR), seed, none,
                               none, start, 4, TR)
    assert torch.equal(occ, seed)  # no pair: the seed
    with pytest.raises(ValueError):
        tst.closest_hit_stream(st.fused, st.tables.tri_id, o[:100], d[:100],
                               none, none, start, 4, TR)
    with pytest.raises(ValueError):
        tst.closest_hit_stream(st.fused, st.tables.tri_id, o, d, none.long(),
                               none, start, 4, TR)
    with pytest.raises(ValueError):
        tst.closest_hit_stream(st.fused, st.tables.tri_id, o, d, none, none,
                               start[:1], 4, TR)
    with pytest.raises(ValueError):
        tst.occlusion_stream(st.fused, o, d, torch.ones(TR), seed.float(),
                             none, none, start, 4, TR)
    with pytest.raises(ValueError):
        tst.occlusion_stream(st.fused[:, :, :17].contiguous(), o, d,
                             torch.ones(TR), seed, none, none, start, 4, TR)


# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------

RENDER_SCENE = dict(width=64, height=36, num_quads=600, with_reflective=False)


def jax_stream_render(jscene, **settings_kw):
    """crt_tpu.render_image with its streaming backend in interpret mode."""
    orig = jrenderer.make_trace_fn

    def patched(scn, st):
        if st.backend == "pallas_stream":
            return jps.make_stream_trace_fn(scn, interpret=True,
                                            shadow_k=st.stream_shadow_k)
        return orig(scn, st)

    jrenderer.make_trace_fn = patched
    try:
        return np.asarray(crt_tpu.render_image(
            jscene, crt_tpu.RenderSettings(backend="pallas_stream",
                                           **settings_kw)))
    finally:
        jrenderer.make_trace_fn = orig


def test_stream_image_matches_crt_tpu(monkeypatch):
    ref = jax_stream_render(jmake_test_scene(**RENDER_SCENE))
    scene = make_test_scene(**RENDER_SCENE, device="cpu")
    with tracing.recording() as c:
        img = render_image(scene, RenderSettings(backend="pallas_stream"))
    # one pair list for the trace, one for phase 1, two for phase 2
    assert c["crt.host_reads.stream_nonzero"] == 4
    np.testing.assert_allclose(img.numpy(), ref, rtol=1e-5, atol=1e-6)
    lit = (img != scene.background_color).any(dim=-1)
    assert lit.any() and not lit.all()
    # the port's own names and backends agree bit for bit
    for kw in (dict(backend="stream"), dict(backend="cluster"),
               dict(backend="stream", stream_shadow_k=0),
               dict(backend="stream", stream_shadow_k=5)):
        assert torch.equal(render_image(scene, RenderSettings(**kw)), img), kw
    # on the CPU "auto" stays with the cluster backend whatever the size
    monkeypatch.setattr(trenderer, "AUTO_STREAM_MIN_CLUSTERS", 1)
    assert trenderer.make_trace_fn(scene, RenderSettings()).emits_rows


def test_stream_grads_match_jax():
    jscene = jmake_test_scene(24, 16, num_quads=4)
    arrays = trainable(jscene)
    v, g = torch_value_and_grads(carry(jscene), arrays,
                                 RenderSettings(backend="pallas_stream"))
    jv, jg = jax_value_and_grads(jscene, arrays, "bruteforce")
    np.testing.assert_allclose(v, jv, rtol=1e-5)
    assert all(np.abs(jg[k]).max() > 0 for k in GROUPS)
    assert_grads_close(g, jg)


def test_stream_and_cluster_grads_agree():
    """On a scene of several clusters the two backends find the same hits
    bit for bit (exact-t ties included, which the all-pairs backend breaks
    the other way), so their gradients agree: the packed rows gathered at
    the streaming trace's ids vs the rows the cluster kernel emits."""
    jscene = jmake_test_scene(24, 16, num_quads=40)
    arrays = trainable(jscene)
    v, g = torch_value_and_grads(carry(jscene), arrays,
                                 RenderSettings(backend="stream"))
    vc, gc = torch_value_and_grads(carry(jscene), arrays,
                                   RenderSettings(backend="cluster"))
    assert v == vc
    assert_grads_close(g, gc)


@pytest.mark.parametrize("backend", ["stream", "pallas_stream"])
def test_cli_takes_the_streaming_backend(tmp_path, backend):
    from crt_tpu_torch.frontend import cli
    from crt_tpu_torch.scene.procedural import make_test_scene_dict

    path = tmp_path / "scene.crtscene"
    path.write_text(json.dumps(make_test_scene_dict(48, 32, num_quads=40)))
    outs = {}
    for name in (backend, "cluster"):
        out = tmp_path / f"{name}.ppm"
        assert cli.main([str(path), str(out), "--device", "cpu",
                         "--backend", name]) == 0
        outs[name] = out.read_text()
    assert outs[backend] == outs["cluster"]
    assert outs[backend].startswith("P3\n48 32\n255\n")

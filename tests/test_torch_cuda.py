"""The CUDA kernels vs their plain versions, on the card.

Marked ``cuda``: these tests need an NVIDIA GPU and nvcc, and skip
elsewhere (the decision is taken inside a fixture, never at import).  This
file imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:xdist \
        -o addopts="" -q

Tolerance: the trace kernels EXACT.  They are built with -fmad=false and
without fast math and follow the plain versions' op order, so tri, t, rows
and masks must be bit-equal.  The segment-sum kernel adds f32 terms in
another order than ``index_add_`` (and, through atomics, in an order that
can change between runs), so it is held to an fp64 sum of the same terms:
|kernel - fp64| <= 4e-6 * (sum of |g| over the segment): ten times the
largest error read on an H100 (3.7e-7, on a 640,651-ray segment of a 1080p
frame) and a tenth of the worst case of its ~5 + 128 + R / 4096 sequential
f32 additions per segment at 2^-24 each, so a kernel that lost 1e-5 of a
segment's rays fails.  Against the plain version the limit is 5e-4 of the
same sum, four times the plain version's own distance from fp64 (1.3e-4
read there: one f32 atomic per term).
"""

import pathlib

import pytest
import torch

from crt_tpu_torch import RenderSettings, render_aov, render_image
from crt_tpu_torch import scene_from_dict
from crt_tpu_torch.ops import (
    binning,
    camera,
    cluster_tables,
    cluster_trace,
    segsum,
    stream_binning,
    stream_trace,
    vecmath,
)
from crt_tpu_torch.renderer import (
    AOVS,
    _render_flat,
    make_tiler,
    make_trace_fn,
)
from crt_tpu_torch.scene.procedural import (
    make_big_scene,
    make_test_scene,
    make_test_scene_dict,
)
from crt_tpu_torch.utils import trace as tracing

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _counting():
    """Every test counts in the port's registry (``utils/trace.py``)."""
    with tracing.recording():
        yield


def launched(kernel: str) -> int:
    """Launches of ``kernel``, every mode and layout, counted so far."""
    return tracing.total(tracing.counters(), "crt.launches." + kernel)


def modes(kernel: str, names) -> dict:
    """Launches of ``kernel`` by mode (or layout) -> {name: count}."""
    c = tracing.counters()
    return {m: c[f"crt.launches.{kernel}.{m}"] for m in names}


def _wavefront(scene):
    rx, ry, _ = make_tiler(scene.height, scene.width, device=scene.device)
    o, d = camera.generate_rays(scene.cam_position, scene.cam_rotation,
                                scene.cam_tan_half_fov, scene.width,
                                scene.height, rx, ry)
    return o.contiguous(), d.contiguous()


@pytest.mark.parametrize("big", [False, True])
def test_closest_hit_kernel_matches_plain(device, big):
    scene = (make_big_scene(4096, 128, 96, device=device) if big
             else make_test_scene(192, 128, num_quads=24, device=device))
    tables = cluster_tables.build_cluster_tables(scene)
    rows_table = cluster_tables.emit_rows_table(scene, tables)
    o, d = _wavefront(scene)
    act = torch.arange(o.shape[0], device=device) % 3 != 0
    cl, cnt = binning.bin_rays(tables, o, d, 1024, act)
    before = launched("closest_hit")
    k = cluster_trace.closest_hit(tables, o, d, cl, cnt, rows_table)
    assert launched("closest_hit") == before + 1
    p = cluster_trace.closest_hit_plain(tables, o, d, cl, cnt, rows_table)
    torch.cuda.synchronize()
    assert torch.equal(k[1], p[1])
    assert torch.equal(k[0], p[0])
    assert torch.equal(k[2], p[2])
    assert (k[1] >= 0).any()


def test_occlusion_w_kernel_matches_plain(device):
    scene = make_test_scene(192, 128, num_quads=24, device=device)
    tables = cluster_tables.build_cluster_tables(scene)
    o, d = _wavefront(scene)
    t, tri, _ = cluster_trace.closest_hit(
        tables, o, d, *binning.bin_rays(tables, o, d, 1024))
    valid = tri >= 0
    point = (o + d * torch.where(valid, t, 0.0)[:, None]).contiguous()
    shadow_o = (point + 0.01 * torch.tensor([0.0, 1.0, 0.0],
                                            device=device)).contiguous()
    lights = scene.light_position.contiguous()
    act = torch.stack([valid, valid & (point[:, 0] > 0)])
    cl, cnt = binning.bin_apex_shared(tables, shadow_o, lights, act, 1024,
                                      0.02)
    before = launched("occlusion_w")
    k = cluster_trace.occlusion_w(tables, shadow_o, point, lights, cl, cnt)
    assert launched("occlusion_w") == before + 1
    p = cluster_trace.occlusion_w_plain(tables, shadow_o, point, lights, cl,
                                        cnt)
    torch.cuda.synchronize()
    assert torch.equal(k, p)
    assert k.any() and not k.all()


def _shadow_wavefront(scene, tables):
    """(shadow_o, point, lights, act [Ll, R]) behind the primary hits."""
    o, d = _wavefront(scene)
    t, tri, _ = cluster_trace.closest_hit(
        tables, o, d, *binning.bin_rays(tables, o, d, 1024))
    valid = tri >= 0
    point = (o + d * torch.where(valid, t, 0.0)[:, None]).contiguous()
    up = torch.tensor([0.0, 1.0, 0.0], device=o.device)
    act = torch.stack([valid, valid & (point[:, 0] > 0)])
    return ((point + 0.01 * up).contiguous(), point,
            scene.light_position.contiguous(), act)


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("mode", ["glass", "glass_uncapped",
                                  "uncapped_masked", "uncapped",
                                  "capped_masked"])
def test_occlusion_w_modes_match_plain(device, mode, sparse):
    """Every mode of the w-occlusion kernel vs its plain version, lane for
    lane, on a full and on a tile-sparse shadow wavefront (three tiles in
    four switched off, so most blocks take the empty-list exit)."""
    scene = make_test_scene(192, 128, num_quads=24, with_refractive=True,
                            device=device)
    tables = cluster_tables.build_cluster_tables(scene)
    gm, gmin, gmax = cluster_tables.glass_subset(scene, tables)
    shadow_o, point, lights, act = _shadow_wavefront(scene, tables)
    if sparse:
        tile = torch.arange(act.shape[1], device=device) // 1024
        act = act & (tile % 4 == 0)
    kw = dict(glass=dict(member_mask=gm, glass_flag=True),
              glass_uncapped=dict(capped=False, member_mask=gm,
                                  glass_flag=True),
              uncapped_masked=dict(capped=False, member_mask=gm),
              uncapped=dict(capped=False),
              capped_masked=dict(member_mask=gm))[mode]
    bin_kw = dict(glass=dict(glass_boxes=(gmin, gmax)),
                  glass_uncapped=dict(glass_boxes=(gmin, gmax)),
                  uncapped_masked=dict(boxes=(gmin, gmax), capped=False),
                  uncapped=dict(capped=False),
                  capped_masked=dict(boxes=(gmin, gmax)))[mode]
    cl, cnt = binning.bin_apex_shared(tables, shadow_o, lights, act, 1024,
                                      0.02, **bin_kw)
    name = cluster_trace.occlusion_mode(kw.get("capped", True),
                                        kw.get("glass_flag", False))
    before = modes("occlusion_w", ("capped", "uncapped", "glass"))
    with tracing.recording() as c:
        k = cluster_trace.occlusion_w(tables, shadow_o, point, lights, cl,
                                      cnt, **kw)
    after = modes("occlusion_w", ("capped", "uncapped", "glass"))
    assert after[name] == before[name] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    p = cluster_trace.occlusion_w_plain(tables, shadow_o, point, lights, cl,
                                        cnt, **kw)
    torch.cuda.synchronize()
    if mode.startswith("glass"):
        assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
        assert k[1].any() and not k[1].all()
        k = k[0]
    else:
        assert torch.equal(k, p)
    assert k.any() and not k.all()
    if sparse:
        assert (cnt == 0).sum() >= cnt.numel() // 2
        dead = (cnt == 0).repeat_interleave(1024)
        assert not k[dead].any()
    # lists of at most CRT_VOTE_LIST clusters keep the plain barrier
    assert int(cnt.max()) <= 32 and c["crt.shadow.repacks"] == 0
    assert c["crt.shadow.lane_tests"] > 0


def test_glass_flag_found_behind_an_opaque_blocker(device):
    """A lane blocked by an opaque triangle of an early cluster still finds
    the glass of a later one, also when the glass comes in a later staging
    batch: the walk may leave only when the lane is blocked and flagged."""
    from crt_tpu_torch import scene_from_dict

    def tri(x, y, z, mat):
        return {"material_index": mat, "triangles": [0, 1, 2],
                "vertices": [x - 3, y, z - 3, x + 3, y, z - 3, x, y, z + 3]}

    # 16 opaque slabs at y = 1 fill cluster 0 (x sorts first), one glass
    # slab at y = 2 lands in cluster 1; the light sits above both
    objects = [tri(-0.5 + 0.001 * i, 1.0, 0.0, 0) for i in range(16)]
    objects.append(tri(4.0, 2.0, 0.0, 1))
    objects.append(tri(0.0, 2.0, 0.0, 1))
    scene_spec = {
        "settings": {"background_color": [0, 0, 0],
                     "image_settings": {"width": 32, "height": 32}},
        "camera": {"matrix": [1, 0, 0, 0, 1, 0, 0, 0, 1],
                   "position": [0, 0, 5]},
        "lights": [{"intensity": 10, "position": [0, 5, 0]}],
        "materials": [{"type": "diffuse", "albedo": [1, 1, 1],
                       "smooth_shading": False},
                      {"type": "refractive", "ior": 1.5,
                       "smooth_shading": False}],
        "objects": list(objects)}
    scene = scene_from_dict(scene_spec, device=device)
    tables = cluster_tables.build_cluster_tables(scene)
    gm, gmin, gmax = cluster_tables.glass_subset(scene, tables)
    assert not gm[0].any() and gm[1].any()
    g = torch.linspace(-0.4, 0.4, 32, device=device)
    x, z = torch.meshgrid(g, g, indexing="ij")
    point = torch.stack([x.reshape(-1), torch.zeros(1024, device=device),
                         z.reshape(-1)], dim=-1).contiguous()
    shadow_o = (point + torch.tensor([0.0, 0.01, 0.0], device=device)
                ).contiguous()
    lights = scene.light_position.contiguous()
    act = torch.ones((1, 1024), dtype=torch.bool, device=device)
    cl, cnt = binning.bin_apex_shared(tables, shadow_o, lights, act, 1024,
                                      0.02, glass_boxes=(gmin, gmax))
    assert cl[0, :2].tolist() == [0, 1] and int(cnt[0]) == 2
    occ, glass = cluster_trace.occlusion_w(
        tables, shadow_o, point, lights, cl, cnt, member_mask=gm,
        glass_flag=True)
    p_occ, p_glass = cluster_trace.occlusion_w_plain(
        tables, shadow_o, point, lights, cl, cnt, member_mask=gm,
        glass_flag=True)
    assert occ.all() and glass.all()
    assert torch.equal(occ, p_occ) and torch.equal(glass, p_glass)

    # the glass in a later staging batch than the blocker: with fillers
    # far off (never hit) for enough clusters, the opaque cluster walked 8
    # times fills batch 0 and the glass cluster comes in batch 1
    for i in range(16 * 8):
        objects.append(tri(20.0 + 0.1 * i, -20.0, 20.0, 0))
    scene = scene_from_dict(dict(scene_spec, objects=objects), device=device)
    tables = cluster_tables.build_cluster_tables(scene)
    gm, _, _ = cluster_tables.glass_subset(scene, tables)
    assert not gm[0].any() and gm[1].any() and tables.n.shape[0] >= 9
    cl = torch.zeros((1, tables.n.shape[0]), dtype=torch.int32,
                     device=device)
    cl[0, 8] = 1
    cnt = torch.full((1,), 9, dtype=torch.int32, device=device)
    occ, glass = cluster_trace.occlusion_w(
        tables, shadow_o, point, lights, cl, cnt, member_mask=gm,
        glass_flag=True)
    p_occ, p_glass = cluster_trace.occlusion_w_plain(
        tables, shadow_o, point, lights, cl, cnt, member_mask=gm,
        glass_flag=True)
    assert occ.all() and glass.all()
    assert torch.equal(occ, p_occ) and torch.equal(glass, p_glass)


def _same_bits(a, b):
    """Float tensors equal bit for bit (-0.0 and +0.0 differ)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _hits_equal(got, want):
    """(t, tri, rows) of two closest-hit launches equal bit for bit."""
    assert _same_bits(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (got[2] is None) == (want[2] is None)
    if got[2] is not None:
        assert _same_bits(got[2], want[2])


@pytest.fixture(scope="module")
def long_lists(device):
    """A 65,536-triangle scene (4,096 clusters) at 256x128: primary lists
    and capped shadow lists much longer than one staging batch of the
    cluster kernels (CRT_BATCH = 8 clusters)."""
    scene = make_big_scene(65536, 256, 128, seed=1, device=device)
    tables = cluster_tables.build_cluster_tables(scene)
    rows_table = cluster_tables.emit_rows_table(scene, tables)
    o, d = _wavefront(scene)
    cl, cnt = binning.bin_rays(tables, o, d, 1024)
    shadow_o, point, lights, act = _shadow_wavefront(scene, tables)
    act = act[:1]
    scl, scnt = binning.bin_apex_shared(tables, shadow_o, lights[:1], act,
                                        1024, 0.02)
    return dict(tables=tables, rows_table=rows_table, o=o, d=d, cl=cl,
                cnt=cnt, shadow=(shadow_o, point, lights[:1].contiguous()),
                act=act, scl=scl, scnt=scnt)


def _kd_wave(tables, shadow_o, point, lights, act, tile_rays=1024):
    """The direction form of a shadow wavefront (shadow_o, point [R, 3],
    lights [Ll, 3], act [Ll, R]): the flat o, d, r2 and active lanes, K5's
    shaft lists and K6's generic lists."""
    lv = lights[:, None, :] - point[None]
    Ll, R = act.shape
    o_f = shadow_o.expand(Ll, R, 3).reshape(-1, 3).contiguous()
    d_f = vecmath.safe_normalize(lv).reshape(-1, 3).contiguous()
    a_f = act.reshape(-1)
    tpl = R // tile_rays
    return dict(o=shadow_o, o_f=o_f, d_f=d_f, a_f=a_f, tpl=tpl,
                r2_f=vecmath.length_squared(lv).reshape(-1).contiguous(),
                tile_rays=tile_rays,
                shaft=binning.bin_rays(
                    tables, o_f, d_f, tile_rays, a_f,
                    apex=lights.repeat_interleave(tpl, dim=0),
                    apex_slack=0.02),
                generic=binning.bin_rays(tables, o_f, d_f, tile_rays, a_f))


def _kd_equal(tables, w, exit):
    """K5 (or K6, ``exit``) on ``w`` (_kd_wave) equal to the plain version
    on every lane -> (the kernel's mask, its counts)."""
    tr = w["tile_rays"]
    if exit:
        cl, cnt = w["generic"]
        args = (tables, w["o_f"], w["d_f"], w["r2_f"], cl, cnt, tr)
        k = cluster_trace.occlusion_d(*args, exit=True, active=w["a_f"])
        p = cluster_trace.occlusion_d_plain(*args, seed=~w["a_f"])
    else:
        cl, cnt = w["shaft"]
        args = (tables, w["o"], w["d_f"], w["r2_f"], cl, cnt, tr)
        k = cluster_trace.occlusion_d(*args, tile_mod=w["tpl"])
        p = cluster_trace.occlusion_d_plain(*args, tile_mod=w["tpl"])
    torch.cuda.synchronize()
    assert torch.equal(k, p)
    return k, cnt


@pytest.mark.parametrize("kernel", ["closest_hit", "compact", "merged",
                                    "occlusion_w", "occlusion_d",
                                    "occlusion_d_exit"])
def test_cluster_kernels_on_lists_longer_than_a_batch(device, long_lists,
                                                      kernel):
    """K1 (and K4 / K7, which take its walk), K2, K5 and K6 on lists of
    tens to hundreds of clusters, staged in many batches: bit-equal to the
    plain version on every lane; the any-hit walks repack their unfinished
    lanes there."""
    L = long_lists
    tables, o, d = L["tables"], L["o"], L["d"]
    if kernel.startswith("occlusion_d"):
        w = _kd_wave(tables, *L["shadow"], L["act"])
        with tracing.recording() as c:
            k, cnt = _kd_equal(tables, w, kernel == "occlusion_d_exit")
        assert int(cnt.max()) > 8 * 8
        act = w["a_f"]
        assert k[act].any() and not k[act].all()
        assert c["crt.shadow.repacks"] > 0
        return
    if kernel == "occlusion_w":
        assert int(L["scnt"].max()) > 8 * 8
        with tracing.recording() as c:
            k = cluster_trace.occlusion_w(tables, *L["shadow"], L["scl"],
                                          L["scnt"])
        p = cluster_trace.occlusion_w_plain(tables, *L["shadow"], L["scl"],
                                            L["scnt"])
        torch.cuda.synchronize()
        assert torch.equal(k, p) and k.any() and not k.all()
        assert c["crt.shadow.repacks"] > 0
        assert c["crt.shadow.lane_tests"] > 0
        return
    cl, cnt, rows_table = L["cl"], L["cnt"], L["rows_table"]
    assert int(cnt.min()) > 8 and int(cnt.max()) > 8 * 8
    fn = dict(closest_hit=cluster_trace.closest_hit,
              compact=cluster_trace.closest_hit_compact,
              merged=cluster_trace.closest_hit_merged)[kernel]
    k = fn(tables, o, d, cl, cnt, rows_table)
    p = cluster_trace.closest_hit_plain(tables, o, d, cl, cnt, rows_table)
    torch.cuda.synchronize()
    _hits_equal(k, p)
    assert (k[1] >= 0).any() and (k[1] < 0).any()


@pytest.mark.parametrize("first", ["A", "B"])
def test_exact_t_ties_across_batches(device, first):
    """The tie scene of test_torch_trace_kernels.py with -0.0 / +0.0 ties
    (test_torch_stream_chunks.py), with fillers behind the camera for
    enough clusters: A's cluster and B's walked in different staging
    batches (the first of them repeated to fill batch 0).  The cluster
    walked first wins every exact-t tie, with its own zero; bit-equal to
    the plain version."""
    import numpy as np
    from crt_tpu_torch import scene_from_dict
    from test_torch_stream_chunks import tie_scene_negzero

    spec, o, d = tie_scene_negzero()
    for i in range(16 * 9):  # behind the camera (it looks down -z)
        x = 10.0 + 0.1 * i
        spec["objects"].append({
            "material_index": 0, "triangles": [0, 1, 2],
            "vertices": [x, 10, 20, x + 0.05, 10, 20, x, 10.05, 20]})
    scene = scene_from_dict(spec, device=device)
    tables = cluster_tables.build_cluster_tables(scene)
    ids = tables.tri_id.cpu()
    c_a = int(torch.nonzero(ids == 16)[0, 0])  # A
    c_b = int(torch.nonzero(ids == 15)[0, 0])  # B
    assert c_a != c_b and tables.n.shape[0] >= 9
    o = torch.from_numpy(np.ascontiguousarray(o)).to(device)
    d = torch.from_numpy(np.ascontiguousarray(d)).to(device)
    walk = [c_a] * 8 + [c_b] if first == "A" else [c_b] * 8 + [c_a]
    tiles = o.shape[0] // 1024
    cl = torch.zeros((tiles, tables.n.shape[0]), dtype=torch.int32)
    cl[:, :9] = torch.tensor(walk, dtype=torch.int32)
    cl = cl.to(device)
    cnt = torch.full((tiles,), 9, dtype=torch.int32, device=device)
    k = cluster_trace.closest_hit(tables, o, d, cl, cnt)
    p = cluster_trace.closest_hit_plain(tables, o, d, cl, cnt)
    torch.cuda.synchronize()
    _hits_equal(k, p)
    assert (k[1] == (16 if first == "A" else 15)).all()
    # on the second tile's rays A's t is -0.0 and B's +0.0
    negative = torch.signbit(k[0][1024:])
    assert negative.all() if first == "A" else not negative.any()


@pytest.mark.parametrize("kernel", ["closest_hit", "occlusion_w",
                                    "occlusion_d", "occlusion_d_exit"])
def test_dead_tiles_between_live_ones(device, kernel):
    """A wavefront of more units (256-lane quarter tiles) than the
    persistent grid has blocks, its tiles dead and live in a pattern, so
    each block walks some units and writes the miss result of others:
    bit-equal to the plain version on every lane, misses on dead tiles
    (K6: their seeds)."""
    scene = make_test_scene(1024, 512, num_quads=24, device=device)
    tables = cluster_tables.build_cluster_tables(scene)
    tile = torch.arange(1024 * 512, device=device) // 1024
    keep = (tile % 5 == 1) | (tile % 7 == 3)
    if kernel == "closest_hit":
        rows_table = cluster_tables.emit_rows_table(scene, tables)
        o, d = _wavefront(scene)
        cl, cnt = binning.bin_rays(tables, o, d, 1024, keep)
        k = cluster_trace.closest_hit(tables, o, d, cl, cnt, rows_table)
        p = cluster_trace.closest_hit_plain(tables, o, d, cl, cnt, rows_table)
        torch.cuda.synchronize()
        _hits_equal(k, p)
        dead = (cnt == 0).repeat_interleave(1024)
        assert dead.any() and (~dead).any()
        assert (k[1][dead] == -1).all() and not k[2][:, dead].any()
        return
    shadow_o, point, lights, act = _shadow_wavefront(scene, tables)
    act = act & keep
    if kernel.startswith("occlusion_d"):
        w = _kd_wave(tables, shadow_o, point, lights, act)
        exit = kernel == "occlusion_d_exit"
        k, cnt = _kd_equal(tables, w, exit)
        dead = (cnt == 0).repeat_interleave(1024)
        assert dead.any() and (~dead).any() and k[~dead].any()
        assert torch.equal(k[dead], ~w["a_f"][dead] if exit
                           else torch.zeros_like(k[dead]))
        return
    cl, cnt = binning.bin_apex_shared(tables, shadow_o, lights, act, 1024,
                                      0.02)
    k = cluster_trace.occlusion_w(tables, shadow_o, point, lights, cl, cnt)
    p = cluster_trace.occlusion_w_plain(tables, shadow_o, point, lights, cl,
                                        cnt)
    torch.cuda.synchronize()
    assert torch.equal(k, p) and k.any()
    assert (cnt == 0).any() and (cnt > 0).any()


@pytest.mark.parametrize("kp", [0, 1, 7])
def test_closest_hit_rows_of_any_width(device, kp):
    """K1's rows epilogue at kp = 0 (no rows table), 1 and an odd width:
    bit-equal to the plain version (t, tri and rows) on a masked
    wavefront."""
    scene = make_test_scene(192, 128, num_quads=24, device=device)
    tables = cluster_tables.build_cluster_tables(scene)
    rows_table = cluster_tables.emit_rows_table(scene, tables)
    rows_table = rows_table[..., -kp:].contiguous() if kp else None
    o, d = _wavefront(scene)
    act = torch.arange(o.shape[0], device=device) % 3 != 0
    cl, cnt = binning.bin_rays(tables, o, d, 1024, act)
    k = cluster_trace.closest_hit(tables, o, d, cl, cnt, rows_table)
    p = cluster_trace.closest_hit_plain(tables, o, d, cl, cnt, rows_table)
    torch.cuda.synchronize()
    assert _same_bits(k[0], p[0]) and torch.equal(k[1], p[1])
    if kp:
        assert _same_bits(k[2], p[2]) and k[2].shape == (kp, o.shape[0])
    else:
        assert k[2] is None and p[2] is None


@pytest.mark.parametrize("long", [False, True])
@pytest.mark.parametrize("mode", ["capped", "uncapped_masked", "glass"])
def test_occlusion_w_with_repeated_rays(device, long_lists, mode, long):
    """Lanes that share their warp's first lane's ray, bit for bit, take
    its answer: every other warp of the wavefront repeats that lane's ray
    (as a frame's lanes without a hit repeat the camera's), the rest are
    distinct; bit-equal to the plain version in each mode, on short lists
    and on long_lists' (a subset of every third member for the masked
    modes), where the walk may also repack (never on the short ones)."""
    if long:
        tables = long_lists["tables"]
        shadow_o, point, lights = long_lists["shadow"]
        gm = (tables.tri_id % 3 == 0).to(torch.float32).contiguous()
    else:
        scene = make_test_scene(192, 128, num_quads=24,
                                with_refractive=True, device=device)
        tables = cluster_tables.build_cluster_tables(scene)
        gm, gmin, gmax = cluster_tables.glass_subset(scene, tables)
        shadow_o, point, lights, act = _shadow_wavefront(scene, tables)
    lane = torch.arange(shadow_o.shape[0], device=device)
    lead = lane - lane % 32
    rep = (lane // 32) % 2 == 1
    src = torch.where(rep, lead, lane)
    shadow_o, point = shadow_o[src].contiguous(), point[src].contiguous()
    kw = dict(capped={}, uncapped_masked=dict(capped=False, member_mask=gm),
              glass=dict(member_mask=gm, glass_flag=True))[mode]
    if long:
        cl, cnt = long_lists["scl"], long_lists["scnt"]
    else:
        bin_kw = dict(capped={},
                      uncapped_masked=dict(boxes=(gmin, gmax), capped=False),
                      glass=dict(glass_boxes=(gmin, gmax)))[mode]
        cl, cnt = binning.bin_apex_shared(tables, shadow_o, lights, act, 1024,
                                          0.02, **bin_kw)
    with tracing.recording() as c:
        k = cluster_trace.occlusion_w(tables, shadow_o, point, lights, cl,
                                      cnt, **kw)
    p = cluster_trace.occlusion_w_plain(tables, shadow_o, point, lights, cl,
                                        cnt, **kw)
    torch.cuda.synchronize()
    k = k if isinstance(k, tuple) else (k,)
    p = p if isinstance(p, tuple) else (p,)
    for got, want in zip(k, p):
        assert torch.equal(got, want)
    assert k[0].any() and not k[0].all()
    assert (int(cnt.max()) > 32) == long  # CRT_VOTE_LIST
    if not long:
        assert c["crt.shadow.repacks"] == 0


@pytest.mark.parametrize("long", [False, True])
@pytest.mark.parametrize("exit", [False, True])
def test_occlusion_d_with_repeated_rays(device, long_lists, exit, long):
    """K5 and K6 where every other warp repeats its first lane's ray (o, d
    and r2 bit for bit, as a frame's lanes without a hit repeat the
    camera's) and, in those warps, the first lane is inactive (K6 seeds
    it, so the warp's first unseeded lane leads), on short lists (each
    lane walks its own ray) and on long_lists' (repeated rays packed):
    bit-equal to the plain version on every lane."""
    if long:
        tables = long_lists["tables"]
        shadow_o, point, lights = long_lists["shadow"]
        act = long_lists["act"]
    else:
        scene = make_test_scene(192, 128, num_quads=24, device=device)
        tables = cluster_tables.build_cluster_tables(scene)
        shadow_o, point, lights, act = _shadow_wavefront(scene, tables)
    lane = torch.arange(shadow_o.shape[0], device=device)
    rep = (lane // 32) % 2 == 1
    src = torch.where(rep, lane - lane % 32, lane)
    act = act & (lane % 64 != 32)
    w = _kd_wave(tables, shadow_o[src].contiguous(), point[src].contiguous(),
                 lights, act)
    k, cnt = _kd_equal(tables, w, exit)
    assert k[w["a_f"]].any() and not k[w["a_f"]].all()
    assert (int(cnt.max()) > 32) == long  # CRT_VOTE_LIST


# The walk scene: a grid of WALK_GRID x WALK_GRID opaque triangles at y =
# 1, one a unit cell, a light at (0, WALK_LIGHT_Y, 0), and above the light
# a patch of quads (x in [0, 8]) that only an uncapped ray reaches; its
# clusters come last on every list, after the grid's 64.
WALK_GRID = 32
WALK_LIGHT_Y = 8.0
WALK_BIAS = 0.01
NEVER = -1


@pytest.fixture(scope="module")
def walk_scene(device):
    """The walk scene's tables, its lights, the list order (the grid's
    clusters, then the patch's) and the patch as a member subset."""
    tris, verts = [], []

    def tri(*corners):
        tris.extend(range(len(verts) // 3, len(verts) // 3 + 3))
        for c in corners:
            verts.extend(c)

    for i in range(WALK_GRID):
        for j in range(WALK_GRID):
            x, z = i - WALK_GRID / 2 + 0.5, j - WALK_GRID / 2 + 0.5
            tri([x - 0.4, 1.0, z - 0.4], [x + 0.4, 1.0, z - 0.4],
                [x, 1.0, z + 0.4])
    grid = len(tris) // 3
    for i in range(8):
        for j in range(-8, 8):
            tri([i, 10.0, j], [i + 1, 10.0, j], [i, 10.0, j + 1])
            tri([i + 1, 10.0, j], [i + 1, 10.0, j + 1], [i, 10.0, j + 1])
    scene = scene_from_dict({
        "settings": {"background_color": [0, 0, 0],
                     "image_settings": {"width": 32, "height": 32}},
        "camera": {"matrix": [1, 0, 0, 0, 1, 0, 0, 0, 1],
                   "position": [0, 0, 30]},
        "lights": [{"intensity": 10, "position": [0, WALK_LIGHT_Y, 0]}],
        "materials": [{"type": "diffuse", "albedo": [1, 1, 1],
                       "smooth_shading": False}],
        "objects": [{"material_index": 0, "triangles": tris,
                     "vertices": verts}]}, device=device)
    tables = cluster_tables.build_cluster_tables(scene)
    ids = tables.tri_id
    patch = ids >= grid
    assert not (patch.any(dim=1)[:, None] & (ids >= 0) & ~patch).any()
    order = torch.argsort(patch.any(dim=1).to(torch.int8), stable=True)
    assert int((~patch.any(dim=1)).sum()) == 64
    return dict(tables=tables, lights=scene.light_position.contiguous(),
                order=order.to(torch.int32), subset=patch.float().contiguous())


def walk_rays(w, case, R=4096):
    """(shadow_o, point, batch) of ``case`` on the walk scene: lane i's ray
    to the light crosses the grid at the centre of a triangle of a cluster
    in staging batch batch[i] of the list (8 clusters a batch), or
    (NEVER) beside the grid.  staggered: batches 0-7 and NEVER mixed within
    every warp; one_lit_a_warp: one NEVER lane a warp, the rest batch 0;
    all_but_one: one NEVER lane a tile; repeated: staggered, with a third
    of the warps repeating their first lane's ray and a third their
    second lane's (as a frame's lanes without a hit repeat the camera's
    after a hit), the rest distinct."""
    dev = w["order"].device
    lane = torch.arange(R, device=dev)
    warp = lane // 32
    if case == "one_lit_a_warp":
        batch = torch.where(lane % 32 == warp % 32, NEVER, 0)
    elif case == "all_but_one":
        batch = torch.where(lane % 1024 == 777, NEVER, 0)
    else:
        batch = (lane % 32 + warp) % 9
        batch = torch.where(batch == 8, NEVER, batch)
    cl = w["order"][(8 * batch.clamp(min=0) + lane % 8).long()].long()
    t = w["tables"].tri_id[cl, (lane // 8) % 16].long()
    x = (t // WALK_GRID).float() - WALK_GRID / 2 + 0.5
    z = (t % WALK_GRID).float() - WALK_GRID / 2 + 0.5
    never = batch == NEVER
    x = torch.where(never, WALK_GRID / 2 + 3.0 + 0.01 * (lane % 7), x)
    z = torch.where(never, (lane % 16).float() - 8.0, z)
    # o = p + bias up crosses y = 1 at x / (1 - s) * (1 - s) = x
    s = (1.0 - WALK_BIAS) / WALK_LIGHT_Y
    point = torch.stack([x / (1 - s), torch.zeros_like(x), z / (1 - s)], 1)
    if case == "repeated":
        lead = lane - lane % 32 + (warp % 3 == 2).to(lane.dtype)
        src = torch.where((warp % 3 != 0) & (lane > lead), lead, lane)
        point, batch = point[src], batch[src]
    up = torch.tensor([0.0, WALK_BIAS, 0.0], device=dev)
    return (point + up).contiguous(), point.contiguous(), batch


WALK_KERNELS = ["capped", "uncapped", "uncapped_masked", "glass", "k5",
                "k6_seeded", "k6_unseeded"]


def walk_launch(w, kernel, shadow_o, point, cl, cnt):
    """The launch of ``kernel`` on the walk scene's rays and lists, and its
    plain version: (run(counts) -> outputs, plain outputs, the lanes'
    rays and open lanes as pack_rays sees them, pack_above)."""
    tables, lights = w["tables"], w["lights"]
    R = point.shape[0]
    if kernel.startswith("k"):
        lv = lights[0] - point
        r2 = (lv * lv).sum(dim=1).contiguous()
        d = (lv / torch.sqrt(r2)[:, None]).contiguous()
        act = None
        if kernel == "k5":
            kw, pkw = dict(tile_mod=R // 1024), dict(tile_mod=R // 1024)
        else:
            act = (torch.ones(R, dtype=torch.bool, device=point.device)
                   if kernel == "k6_unseeded"
                   else torch.arange(R, device=point.device) % 3 != 0)
            kw, pkw = dict(exit=True, active=act), dict(seed=~act)

        def run(counts):
            return cluster_trace.occlusion_d(tables, shadow_o, d, r2, cl,
                                             counts, 1024, **kw)

        plain = cluster_trace.occlusion_d_plain(tables, shadow_o, d, r2, cl,
                                                cnt, 1024, **pkw)
        return (run, (plain,), torch.cat([shadow_o, d, r2[:, None]], dim=1),
                act, 32)
    kw = dict(capped={}, uncapped=dict(capped=False),
              uncapped_masked=dict(capped=False, member_mask=w["subset"]),
              glass=dict(member_mask=w["subset"], glass_flag=True))[kernel]

    def run(counts):
        return cluster_trace.occlusion_w(tables, shadow_o, point, lights, cl,
                                         counts, **kw)

    plain = cluster_trace.occlusion_w_plain(tables, shadow_o, point, lights,
                                            cl, cnt, **kw)
    plain = plain if isinstance(plain, tuple) else (plain,)
    return run, plain, torch.cat([shadow_o, lights[0] - point], dim=1), None, -1


@pytest.mark.parametrize("kernel", WALK_KERNELS)
@pytest.mark.parametrize("case", ["staggered", "one_lit_a_warp",
                                  "all_but_one", "repeated"])
def test_any_hit_walk_repacks_keep_every_answer(device, walk_scene, case,
                                                kernel):
    """K2 in each mode, K5, and K6 seeded and unseeded, on 80-cluster
    lists where each lane is blocked in a batch of its own (walk_rays):
    bit-equal to the plain version on every lane, blocked where the ray
    crosses the grid (the capped launches), and counting the lane tests
    and repacks that chip_smoke.walk_model reads from the lanes' done
    batches; on the same lists cut to 32 clusters, also bit-equal, with no
    repack.  The glass flag's lanes are blocked in batches 0-7 and find
    the patch in batches 8-9, or never: moved while blocked, unflagged."""
    import chip_smoke

    w = walk_scene
    shadow_o, point, batch = walk_rays(w, case)
    tiles = point.shape[0] // 1024
    cl = w["order"].repeat(tiles, 1).contiguous()
    for cut in (cl.shape[1], 32):
        cnt = torch.full((tiles,), cut, dtype=torch.int32, device=device)
        run, plain, ray, act, pack_above = walk_launch(w, kernel, shadow_o,
                                                       point, cl, cnt)
        with tracing.recording() as c:
            out = run(cnt)
        out = out if isinstance(out, tuple) else (out,)
        torch.cuda.synchronize()
        for got, want in zip(out, plain):
            assert torch.equal(got, want)
        tests, repacks = (c["crt.shadow.lane_tests"],
                          c["crt.shadow.repacks"])
        if cut == 32:
            assert repacks == 0 and tests > 0
            continue
        if kernel in ("capped", "k5", "k6_unseeded"):
            assert torch.equal(out[0], batch != NEVER)

        def done(counts):
            got = run(counts)
            return got[0] & got[1] if isinstance(got, tuple) else got

        first = chip_smoke.done_batches(done, cnt)
        own = chip_smoke.packed_lanes(ray, cnt, act)
        assert (tests, repacks) == chip_smoke.walk_model(first, cnt, own,
                                                         pack_above)
        if case in ("staggered", "repeated"):
            assert repacks > 0


def test_any_hit_walk_without_stats(device, walk_scene, monkeypatch):
    """An untraced launch (no stats buffer) gives the same bits as a
    counted one, and counts nothing."""
    w = walk_scene
    shadow_o, point, _ = walk_rays(w, "staggered")
    cl = w["order"].repeat(4, 1).contiguous()
    cnt = torch.full((4,), cl.shape[1], dtype=torch.int32, device=device)
    counted = [walk_launch(w, k, shadow_o, point, cl, cnt)[0](cnt)
               for k in ("glass", "k6_seeded")]
    monkeypatch.setattr(cluster_trace, "walk_stats", lambda dev: None)
    with tracing.recording() as c:
        bare = [walk_launch(w, k, shadow_o, point, cl, cnt)[0](cnt)
                for k in ("glass", "k6_seeded")]
    torch.cuda.synchronize()
    assert torch.equal(bare[0][0], counted[0][0])
    assert torch.equal(bare[0][1], counted[0][1])
    assert torch.equal(bare[1], counted[1])
    assert c["crt.shadow.lane_tests"] == 0 and c["crt.shadow.repacks"] == 0


@pytest.mark.parametrize("exit", [False, True])
def test_occlusion_d_member_test_boundaries(device, exit):
    """tests/test_torch_occlusion_d.py's boundary_case on the card: t * t
    == r2 exactly, hits at t = -0.0 and +0.0 with r2 = 0, |n.d| at
    PARALLEL_EPS and just below, on the lists given (K6 seeded with every
    third lane): bit-equal to the plain version and to the expected
    pattern."""
    from crt_tpu_torch import scene_from_dict
    from test_torch_occlusion_d import boundary_case

    bd = boundary_case()
    tables = cluster_tables.build_cluster_tables(
        scene_from_dict(bd["spec"], device=device))
    o, d, r2, act, cl, cnt = (bd[k].to(device) for k in (
        "o", "d", "r2", "act", "cl", "cnt"))
    args = (tables, o.contiguous(), d.contiguous(), r2, cl, cnt)
    if exit:
        k = cluster_trace.occlusion_d(*args, exit=True, active=act)
        p = cluster_trace.occlusion_d_plain(*args, seed=~act)
    else:
        k = cluster_trace.occlusion_d(*args)
        p = cluster_trace.occlusion_d_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(k, p)
    lane = torch.arange(4096, device=device)
    tile = lane // 1024
    want = ((tile == 1) | (tile == 2) | (lane % 2 == 0)) | (exit & ~act)
    assert torch.equal(k, want)


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("tile_rays", [256, 1024])
@pytest.mark.parametrize("seeded", ["all", "none"])
def test_occlusion_d_exit_seeding(device, seeded, tile_rays, big):
    """K6 on lists binned for every lane, short or (``big``) long enough
    for the repeated-ray packing, with every lane seeded (each returns
    True; live tiles whose lanes are all seeded walk nothing) and with
    none (the full answer, equal to the launch without a mask): bit-equal
    to the plain version."""
    scene = _sized_scene(big, device)
    tables = cluster_tables.build_cluster_tables(scene)
    shadow_o, ldir, r2, act, lights = _dir_shadow_wavefront(scene, tables,
                                                            tile_rays)
    o_f, d_f, r2_f, _, _ = _flat(shadow_o, ldir, r2, act, lights, tile_rays)
    cl, cnt = binning.bin_rays(tables, o_f, d_f, tile_rays)
    act = torch.full_like(r2_f, seeded == "none", dtype=torch.bool)
    args = (tables, o_f, d_f, r2_f, cl, cnt, tile_rays)
    k = cluster_trace.occlusion_d(*args, exit=True, active=act)
    p = cluster_trace.occlusion_d_plain(*args, seed=~act)
    unmasked = cluster_trace.occlusion_d(*args, exit=True)
    torch.cuda.synchronize()
    assert torch.equal(k, p) and (cnt > 0).any()
    if seeded == "all":
        assert k.all()
    else:
        assert torch.equal(k, unmasked) and k.any() and not k.all()


@pytest.mark.parametrize("case", ["rows", "tile_mod", "all_dead"])
def test_closest_hit_compact_matches_plain_and_k1(device, case):
    """K4 vs its plain version and vs K1 on the same lists, bit for bit:
    with emitted rows on a tile-sparse masked wavefront, with wrapped
    origin tiles, and with no live tile at all."""
    scene = make_test_scene(192, 128, num_quads=24, device=device)
    tables = cluster_tables.build_cluster_tables(scene)
    rows_table = cluster_tables.emit_rows_table(scene, tables)
    o, d = _wavefront(scene)
    R = o.shape[0]
    lane = torch.arange(R, device=device)
    act = (lane % 3 != 0) & ((lane // 1024) % 3 == 0)
    tile_mod = 0
    o_full = o
    if case == "tile_mod":
        tile_mod = R // 1024
        d = torch.cat([d, d.flip(0)]).contiguous()
        act = torch.cat([act, ~act])
        o_full = torch.cat([o, o]).contiguous()
        rows_table = None
    elif case == "all_dead":
        act = torch.zeros_like(act)
    cl, cnt = binning.bin_rays(tables, o_full, d, 1024, act)
    before = (launched("closest_hit_compact"),
              launched("closest_hit"))
    k = cluster_trace.closest_hit_compact(tables, o, d, cl, cnt, rows_table,
                                          tile_mod=tile_mod)
    assert (launched("closest_hit_compact"),
            launched("closest_hit")) == (before[0] + 1, before[1])
    p = cluster_trace.closest_hit_compact_plain(tables, o, d, cl, cnt,
                                                rows_table, tile_mod)
    k1 = cluster_trace.closest_hit(tables, o_full, d, cl, cnt, rows_table)
    torch.cuda.synchronize()
    for got, plain, one in zip(k, p, k1):
        if got is not None:
            assert torch.equal(got, plain) and torch.equal(got, one)
    if case == "all_dead":
        assert (k[1] == -1).all() and torch.isinf(k[0]).all()
    else:
        assert (k[1] >= 0).any() and (cnt == 0).any()


@pytest.fixture(scope="module")
def wide_wavefront(device):
    """A 1024x512 wavefront (512 tiles, 2,048 units: more than the
    persistent grid's blocks) of a 24-quad scene, its tables and rows."""
    scene = make_test_scene(1024, 512, num_quads=24, device=device)
    tables = cluster_tables.build_cluster_tables(scene)
    rows_table = cluster_tables.emit_rows_table(scene, tables)
    o, d = _wavefront(scene)
    return tables, rows_table, o, d


@pytest.mark.parametrize("rows", [False, True])
@pytest.mark.parametrize("tile_mod", [False, True])
@pytest.mark.parametrize("layout", ["first", "last", "interleaved", "none"])
def test_closest_hit_compact_live_tile_layouts(device, wide_wavefront,
                                               layout, tile_mod, rows):
    """K4 where the live tiles come first, last, interleaved with dead ones
    or not at all, with and without wrapped origin tiles and rows: bit-equal
    to its plain version and to K1 on every lane, misses on dead tiles;
    one K4 launch and one of its tile list."""
    tables, rows_table, o, d = wide_wavefront
    rows_table = rows_table if rows else None
    tiles = o.shape[0] // 1024
    tile = torch.arange(o.shape[0], device=device) // 1024
    keep = dict(first=tile < tiles // 5, last=tile >= tiles - tiles // 5,
                interleaved=(tile % 7 == 2) | (tile % 11 == 5),
                none=torch.zeros_like(tile, dtype=torch.bool))[layout]
    act = keep & (torch.arange(o.shape[0], device=device) % 5 != 0)
    o_full, mod = o, 0
    if tile_mod:  # a second set of directions over the same origins
        mod = tiles
        d = torch.cat([d, d.flip(0)]).contiguous()
        act = torch.cat([act.flip(0), act])
        o_full = torch.cat([o, o]).contiguous()
    cl, cnt = binning.bin_rays(tables, o_full, d, 1024, act)
    before = (launched("closest_hit_compact"),
              launched("live_tiles"))
    k = cluster_trace.closest_hit_compact(tables, o, d, cl, cnt, rows_table,
                                          tile_mod=mod)
    assert (launched("closest_hit_compact"),
            launched("live_tiles")) == (before[0] + 1,
                                                   before[1] + 1)
    p = cluster_trace.closest_hit_compact_plain(tables, o, d, cl, cnt,
                                                rows_table, mod)
    k1 = cluster_trace.closest_hit(tables, o_full, d, cl, cnt, rows_table)
    torch.cuda.synchronize()
    _hits_equal(k, p)
    _hits_equal(k, k1)
    dead = (cnt == 0).repeat_interleave(1024)
    assert (k[1][dead] == -1).all() and torch.isinf(k[0][dead]).all()
    if rows:
        assert not k[2][:, dead].any()
    if layout == "none":
        assert dead.all()
    else:
        assert (cnt > 0).any() and dead.any()


@pytest.mark.parametrize("pattern", ["none", "all", "random", "first",
                                     "last"])
@pytest.mark.parametrize("tiles", [1, 1000, 16320, 70001])
def test_live_tiles_matches_plain(device, tiles, pattern):
    """K4's live-list kernel: the live tiles ascending, then the dead ones
    ascending, then their number; equal to the plain version (the stable
    argsort) for any tile count, more tiles than the block's threads
    included."""
    gen = torch.Generator().manual_seed(tiles)
    counts = torch.randint(0, 3, (tiles,), generator=gen, dtype=torch.int32)
    pos = torch.arange(tiles)
    counts = dict(none=torch.zeros_like(counts),
                  all=counts + 1, random=counts,
                  first=torch.where(pos < tiles // 3 + 1, counts + 1, 0),
                  last=torch.where(pos >= tiles // 2, counts + 1, 0)
                  )[pattern].to(torch.int32).to(device)
    before = launched("live_tiles")
    ids, n_live = cluster_trace.live_tiles(counts)
    assert launched("live_tiles") == before + 1
    want_ids, want_n = cluster_trace.live_tiles_plain(counts)
    torch.cuda.synchronize()
    assert ids.dtype == torch.int32 and n_live.dtype == torch.int32
    assert torch.equal(n_live, want_n) and torch.equal(ids, want_ids)
    assert int(n_live) == int((counts > 0).sum())


@pytest.mark.parametrize("merge", [2, 4])
def test_closest_hit_merged_matches_plain_and_k1(device, merge):
    """K7 vs its plain version and vs K1 on the same lists, bit for bit
    (t, tri, rows), on a masked wavefront with empty lists among each
    block's sub-tiles; a merge that does not divide the tile count is
    refused by the wrapper and by the host entry itself."""
    from crt_tpu_torch.ops import cuda_lib

    scene = make_test_scene(192, 128, num_quads=24, device=device)
    tables = cluster_tables.build_cluster_tables(scene)
    rows_table = cluster_tables.emit_rows_table(scene, tables)
    o, d = _wavefront(scene)  # 24 tiles
    lane = torch.arange(o.shape[0], device=device)
    act = (lane % 3 != 0) & ((lane // 1024) % 3 != 1)
    cl, cnt = binning.bin_rays(tables, o, d, 1024, act)
    before = (launched("closest_hit_merged"),
              launched("closest_hit"))
    k = cluster_trace.closest_hit_merged(tables, o, d, cl, cnt, rows_table,
                                         merge=merge)
    assert (launched("closest_hit_merged"),
            launched("closest_hit")) == (before[0] + 1, before[1])
    p = cluster_trace.closest_hit_merged_plain(tables, o, d, cl, cnt,
                                               rows_table, merge)
    k1 = cluster_trace.closest_hit(tables, o, d, cl, cnt, rows_table)
    torch.cuda.synchronize()
    for got, plain, one in zip(k, p, k1):
        assert torch.equal(got, plain) and torch.equal(got, one)
    assert (k[1] >= 0).any() and (cnt == 0).any()
    with pytest.raises(ValueError):
        cluster_trace.closest_hit_merged(tables, o, d, cl, cnt, merge=5)
    lib, _ = cuda_lib.load()
    err = lib.crt_closest_hit_merged(
        o.data_ptr(), d.data_ptr(), tables.n.data_ptr(),
        tables.nv0.data_ptr(), tables.m.data_ptr(), tables.c.data_ptr(),
        tables.nobf.data_ptr(), tables.tri_id.data_ptr(), cl.data_ptr(),
        cnt.data_ptr(), None, tables.n.shape[0], cnt.shape[0], 1024, 5, 0,
        k[0].data_ptr(), k[1].data_ptr(), None,
        torch.cuda.current_stream(device).cuda_stream)
    assert err == 1  # cudaErrorInvalidValue, nothing launched


def test_tile_merge_render_on_card(device):
    """With the merge at 2 every closest hit of the frame takes K7 (6
    tiles) and the image equals the default one bit for bit."""
    scene = make_test_scene(96, 64, num_quads=16, with_edges=True,
                            device=device)
    default = render_image(scene)
    tracer = cluster_trace.make_cluster_trace_fn(scene, tile_merge=2)
    before = (launched("closest_hit_merged"),
              launched("closest_hit"))
    img = _render_flat(scene, RenderSettings(), trace_fn=tracer)
    assert (launched("closest_hit_merged"),
            launched("closest_hit")) == (before[0] + 4, before[1])
    assert torch.equal(img, default)


RING_CLUSTERS = 24  # csrc/cluster_common.cuh CRT_STAGES * CRT_BATCH


def _merged_case(device, long_lists, pattern, merge, kp):
    """(tables, o, d, cl, cnt, rows_table) of up to 24 tiles whose merge
    groups hold the list pattern that a K7 reusing staged batches
    (measure/closest_hit_persistent.cu) would turn on:
      equal      every sub-tile walks its group's first list;
      differ     odd sub-tiles walk that list reversed (same count and
                 ids, another order: no reuse);
      one_empty  equal lists, sub-tile 1 of each group empty (the list
                 stays staged across it);
      all_empty  equal lists, every other group all empty;
      long       equal lists of more clusters than the ring holds (each
                 sub-tile restages);
      origins    equal lists; sub-tile 1's rays start at points of their
                 own (no shared origin), sub-tile 2's all at one other
                 point, sub-tile 3's at the camera again (each restages);
      unshared   equal lists, every ray at a point of its own (the
                 records are staged without the origin's terms: reuse).
    The rows table keeps its last kp columns (None at kp = 0)."""
    if pattern == "long":
        L = long_lists
        tables, rows_table = L["tables"], L["rows_table"]
        tiles = torch.nonzero(L["cnt"] > RING_CLUSTERS)[:, 0][:24]
        tiles = tiles[:tiles.numel() // 4 * 4]
        lanes = (tiles[:, None] * 1024
                 + torch.arange(1024, device=device)).reshape(-1)
        o, d = L["o"][lanes].contiguous(), L["d"][lanes].contiguous()
        cl, cnt = L["cl"][tiles], L["cnt"][tiles]
    else:
        scene = make_test_scene(192, 128, num_quads=24, device=device)
        tables = cluster_tables.build_cluster_tables(scene)
        rows_table = cluster_tables.emit_rows_table(scene, tables)
        o, d = _wavefront(scene)  # 24 tiles
        cl, cnt = binning.bin_rays(tables, o, d, 1024)
    tiles = cnt.shape[0]
    first = torch.arange(tiles, device=device) // merge * merge
    sub = torch.arange(tiles, device=device) % merge
    cl, cnt = cl[first].clone(), cnt[first].clone()
    if pattern == "differ":
        for t in range(1, tiles, 2):
            n = int(cnt[t])
            cl[t, :n] = cl[t, :n].flip(0)
    elif pattern == "one_empty":
        cnt[sub == 1] = 0
    elif pattern == "all_empty":
        cnt[(first // merge) % 2 == 1] = 0
    elif pattern in ("origins", "unshared"):
        gen = torch.Generator(device="cpu").manual_seed(3)
        jitter = 1e-3 * torch.rand((tiles, 1024, 3), generator=gen)
        lanes = o.reshape(tiles, 1024, 3).clone()
        if pattern == "unshared":
            lanes += jitter.to(device)
        else:
            lanes[sub == 1] += jitter.to(device)[sub == 1]
            lanes[sub == 2] += torch.tensor([0.01, -0.02, 0.005],
                                            device=device)
        o = lanes.reshape(-1, 3).contiguous()
    rows_table = rows_table[..., -kp:].contiguous() if kp else None
    return tables, o, d, cl.contiguous(), cnt.contiguous(), rows_table


@pytest.mark.parametrize("kp", [0, 1, 7])
@pytest.mark.parametrize("pattern", ["equal", "differ", "one_empty",
                                     "all_empty", "long", "origins",
                                     "unshared"])
@pytest.mark.parametrize("merge", [2, 4])
def test_closest_hit_merged_list_patterns(device, long_lists, merge, pattern,
                                          kp):
    """K7 on groups whose sub-tiles repeat, reorder, skip or outgrow a
    staged list, or change their rays' origin under it: bit-equal (t, tri,
    rows) to its plain version and to K1 on the same lists, every lane."""
    tables, o, d, cl, cnt, rows_table = _merged_case(device, long_lists,
                                                     pattern, merge, kp)
    assert cnt.shape[0] >= 2 * merge and cnt.shape[0] % merge == 0
    if pattern == "long":
        assert int(cnt.min()) > RING_CLUSTERS
    else:
        assert int(cnt.max()) <= RING_CLUSTERS
    k = cluster_trace.closest_hit_merged(tables, o, d, cl, cnt, rows_table,
                                         merge=merge)
    p = cluster_trace.closest_hit_merged_plain(tables, o, d, cl, cnt,
                                               rows_table, merge)
    k1 = cluster_trace.closest_hit(tables, o, d, cl, cnt, rows_table)
    torch.cuda.synchronize()
    _hits_equal(k, p)
    _hits_equal(k, k1)
    assert (k[1] >= 0).any()
    if pattern in ("one_empty", "all_empty"):
        dead = (cnt == 0).repeat_interleave(1024)
        assert dead.any() and (k[1][dead] == -1).all()
        assert torch.isinf(k[0][dead]).all()
        if kp:
            assert not k[2][:, dead].any()


@pytest.mark.parametrize("merge", [2, 4])
def test_closest_hit_merged_more_groups_than_the_grid(device, merge):
    """K7 over 2,048 tiles (more merge groups than the card holds resident
    blocks), tiles dead and live in a pattern: bit-equal to its plain
    version and to K1 on every lane, misses on dead tiles."""
    scene = make_test_scene(2048, 1024, num_quads=24, device=device)
    tables = cluster_tables.build_cluster_tables(scene)
    rows_table = cluster_tables.emit_rows_table(scene, tables)
    o, d = _wavefront(scene)
    tile = torch.arange(o.shape[0], device=device) // 1024
    keep = (tile % 5 == 1) | (tile % 7 == 3) | (tile % 11 < 4)
    cl, cnt = binning.bin_rays(tables, o, d, 1024, keep)
    k = cluster_trace.closest_hit_merged(tables, o, d, cl, cnt, rows_table,
                                         merge=merge)
    p = cluster_trace.closest_hit_merged_plain(tables, o, d, cl, cnt,
                                               rows_table, merge)
    k1 = cluster_trace.closest_hit(tables, o, d, cl, cnt, rows_table)
    torch.cuda.synchronize()
    _hits_equal(k, p)
    _hits_equal(k, k1)
    groups = (cnt > 0).reshape(-1, merge)
    assert (~groups.any(1)).any() and groups.all(1).any()
    dead = (cnt == 0).repeat_interleave(1024)
    assert (k[1][dead] == -1).all() and not k[2][:, dead].any()


def test_rng_on_card_matches_cpu(device):
    """PCG32 on the card: seeding, masked draws, derive and salted streams
    equal the CPU's bits."""
    from crt_tpu_torch.ops import rng

    gen = torch.Generator(device="cpu").manual_seed(5)
    x = torch.randint(0, 2**32, (4096,), generator=gen, dtype=torch.int64)
    y = torch.randint(0, 2**32, (4096,), generator=gen, dtype=torch.int64)
    act = torch.rand((4096,), generator=gen) < 0.6
    out = {}
    for dev in ("cpu", device):
        st = rng.make_pcg(x.to(dev), y.to(dev))
        vals = []
        for i in range(12):
            v, st = rng.uniform(st, act.to(dev) if i % 2 else None)
            vals.append(v)
            if i == 5:
                st = rng.derive(st, i + 1)
            if i == 8:
                st = rng.salt_stream(st, torch.tensor(3, device=dev))
        out[str(dev)] = (torch.stack(vals).cpu(), *(p.cpu() for p in st))
    for a, b in zip(out["cpu"], out[str(device)]):
        assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a, b.view(torch.int32)
                           if b.is_floating_point() else b)


@pytest.mark.parametrize("backend", ["cluster", "pallas_stream"])
@pytest.mark.parametrize("wavefront", ["auto", "recursive"])
def test_gi_render_on_card_matches_all_pairs(device, backend, wavefront):
    """A GI frame (K = 2, depth 2) through the cluster and the streaming
    backends on the card vs the all-pairs backend on the card: the same
    streams, so the same samples; >= 99 % of pixels within rtol 1e-4 /
    atol 1e-5 (an edge hit that one backend's member test takes and the
    other's does not moves its pixel)."""
    scene = make_test_scene(96, 64, num_quads=8, gi_on=True, device=device)
    st = RenderSettings(backend=backend, wavefront=wavefront, max_ray_depth=2,
                        diffuse_reflection_ray_count=2)
    before = (launched("closest_hit"),
              launched("closest_hit_stream"))
    img = render_image(scene, st)
    after = (launched("closest_hit"),
             launched("closest_hit_stream"))
    ref = render_image(scene, st.replace(backend="bruteforce"))
    torch.cuda.synchronize()
    assert after[0 if backend == "cluster" else 1] > before[
        0 if backend == "cluster" else 1]
    close = ((img - ref).abs() <= 1e-5 + 1e-4 * ref.abs()).all(-1)
    assert float(close.float().mean()) >= 0.99
    assert torch.isfinite(img).all() and float(img.mean()) > 0


@pytest.mark.parametrize("settings", [
    dict(), dict(wavefront_sched="grow"), dict(wavefront="recursive"),
    dict(compact_bounces=True)])
def test_refractive_render_on_card_matches_cpu(device, settings):
    """A small glass scene, card vs CPU, through each wavefront; the same
    tolerance as the opaque render above."""
    scene = make_test_scene(96, 64, num_quads=8, with_refractive=True,
                            device="cpu")
    st = RenderSettings(**settings)
    cpu = render_image(scene, st)
    before = (modes("occlusion_w", ("capped", "uncapped", "glass")),
              launched("closest_hit_compact"))
    gpu = render_image(scene.to(device), st).cpu()
    after = modes("occlusion_w", ("capped", "uncapped", "glass"))
    assert after["glass"] > before[0]["glass"]
    assert after["capped"] == before[0]["capped"]
    assert ((launched("closest_hit_compact") > before[1])
            == bool(settings.get("compact_bounces")))
    torch.testing.assert_close(gpu, cpu, rtol=1e-5, atol=1e-6)


# scene keywords, settings, gi_salt (tests/test_torch_shade_iter.py's cases)
LIVE_LANE_CASES = {
    "gi_grow": (dict(gi_on=True), dict(max_ray_depth=3,
                                       diffuse_reflection_ray_count=2), None),
    "gi_grow_salted": (dict(gi_on=True),
                       dict(max_ray_depth=3, diffuse_reflection_ray_count=2),
                       5),
    "gi_scan": (dict(gi_on=True),
                dict(max_ray_depth=2, diffuse_reflection_ray_count=2,
                     wavefront_sched="scan"), None),
    "glass_scan_depth3": (dict(with_refractive=True), dict(max_ray_depth=3),
                          None),
    "gi_chunked": (dict(gi_on=True),
                   dict(max_ray_depth=2, diffuse_reflection_ray_count=2,
                        chunk_pixels=8192), None),
}


@pytest.mark.parametrize("case", sorted(LIVE_LANE_CASES))
def test_live_lane_bounces_bit_equal_on_card(device, monkeypatch, case):
    """Through the kernels: every bounce past the camera rays' shaded on
    its live lanes gives the full-width image bit for bit, with K1 and K2
    on both paths."""
    from crt_tpu_torch.ops import shade_iter

    scene_kw, kw, salt = LIVE_LANE_CASES[case]
    scene = make_test_scene(192, 128, num_quads=16, device=device,
                            **scene_kw)
    st = RenderSettings(**kw)
    out = {}
    for share in (1.0, -1.0):
        monkeypatch.setattr(shade_iter, "_COMPACT_MAX_LIVE", share)
        before = (launched("closest_hit"), launched("occlusion_w"),
                  tracing.counters()["crt.shade.compacted_bounces"])
        out[share] = render_image(scene, st, gi_salt=salt)
        after = (launched("closest_hit"), launched("occlusion_w"),
                 tracing.counters()["crt.shade.compacted_bounces"])
        assert after[0] > before[0] and after[1] > before[1]
        assert (after[2] > before[2]) == (share > 0)
    assert float(out[1.0].abs().max()) > 0
    assert torch.equal(out[1.0], out[-1.0])


def test_render_on_card_matches_cpu(device):
    """The card render (kernels) vs the CPU render (plain versions): the
    trace is bit-equal, the shading ops may round differently on the two
    devices (rtol 1e-5 / atol 1e-6, test_pallas_trace.py's tolerance)."""
    scene = make_test_scene(96, 64, num_quads=16, with_edges=True,
                            device="cpu")
    cpu = render_image(scene)
    before = (launched("closest_hit"),
              launched("occlusion_w"))
    gpu = render_image(scene.to(device), RenderSettings()).cpu()
    after = (launched("closest_hit"),
             launched("occlusion_w"))
    assert after == (before[0] + 4, before[1] + 4)
    torch.testing.assert_close(gpu, cpu, rtol=1e-5, atol=1e-6)


def _dir_shadow_wavefront(scene, tables, tile_rays):
    """The direction-form shadow wavefront behind the primary hits, padded
    to ``tile_rays``: (shadow_o [R, 3], ldir [Ll, R, 3], r2 [Ll, R], act
    [Ll, R], lights), light 1 active on x > 0 only and every third tile of
    pixels switched off for both."""
    o, d = _wavefront(scene)
    t, tri, _ = cluster_trace.closest_hit(
        tables, o, d, *binning.bin_rays(tables, o, d, 1024))
    valid = tri >= 0
    point = o + d * torch.where(valid, t, 0.0)[:, None]
    shadow_o = (point + 0.01 * torch.tensor([0.0, 1.0, 0.0],
                                            device=o.device)).contiguous()
    lights = scene.light_position
    if lights.shape[0] == 1:
        lights = torch.cat([lights, lights + 7.0])
    lv = lights[:, None, :] - point[None]
    r2 = vecmath.length_squared(lv)
    ldir = vecmath.safe_normalize(lv)
    on = (torch.arange(o.shape[0], device=o.device) // tile_rays) % 3 != 2
    act = torch.stack([valid, valid & (point[:, 0] > 0)]) & on[None]
    return shadow_o, ldir, r2, act, lights.contiguous()


def _flat(shadow_o, ldir, r2, act, lights, tile_rays):
    Ll, R = r2.shape
    return (shadow_o.expand(Ll, R, 3).reshape(-1, 3).contiguous(),
            ldir.reshape(-1, 3).contiguous(), r2.reshape(-1).contiguous(),
            act.reshape(-1), lights.repeat_interleave(R // tile_rays, dim=0))


def _sized_scene(big, device):
    return (make_big_scene(65536, 256, 192, device=device) if big
            else make_test_scene(192, 128, num_quads=24, device=device))


@pytest.mark.parametrize("tile_rays", [256, 1024])
@pytest.mark.parametrize("big", [False, True])
def test_occlusion_d_kernels_match_plain(device, big, tile_rays):
    """K5 (shaft lists, origin tiles stored once) and K6 (generic lists,
    seeded, with and without an active mask) vs their plain version, lane
    for lane, and K5 == K6 on the active lanes."""
    scene = _sized_scene(big, device)
    tables = cluster_tables.build_cluster_tables(scene)
    shadow_o, ldir, r2, act, lights = _dir_shadow_wavefront(scene, tables,
                                                            tile_rays)
    o_f, d_f, r2_f, a_f, apex = _flat(shadow_o, ldir, r2, act, lights,
                                      tile_rays)
    tpl = shadow_o.shape[0] // tile_rays
    cl, cnt = binning.bin_rays(tables, o_f, d_f, tile_rays, a_f, apex=apex,
                               apex_slack=0.02)
    before = modes("occlusion_d", ("compact", "exit"))
    k5 = cluster_trace.occlusion_d(tables, shadow_o, d_f, r2_f, cl, cnt,
                                   tile_rays, tile_mod=tpl)
    p5 = cluster_trace.occlusion_d_plain(tables, shadow_o, d_f, r2_f, cl, cnt,
                                         tile_rays, tile_mod=tpl)
    gl, gcnt = binning.bin_rays(tables, o_f, d_f, tile_rays, a_f)
    k6 = cluster_trace.occlusion_d(tables, o_f, d_f, r2_f, gl, gcnt,
                                   tile_rays, exit=True, active=a_f)
    p6 = cluster_trace.occlusion_d_plain(tables, o_f, d_f, r2_f, gl, gcnt,
                                         tile_rays, seed=~a_f)
    fl, fcnt = binning.bin_rays(tables, o_f, d_f, tile_rays)
    k6_all = cluster_trace.occlusion_d(tables, o_f, d_f, r2_f, fl, fcnt,
                                       tile_rays, exit=True)
    p6_all = cluster_trace.occlusion_d_plain(tables, o_f, d_f, r2_f, fl, fcnt,
                                             tile_rays)
    torch.cuda.synchronize()
    after = modes("occlusion_d", ("compact", "exit"))
    assert after["compact"] == before["compact"] + 1
    assert after["exit"] == before["exit"] + 2
    assert torch.equal(k5, p5) and torch.equal(k6, p6)
    assert torch.equal(k6_all, p6_all)
    assert torch.equal(k5[a_f], k6[a_f]) and k6[~a_f].all()
    assert (cnt == 0).any() and k5[a_f].any() and not k5[a_f].all()
    assert not k5[(cnt == 0).repeat_interleave(tile_rays)].any()


@pytest.mark.parametrize("sc", [4, 32])
@pytest.mark.parametrize("tile_rays", [256, 1024])
@pytest.mark.parametrize("big", [False, True])
def test_stream_kernels_match_plain(device, big, tile_rays, sc):
    """K8 on the primary wavefront (with an active mask that leaves tiles
    without a pair) and K9 on the shadow wavefront (complete and truncated
    walks) vs their plain versions; streaming hits == K1's.  Each launch
    again with walks cut into items of 8 members (``chunk=8``): the same
    bits."""
    scene = _sized_scene(big, device)
    tables = cluster_tables.build_cluster_tables(scene)
    st = stream_trace.build_stream_tables(tables, sc)
    o, d = _wavefront(scene)
    lane = torch.arange(o.shape[0], device=device)
    act = (lane % 3 != 0) & ((lane // tile_rays) % 4 != 1)
    for a in (None, act):
        bounds = binning.tile_bounds(o, d, tile_rays, a)
        pair_sc, bits, start = stream_trace.bin_stream_pairs(st, bounds)
        before = launched("closest_hit_stream")
        k = stream_trace.closest_hit_stream(
            st.fused, st.tables.tri_id, o, d, pair_sc, bits, start, sc,
            tile_rays)
        assert launched("closest_hit_stream") == before + 1
        p = stream_trace.closest_hit_stream_plain(
            st.fused, st.tables.tri_id, o, d, pair_sc, bits, start, sc,
            tile_rays)
        torch.cuda.synchronize()
        assert torch.equal(k[1], p[1]) and torch.equal(k[0], p[0])
        assert (k[1] >= 0).any()
        _same_as_small_chunks(k, stream_trace.closest_hit_stream(
            st.fused, st.tables.tri_id, o, d, pair_sc, bits, start, sc,
            tile_rays, chunk=8), bits, start, big)
        if a is not None:
            assert (start[1:] == start[:-1]).any()  # tiles without a pair
        elif tile_rays == 1024:
            k1 = cluster_trace.closest_hit(
                tables, o, d, *binning.bin_rays(tables, o, d, 1024))
            assert torch.equal(k[1], k1[1]) and torch.equal(k[0], k1[0])

    shadow_o, ldir, r2, sact, lights = _dir_shadow_wavefront(scene, tables,
                                                             tile_rays)
    o_f, d_f, r2_f, a_f, apex = _flat(shadow_o, ldir, r2, sact, lights,
                                      tile_rays)
    bounds = binning.tile_bounds(o_f, d_f, tile_rays, a_f)
    for kw in (dict(near_first=True), dict(near_first=True, per_tile_cap=2)):
        pair_sc, bits, start = stream_trace.bin_stream_pairs(
            st, bounds, apex, 0.02, **kw)
        before = launched("occlusion_stream")
        k9 = stream_trace.occlusion_stream(st.fused, o_f, d_f, r2_f, ~a_f,
                                           pair_sc, bits, start, sc,
                                           tile_rays)
        assert launched("occlusion_stream") == before + 1
        p9 = stream_trace.occlusion_stream_plain(st.fused, o_f, d_f, r2_f,
                                                 ~a_f, pair_sc, bits, start,
                                                 sc, tile_rays)
        torch.cuda.synchronize()
        assert torch.equal(k9, p9) and k9[~a_f].all()
        assert k9[a_f].any() and not k9[a_f].all()
        _same_as_small_chunks(k9, stream_trace.occlusion_stream(
            st.fused, o_f, d_f, r2_f, ~a_f, pair_sc, bits, start, sc,
            tile_rays, chunk=8), bits, start, False)
    # the complete walk answers what K5 answers on the active lanes
    tpl = shadow_o.shape[0] // tile_rays
    cl, cnt = binning.bin_rays(tables, o_f, d_f, tile_rays, a_f, apex=apex,
                               apex_slack=0.02)
    full = stream_trace.occluded_stream_flat(st, o_f, d_f, r2_f, a_f, apex,
                                             0.02, tile_rays)
    k5 = cluster_trace.occlusion_d(tables, shadow_o, d_f, r2_f, cl, cnt,
                                   tile_rays, tile_mod=tpl)
    two = stream_trace.occluded_stream_twophase(
        st, shadow_o, ldir, r2, lights, sact, 0.02, tile_rays, phase1_k=2)
    assert torch.equal(full[a_f], k5[a_f])
    assert torch.equal(two.reshape(-1)[a_f], full[a_f])


def _same_as_small_chunks(default, small, bits, start, long_walks):
    """A launch with ``chunk=8`` gives the default launch's bits; where
    ``long_walks``, some tile's walk really takes more than one item."""
    for a, b in zip(default if isinstance(default, tuple) else (default,),
                    small if isinstance(small, tuple) else (small,)):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    if long_walks:
        assert int(stream_trace.stream_items(bits, start, 8).item_end[0]) > 1


def _layout_counts():
    return (modes("closest_hit_stream", stream_trace.LAYOUTS),
            modes("occlusion_stream", stream_trace.LAYOUTS))


def _added(before, after):
    return [{k: a[k] - b[k] for k in a if a[k] != b[k]}
            for b, a in zip(before, after)]


@pytest.mark.parametrize("layout", ["lane", "rows"])
@pytest.mark.parametrize("sc", [4, 32])
@pytest.mark.parametrize("big", [False, True])
def test_stream_layout_kernels_match_plain_and_fused(device, big, sc,
                                                     layout):
    """K10 (lane) and K11 (rows) vs their plain versions and vs K8 / K9 on
    the fused table, on the same pair lists: the primary wavefront with an
    active mask that leaves tiles without a pair, and the shadow wavefront
    walked complete and truncated; each launch also with ``chunk=8``."""
    scene = _sized_scene(big, device)
    tables = cluster_tables.build_cluster_tables(scene)
    st = stream_trace.build_stream_tables(tables, sc, layout=layout)
    table = stream_trace.layout_table(st, layout)
    o, d = _wavefront(scene)
    lane = torch.arange(o.shape[0], device=device)
    act = (lane % 3 != 0) & ((lane // 1024) % 4 != 1)
    pairs = stream_trace.bin_stream_pairs(
        st, binning.tile_bounds(o, d, 1024, act))
    before = _layout_counts()
    k = stream_trace.closest_hit_stream(table, st.tables.tri_id, o, d,
                                        *pairs, sc, 1024, layout=layout)
    assert _added(before, _layout_counts()) == [{layout: 1}, {}]
    p = stream_trace.closest_hit_stream_plain(table, st.tables.tri_id, o, d,
                                              *pairs, sc, 1024, layout)
    f = stream_trace.closest_hit_stream(st.fused, st.tables.tri_id, o, d,
                                        *pairs, sc, 1024)
    torch.cuda.synchronize()
    assert torch.equal(k[1], p[1]) and torch.equal(k[0], p[0])
    assert torch.equal(k[1], f[1]) and torch.equal(k[0], f[0])
    assert (k[1] >= 0).any() and (pairs[2][1:] == pairs[2][:-1]).any()
    _same_as_small_chunks(k, stream_trace.closest_hit_stream(
        table, st.tables.tri_id, o, d, *pairs, sc, 1024, layout=layout,
        chunk=8), *pairs[1:], big)

    shadow_o, ldir, r2, sact, lights = _dir_shadow_wavefront(scene, tables,
                                                             1024)
    o_f, d_f, r2_f, a_f, apex = _flat(shadow_o, ldir, r2, sact, lights, 1024)
    bounds = binning.tile_bounds(o_f, d_f, 1024, a_f)
    for kw in (dict(near_first=True), dict(near_first=True, per_tile_cap=2)):
        pairs = stream_trace.bin_stream_pairs(st, bounds, apex, 0.02, **kw)
        args = (o_f, d_f, r2_f, ~a_f, *pairs, sc, 1024)
        before = _layout_counts()
        k9 = stream_trace.occlusion_stream(table, *args, layout=layout)
        assert _added(before, _layout_counts()) == [{}, {layout: 1}]
        p9 = stream_trace.occlusion_stream_plain(table, *args, layout)
        f9 = stream_trace.occlusion_stream(st.fused, *args)
        torch.cuda.synchronize()
        assert torch.equal(k9, p9) and torch.equal(k9, f9)
        assert k9[a_f].any() and not k9[a_f].all()
        _same_as_small_chunks(k9, stream_trace.occlusion_stream(
            table, *args, layout=layout, chunk=8), *pairs[1:], False)


@pytest.mark.parametrize("layout", ["lane", "rows"])
def test_stream_render_layout_on_card(device, layout):
    """The streaming tracer's ``layout`` alone moves a streaming frame's
    launches (one closest hit and two any-hit passes per shading level) to
    the layout's kernels; the image equals the fused frame bit for bit."""
    scene = make_test_scene(96, 64, num_quads=16, with_edges=True,
                            device=device)
    settings = RenderSettings(backend="stream")
    fused = render_image(scene, settings)
    tracer = stream_trace.make_stream_trace_fn(scene, layout=layout)
    before = _layout_counts()
    img = _render_flat(scene, settings, trace_fn=tracer)
    assert _added(before, _layout_counts()) == [{layout: 4}, {layout: 8}]
    assert torch.equal(img, fused)


@pytest.mark.parametrize("case", ["blocked_at_first_pair", "inactive_only",
                                  "no_pair"])
def test_occlusion_stream_tile_exits(device, case):
    """One tile under a slab that blocks every lane from its first member
    on: the block leaves the walk there; a tile seeded all True leaves
    before its first member; a tile with no pair returns its seed."""
    from crt_tpu_torch import scene_from_dict

    def tri(y, mat=0):
        return {"material_index": mat, "triangles": [0, 1, 2],
                "vertices": [-30, y, -30, 30, y, -30, 0, y, 60]}

    scene = scene_from_dict({
        "settings": {"background_color": [0, 0, 0],
                     "image_settings": {"width": 32, "height": 32}},
        "camera": {"matrix": [1, 0, 0, 0, 1, 0, 0, 0, 1],
                   "position": [0, 0, 5]},
        "lights": [{"intensity": 10, "position": [0, 50, 0]}],
        "materials": [{"type": "diffuse", "albedo": [1, 1, 1],
                       "smooth_shading": False}],
        "objects": [tri(1.0 + 0.01 * i) for i in range(40)]}, device=device)
    st = stream_trace.build_stream_tables(
        cluster_tables.build_cluster_tables(scene), 1)
    g = torch.linspace(-0.4, 0.4, 32, device=device)
    x, z = torch.meshgrid(g, g, indexing="ij")
    o = torch.stack([x.reshape(-1), torch.zeros(1024, device=device),
                     z.reshape(-1)], dim=-1).contiguous()
    d = torch.tensor([0.0, 1.0, 0.0], device=device).expand(1024, 3
                                                            ).contiguous()
    r2 = torch.full((1024,), 2500.0, device=device)
    active = torch.ones(1024, dtype=torch.bool, device=device)
    apex = scene.light_position[:1]
    bounds = binning.tile_bounds(o, d, 1024, active)
    pair_sc, bits, start = stream_trace.bin_stream_pairs(st, bounds, apex, 0.02,
                                                     near_first=True)
    assert pair_sc.shape[0] == 3  # three clusters, one pair each
    seed = torch.zeros_like(active)
    want = torch.ones_like(active)
    if case == "inactive_only":
        seed = torch.ones_like(active)
    elif case == "no_pair":
        pair_sc, bits = pair_sc[:0].contiguous(), bits[:0].contiguous()
        start = torch.zeros_like(start)
        seed = torch.arange(1024, device=device) % 2 == 0
        want = seed
    k = stream_trace.occlusion_stream(st.fused, o, d, r2, seed, pair_sc, bits,
                                      start, 1, 1024)
    p = stream_trace.occlusion_stream_plain(st.fused, o, d, r2, seed, pair_sc,
                                            bits, start, 1, 1024)
    torch.cuda.synchronize()
    assert torch.equal(k, p) and torch.equal(k, want)


def test_stream_render_on_card_matches_cpu(device):
    """A small scene through the streaming backend, card vs CPU, and vs the
    cluster backend on the card; per shading level one K8 launch and the
    two K9 launches of the two-phase shadow resolve, each after one launch
    of Phase A's kernel."""
    scene = make_test_scene(96, 64, num_quads=16, with_edges=True,
                            device="cpu")
    st = RenderSettings(backend="pallas_stream")
    cpu = render_image(scene, st)
    before = (launched("closest_hit_stream"),
              launched("occlusion_stream"),
              launched("closest_hit"))
    syncs = tracing.counters()["crt.host_reads.stream_pairs"]
    bins = launched("stream_bin")
    gpu = render_image(scene.to(device), st)
    after = (launched("closest_hit_stream"),
             launched("occlusion_stream"),
             launched("closest_hit"))
    assert after == (before[0] + 4, before[1] + 8, before[2])
    # Phase A: one launch and one read of the list's length a trace
    assert launched("stream_bin") == bins + 12
    assert tracing.counters()["crt.host_reads.stream_pairs"] \
        == syncs + 12
    torch.testing.assert_close(gpu.cpu(), cpu, rtol=1e-5, atol=1e-6)
    for kw in (dict(backend="cluster"), dict(backend="stream",
                                             stream_shadow_k=0)):
        other = render_image(scene.to(device), RenderSettings(**kw))
        torch.testing.assert_close(other, gpu, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("frame", ["opaque", "stream"])
def test_forward_render_is_deterministic(device, monkeypatch, frame):
    """Two forward renders give the same bits: the port's determinism, as
    crt_tpu's utils/checks.py checks it, is forward only (the segment
    sum's gradients may differ in the last bits from run to run).  The
    streaming frame runs with items of 8 members, so tiles' walks span
    several items that combine through atomics in any order."""
    if frame == "opaque":
        scene = make_test_scene(192, 128, num_quads=24, device=device)
        settings = RenderSettings()
    else:
        scene = make_big_scene(65536, 256, 192, device=device)
        settings = RenderSettings(backend="stream")
        monkeypatch.setattr(stream_trace, "CHUNK_MEMBERS", 8)
        st = stream_trace.build_stream_tables(
            cluster_tables.build_cluster_tables(scene))
        o, d = _wavefront(scene)
        _, bits, start = stream_trace.bin_stream_pairs(
            st, binning.tile_bounds(o, d, 1024, None))
        assert int(stream_trace.stream_items(bits, start, 8).item_end[0]) > 1
    first = render_image(scene, settings)
    second = render_image(scene, settings)
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


def test_direction_form_render_on_card(device):
    """With ``shadow_kernel="d"`` the cluster backend's shadows take K5:
    the image equals the streaming backend's bit for bit (both direction
    form)."""
    scene = make_test_scene(96, 64, num_quads=16, with_edges=True,
                            device=device)
    tracer = cluster_trace.make_cluster_trace_fn(scene, shadow_kernel="d")
    before = (modes("occlusion_d", ("compact", "exit")),
              launched("occlusion_w"))
    img = _render_flat(scene, RenderSettings(backend="cluster"),
                       trace_fn=tracer)
    assert modes("occlusion_d", ("compact", "exit"))["compact"] \
        == before[0]["compact"] + 4
    assert launched("occlusion_w") == before[1]
    assert torch.equal(
        img, render_image(scene, RenderSettings(backend="stream")))


def test_wrapper_rejects_mixed_devices(device):
    scene = make_test_scene(64, 32, num_quads=4, device="cpu")
    tables = cluster_tables.build_cluster_tables(scene)  # CPU tables
    o = torch.zeros((1024, 3), device=device)
    cl = torch.zeros((1, tables.n.shape[0]), dtype=torch.int32, device=device)
    cnt = torch.zeros((1,), dtype=torch.int32, device=device)
    with pytest.raises(ValueError):
        cluster_trace.closest_hit(tables, o, o, cl, cnt)


def _segsum_case(name, R, T, device):
    """Seeded ids [R] i32 on the card for one id pattern."""
    gen = torch.Generator().manual_seed(R + T)
    if name == "random":
        ids = torch.randint(-1, T, (R,), generator=gen)
    elif name == "banded":  # each 1024-ray tile draws from a 60-id window
        tiles = -(-R // 1024)
        lo = torch.randint(0, max(T - 60, 1), (tiles,), generator=gen)
        ids = (lo.repeat_interleave(1024)[:R]
               + torch.randint(0, 60, (R,), generator=gen)).clamp(max=T - 1)
        ids[::97] = -1
    elif name == "one_segment":  # every ray on one id: worst contention
        ids = torch.full((R,), T // 2)
    elif name == "runs":  # runs of 1 to 300 rays across warps and blocks
        lens = torch.randint(1, 300, (R // 100,), generator=gen)
        seg = torch.randint(-1, T, (R // 100,), generator=gen)
        ids = seg.repeat_interleave(lens)[:R]
        ids = torch.cat([ids, torch.full((R - ids.numel(),), -1)])
    elif name == "beyond_T":  # runs of valid ids among ids >= T and -1
        ids = torch.randint(-1, 2 * T, (R // 16,), generator=gen)
        ids = ids.repeat_interleave(16)[:R]
        ids = torch.cat([ids, torch.full((R - ids.numel(),), T)])
    else:  # all misses
        ids = torch.full((R,), -1)
    return ids.to(torch.int32).to(device)


@pytest.mark.parametrize("K", [13, 22, 31])
@pytest.mark.parametrize("name", ["random", "banded", "one_segment",
                                  "all_miss"])
def test_segsum_kernel_matches_plain_and_fp64(device, name, K):
    R, T = 100_000 + 37, 700  # R is not a multiple of 1,024 (or of 32)
    ids = _segsum_case(name, R, T, device)
    gen = torch.Generator().manual_seed(K)
    g = torch.randn((K, R), generator=gen).to(device)
    before = launched("segsum")
    out = segsum.segment_accumulate(ids, g, T)
    assert launched("segsum") == before + 1
    torch.cuda.synchronize()
    assert out.shape == (K, T) and out.dtype == torch.float32
    plain = segsum.segment_accumulate_plain(ids, g, T)
    exact = segsum.segment_accumulate_plain(ids, g.double(), T)
    mass = segsum.segment_accumulate_plain(ids, g.double().abs(), T)
    assert bool(((out.double() - exact).abs() <= 4e-6 * mass).all())
    assert bool(((out - plain).abs().double() <= 5e-4 * mass).all())
    if name == "all_miss":
        assert not out.any()
    else:
        assert out.any()
    # a wide band (ids over 65,536 segments) takes the direct-atomics path
    wide = _segsum_case("random", 20_000, 65_536, device)
    out = segsum.segment_accumulate(wide, g[:, :20_000].contiguous(), 65_536)
    exact = segsum.segment_accumulate_plain(
        wide, g[:, :20_000].double(), 65_536)
    torch.testing.assert_close(out.double(), exact, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", ["runs", "one_segment", "all_miss",
                                  "beyond_T", "wide"])
@pytest.mark.parametrize("r_mod", [1, 2, 3])
@pytest.mark.parametrize("K", [1, 3, 22, 31])
def test_segsum_kernel_shapes(device, K, r_mod, case):
    """K3 at the row counts the port launches it with (1: the ior row, 3:
    texture colours, 22: packed rows) and one more, with R not a multiple
    of 4 (rows past the first are not 16-byte aligned), within 4e-6 of
    each segment's sum|g| of an fp64 sum and 5e-4 of the plain version;
    "wide" spreads random ids over 65,536 segments (the direct-global
    path)."""
    R = 300_000 + r_mod
    T = 65_536 if case == "wide" else 700
    ids = _segsum_case("random" if case == "wide" else case, R, T, device)
    g = torch.randn((K, R), generator=torch.Generator().manual_seed(K)
                    ).to(device)
    before = launched("segsum")
    out = segsum.segment_accumulate(ids, g, T)
    assert launched("segsum") == before + 1
    torch.cuda.synchronize()
    assert out.shape == (K, T) and out.dtype == torch.float32
    plain = segsum.segment_accumulate_plain(ids, g, T)
    exact = segsum.segment_accumulate_plain(ids, g.double(), T)
    mass = segsum.segment_accumulate_plain(ids, g.double().abs(), T)
    assert bool(((out.double() - exact).abs() <= 4e-6 * mass).all())
    assert bool(((out - plain).abs().double() <= 5e-4 * mass).all())
    assert out.any() == (case != "all_miss")


@pytest.mark.parametrize("case", ["random", "all_miss", "beyond_T"])
@pytest.mark.parametrize("R", [1, 66, 256, 257, 5_000, 140_000])
@pytest.mark.parametrize("K,T", [(1, 4), (22, 66), (3, 700)])
def test_segsum_kernel_few_rays(device, K, T, R, case):
    """K3 where the rays fill few blocks: a warp walks fewer steps, and a
    launch of one block whose accumulators hold every id (K 1, T 4: the
    glass backward's ior row; K 22, T 66) writes the whole output itself,
    zeros included, over memory that held NaN; within 4e-6 of each
    segment's sum|g| of an fp64 sum and 5e-4 of the plain version."""
    ids = _segsum_case(case, R, T, device)
    g = torch.randn((K, R), generator=torch.Generator().manual_seed(R)
                    ).to(device)
    poison = torch.full((K, T), float("nan"), device=device)
    del poison  # the caching allocator hands its block to the output
    before = launched("segsum")
    out = segsum.segment_accumulate(ids, g, T)
    assert launched("segsum") == before + 1
    torch.cuda.synchronize()
    assert out.shape == (K, T) and bool(torch.isfinite(out).all())
    plain = segsum.segment_accumulate_plain(ids, g, T)
    exact = segsum.segment_accumulate_plain(ids, g.double(), T)
    mass = segsum.segment_accumulate_plain(ids, g.double().abs(), T)
    assert bool(((out.double() - exact).abs() <= 4e-6 * mass).all())
    assert bool(((out - plain).abs().double() <= 5e-4 * mass).all())
    if case == "all_miss":
        assert not out.any()


def test_grads_on_card_match_cpu(device):
    """Six parameter groups through the card (kernels, K3 in the backward)
    vs the CPU (plain versions).  The hit ids are bit-equal; shading ops
    round an ulp apart on the two devices and the per-pixel terms of a
    vertex gradient, which largely cancel, are summed in the kernel's tree
    order there and one by one here: rtol 1e-4, atol 2e-4 of the group's
    largest entry (5e-5 observed on the vertices, 2e-7 on the others)."""
    groups = ("vertices", "light_intensity", "light_position", "tex_color_a",
              "cam_position", "cam_rotation")
    grads = {}
    for dev in ("cpu", device):
        scene = make_test_scene(96, 64, num_quads=16, with_edges=True,
                                device=dev)
        params = {k: getattr(scene, k).clone().requires_grad_(True)
                  for k in groups}
        before = launched("segsum")
        img = render_image(scene.replace(**params))
        (img * img).sum().backward()
        k3 = launched("segsum") - before
        # per shading level: the packed rows and the tex_color_a rows
        assert k3 == (0 if dev == "cpu" else 8)
        grads[str(dev)] = {k: p.grad.cpu() for k, p in params.items()}
    for k in groups:
        want = grads["cpu"][k]
        assert bool(torch.isfinite(grads[str(device)][k]).all()), k
        torch.testing.assert_close(
            grads[str(device)][k], want, rtol=1e-4,
            atol=2e-4 * float(want.abs().max()),
            msg=lambda m, k=k: f"{k}: {m}")


@pytest.mark.parametrize("fault", ["dtype", "device", "layout"])
def test_segsum_wrapper_rejects(device, fault):
    g = torch.zeros((13, 2048), device=device)
    ids = torch.zeros((2048,), dtype=torch.int32, device=device)
    if fault == "dtype":
        g = g.half()
    elif fault == "device":
        ids = ids.cpu()
    else:
        g = torch.zeros((2048, 13), device=device).T
    before = launched("segsum")
    with pytest.raises(ValueError):
        segsum.segment_accumulate(ids, g, 66)
    assert launched("segsum") == before


PREVIEWS = pathlib.Path(__file__).resolve().parents[1] / "docs" / "previews"


def _bitmap_scene(device):
    """make_test_scene_dict's scene with its floor textured by the 640x360
    docs/previews/12-01-textures.jpg (a baseline JPEG: no PIL needed)."""
    return scene_from_dict(
        make_test_scene_dict(192, 128, num_quads=24,
                             floor_bitmap="12-01-textures.jpg"),
        asset_root=str(PREVIEWS), device=device)


def test_segsum_at_texel_ids(device, monkeypatch):
    """K3 over the flattened texel ids of a real backward into bitmap_data
    (T = 1 x 360 x 640), within 4e-6 sum|g| of fp64 and 5e-4 sum|g| of the
    plain version, one launch a shading level.  The texel gradient on the
    card vs the CPU is held by its sum over the texels (rtol 1e-5): a
    texel index is an integer function of one f32 product u * w, so an
    ulp between the devices moves a ray to the next texel at an edge, and
    a hit on the floor's shared diagonal to the other triangle, but every
    ray lands in some texel on both."""
    calls, real = [], segsum.segment_accumulate

    def recording(ids, g, num_segments):
        out = real(ids, g, num_segments)
        calls.append((ids, g, num_segments, out))
        return out

    monkeypatch.setattr(segsum, "segment_accumulate", recording)
    grads = []
    for dev in (device, "cpu"):
        scene = _bitmap_scene(dev)
        data = scene.bitmap_data.detach().clone().requires_grad_(True)
        before = launched("segsum")
        render_image(scene.replace(bitmap_data=data)).sum().backward()
        grads.append(data.grad.cpu())
    texel = [c for c in calls if c[2] == 360 * 640]
    assert len(texel) == 8  # four shading levels, on each device
    assert launched("segsum") == before  # the CPU run launches none
    for ids, g, T, out in texel[:4]:
        assert ids.is_cuda
        plain = segsum.segment_accumulate_plain(ids, g, T)
        exact = segsum.segment_accumulate_plain(ids, g.double(), T)
        mass = segsum.segment_accumulate_plain(ids, g.double().abs(), T)
        assert bool(((out.double() - exact).abs() <= 4e-6 * mass).all())
        assert bool(((out - plain).abs().double() <= 5e-4 * mass).all())
    assert int((texel[3][0] >= 0).sum()) > 5_000  # the primary's floor
    assert bool(torch.isfinite(grads[0]).all()) and grads[0].abs().max() > 0
    torch.testing.assert_close(grads[0].double().sum((0, 1, 2)),
                               grads[1].double().sum((0, 1, 2)),
                               rtol=1e-5, atol=0)


def _frame_tris(scene, st):
    """The primary hits' triangle ids as an [H, W] image."""
    rx, ry, untile = make_tiler(scene.height, scene.width,
                                device=scene.device)
    o, d = camera.generate_rays(scene.cam_position, scene.cam_rotation,
                                scene.cam_tan_half_fov, scene.width,
                                scene.height, rx, ry)
    tri = make_trace_fn(scene, st)(o.contiguous(), d, None).tri
    return untile(tri[:, None])[..., 0].cpu()


@pytest.mark.parametrize("aov", AOVS)
def test_aov_on_card_matches_cpu(device, aov):
    """An AOV on the card (one K1 launch; depth also through the streaming
    backend, one K8 launch) vs the CPU's, on the pixels whose hit is the
    same triangle on both devices: at least 99.5 % of them, since a ray
    through the floor's shared diagonal may take the other of its two
    coplanar triangles.  PyTorch's CUDA division by a scalar multiplies by
    its reciprocal, so the rays (and tri_id's bytes / 255) differ from the
    CPU's by an ulp: tri_id within rtol 1e-6 (its ids equal), bary within
    atol 1e-5 (the hit point moves by t x an ulp, ~2e-6 scene units, and a
    barycentric by that over an edge of the ~1-unit quads), the rest at
    the render's rtol 1e-5 / atol 1e-6."""
    scene = _bitmap_scene("cpu")
    cases = [("cluster", lambda: launched("closest_hit"))]
    if aov == "depth":
        cases.append(("stream",
                      lambda: launched("closest_hit_stream")))
    rtol, atol = {"tri_id": (1e-6, 0.0), "bary": (0.0, 1e-5)}.get(
        aov, (1e-5, 1e-6))
    for backend, launches in cases:
        st = RenderSettings(backend=backend)
        cpu = render_aov(scene, st, aov)
        before = launches()
        gpu = render_aov(scene.to(device), st, aov).cpu()
        assert launches() == before + 1
        same = _frame_tris(scene, st) == _frame_tris(scene.to(device), st)
        assert float(same.float().mean()) >= 0.995
        if aov == "tri_id":
            ids = [(x[same] * 255).round() for x in (gpu, cpu)]
            assert torch.equal(*ids)
        torch.testing.assert_close(gpu[same], cpu[same], rtol=rtol,
                                   atol=atol)


def test_gloo_ranks_render_on_card(device, tmp_path):
    """Two gloo ranks on this card (NCCL takes one rank a card) render a
    frame whose 31 rows do not divide between them: the row-sharded frame,
    assembled on both, equals the card's render_image (rtol 1e-5 / atol
    1e-6: the same rays, hits and shading, in other tiles)."""
    from test_torch_parallel import launch_ranks

    ranks = launch_ranks(tmp_path, ["rows_card"], 2, device="cuda")
    for r in ranks:
        got = r["rows_card"]
        assert torch.isfinite(got["sharded"]).all()
        torch.testing.assert_close(got["sharded"], got["single"], rtol=1e-5,
                                   atol=1e-6)
        torch.testing.assert_close(got["sharded"],
                                   ranks[0]["rows_card"]["sharded"], rtol=0,
                                   atol=0)


def test_staged_addon_renders_on_card(device, tmp_path):
    """The staged Blender add-on, unpacked and imported in a child process
    that finds crt_tpu_torch only in the zip, renders on cuda:0 with
    kernels built from the zip's own sources into its own directory: the
    Combined pass bit-equal to render_image of the exported dict here."""
    import numpy as np
    from blender_addon_child import run_staged_addon

    from crt_tpu_torch.frontend import api

    d = make_test_scene_dict(160, 90, num_quads=12)
    info, rect, exported = run_staged_addon(tmp_path, d, "cuda")
    root = str(tmp_path / "unpacked" / "crt_tpu_torch_renderer") + "/"
    assert info["package"].startswith(root)
    assert info["build"]["path"].startswith(root + "build/crt_tpu_torch/")
    assert info["launches"] == {"closest_hit": 4, "occlusion_w": 4,
                                "segsum": 0}
    ref = api.render_scene_from_dict_array(exported, "/", info["settings"],
                                           device=device)
    assert np.array_equal(rect, ref.reshape(-1, 4))


def test_render_ignores_the_callers_tf32(device):
    """With TF32 switched on for the whole process (cuBLAS, cuDNN, matmul
    precision "medium"), the opaque frame on the cluster and all-pairs
    backends and a GI frame equal the frames rendered with it off, bit for
    bit, and the gradient of the opaque frame is within K3's tolerance of
    the one with it off (4e-6 of the fp64 sum of |g| over the group; K3's
    atomics make gradients differ in the last bits from run to run).
    After every render the caller's settings read back as set."""
    from fp32_settings import under

    opaque = make_test_scene(192, 128, num_quads=24, device=device)
    gi = make_test_scene(96, 64, num_quads=8, gi_on=True, device=device)
    frames = {
        "cluster": lambda: render_image(opaque),
        "bruteforce": lambda: render_image(
            opaque, RenderSettings(backend="bruteforce")),
        "gi": lambda: render_image(gi),
    }
    keys = ("vertices", "light_intensity", "cam_position")

    def grads():
        params = {k: getattr(opaque, k).clone().requires_grad_(True)
                  for k in keys}
        render_image(opaque.replace(**params)).sum().backward()
        return {k: p.grad for k, p in params.items()}

    for name, fn in frames.items():
        ieee, tf32 = under("ieee", fn), under("tf32", fn)
        assert torch.equal(tf32.view(torch.int32), ieee.view(torch.int32)), \
            name
    g_ieee, g_tf32 = under("ieee", grads), under("tf32", grads)
    for k in keys:
        a, b = g_tf32[k].double(), g_ieee[k].double()
        assert bool(torch.isfinite(a).all()), k
        assert float((a - b).abs().max()) <= 4e-6 * float(b.abs().sum()), k


# -- Phase A: csrc/cluster_bin.cu against its plain versions --------------

BIN_COUNTERS = ("rays", "apex", "shared", "shared_uncapped", "shared_glass")


def _phase_a_rays(gen, tiles, lo, hi):
    """[tiles * 1024, 3] origins and directions: per tile a small origin box
    somewhere in [lo, hi] and a narrow direction cone, a quarter of the
    tiles with fully random directions; on about one tile in five an axis
    whose direction components are all +0.0 or -0.0 (neither sign-definite
    side of the slab), and on tiles 4 and 5 single lanes with a signed-zero
    component."""
    shape = (tiles, 1024, 3)
    o = lo + (hi - lo) * torch.rand((tiles, 1, 3), generator=gen)
    o = o + 0.05 * (hi - lo) * torch.rand(shape, generator=gen)
    d = torch.randn((tiles, 1, 3), generator=gen)
    d = d + 0.1 * torch.randn(shape, generator=gen)
    wild = torch.rand((tiles, 1, 1), generator=gen) < 0.25
    d = torch.where(wild, torch.randn(shape, generator=gen), d)
    zeros = torch.where(torch.rand(shape, generator=gen) < 0.5, -0.0, 0.0)
    flat = torch.rand((tiles, 1, 3), generator=gen) < 0.2
    lane = torch.rand(shape, generator=gen) < 0.02
    lane[:4] = False
    lane[6:] = False
    d = torch.where(flat | lane, zeros, d)
    return o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()


def _phase_a_masks(gen, tiles, masks=2):
    """[masks, tiles * 1024] bool: tile 0 dead in every mask, tile 1 with
    one live lane (another in each mask), tile 2 all live, tile 3 live in
    the first mask alone, the rest half live."""
    a = torch.rand((masks, tiles, 1024), generator=gen) < 0.5
    a[:, :2] = False
    for m in range(masks):
        a[m, 1, 100 + 300 * m] = True
    a[:, 2] = True
    a[1:, 3] = False
    return a.reshape(masks, -1)


@pytest.fixture(scope="module", params=["quads", "big"])
def phase_a_case(request, device):
    """Tables and a random wavefront for Phase A: the 66-triangle glass
    quads (L = 5, the benchmark scene's) or 65,536 triangles (L = 4,096,
    over a block's 256 threads, with every 16th cluster's box as its glass
    box and the others glass_subset's +-3.4e38); two lights either way."""
    if request.param == "quads":
        scene = make_test_scene(192, 128, num_quads=64,
                                with_refractive=True, device=device)
    else:
        scene = make_big_scene(65536, 256, 128, seed=1, device=device)
    tables = cluster_tables.build_cluster_tables(scene)
    _, gmin, gmax = cluster_tables.glass_subset(scene, tables)
    L = tables.cl_min.shape[0]
    if request.param == "big":
        keep = (torch.arange(L, device=device) % 16 == 3)[:, None]
        gmin = torch.where(keep, tables.cl_min, gmin).contiguous()
        gmax = torch.where(keep, tables.cl_max, gmax).contiguous()
    lights = scene.light_position
    if lights.shape[0] == 1:
        lights = torch.cat([lights, lights + torch.tensor(
            [1.5, 0.5, -2.0], device=device)])
    gen = torch.Generator().manual_seed(11)
    verts = scene.vertices.detach().cpu()
    o, d = _phase_a_rays(gen, 24, verts.amin(0), verts.amax(0))
    return dict(tables=tables, glass=(gmin, gmax), o=o.to(device),
                d=d.to(device), act=_phase_a_masks(gen, 24).to(device),
                lights=lights.contiguous(), L=L)


def _phase_a_call(x, mode, lights, plain=False):
    """One Phase A call in ``mode`` over ``x``'s tensors (on their device),
    through the wrapper or the plain version."""
    def fn(entry):
        return getattr(binning, entry + ("_plain" if plain else ""))

    tables, o, d = x["tables"], x["o"], x["d"]
    act, lp = x["act"][:lights], x["lights"][:lights].contiguous()
    if mode == "rays":
        return fn("bin_rays")(tables, o, d, 1024)
    if mode == "rays_masked":
        return fn("bin_rays")(tables, o, d, 1024, act[0])
    if mode == "apex":
        apex = lp.repeat_interleave(o.shape[0] // 1024, dim=0)
        return fn("bin_rays")(tables, o.repeat(lights, 1),
                              d.repeat(lights, 1), 1024, act.reshape(-1),
                              apex=apex, apex_slack=0.02)
    kw = {"shared": {},
          "shared_uncapped": dict(boxes=x["glass"], capped=False),
          "shared_glass": dict(glass_boxes=x["glass"])}[mode]
    return fn("bin_apex_shared")(tables, o, lp, act, 1024, 0.02, **kw)


def _on_cpu(x):
    out = {}
    for k, v in x.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.cpu()
        elif isinstance(v, cluster_tables.ClusterTables):
            out[k] = type(v)(*(t.cpu() for t in v))
        elif isinstance(v, tuple):
            out[k] = tuple(t.cpu() for t in v)
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("mode,lights", [
    ("rays", 1), ("rays_masked", 1),
    *((m, n) for m in ("apex", "shared", "shared_uncapped", "shared_glass")
      for n in (1, 2))])
def test_cluster_bin_matches_plain(device, phase_a_case, mode, lights):
    """Phase A's kernel in every mode launches once, under its mode's
    counter, and its lists and counts equal the plain version's bit for
    bit, on the card and on the CPU, over random coherent and incoherent
    tiles with +-0.0 direction components, dead tiles (count 0, the
    identity list) and one-lane tiles, 1 and 2 lights, glass_subset's
    +-3.4e38 boxes, and L = 5 or L = 4,096."""
    x = phase_a_case
    counter = {"rays_masked": "rays"}.get(mode, mode)
    c0 = tracing.counters()
    cl, cnt = _phase_a_call(x, mode, lights)
    c1 = tracing.counters()
    assert (tracing.total(c1, "crt.launches")
            - tracing.total(c0, "crt.launches")) == 1
    assert (c1[f"crt.launches.cluster_bin.{counter}"]
            - c0[f"crt.launches.cluster_bin.{counter}"]) == 1
    pcl, pcnt = _phase_a_call(x, mode, lights, plain=True)
    ccl, ccnt = _phase_a_call(_on_cpu(x), mode, lights)
    torch.cuda.synchronize()
    assert cl.dtype == torch.int32 and cnt.dtype == torch.int32
    assert torch.equal(cnt, pcnt) and torch.equal(cl, pcl)
    assert torch.equal(cnt.cpu(), ccnt) and torch.equal(cl.cpu(), ccl)
    L = x["L"]
    assert bool((cnt > 0).any()) and bool((cnt < L).any())
    if mode != "rays":
        tpl = x["o"].shape[0] // 1024
        dead = torch.arange(cnt.shape[0], device=device) % tpl == 0
        assert not bool(cnt[dead].any())
        ident = torch.arange(L, dtype=torch.int32, device=device)
        assert bool((cl[dead] == ident).all())


@pytest.mark.parametrize("frame", ["gi", "glass"])
def test_cluster_bin_frames_bit_equal_to_plain_binning(device, monkeypatch,
                                                       frame):
    """The 1080p GI frame (K = 4, depth 3: 16 bin_rays and 16
    bin_apex_shared calls in two chunks) and the 1080p glass frame (12
    bin_rays, the march's traces among them, and 4 glass-box
    bin_apex_shared calls): every Phase A call launches the kernel, and
    the image equals, bit for bit, the one rendered with the plain binning
    put in the kernel's place."""
    scene_kw, st, expect = {
        "gi": (dict(gi_on=True),
               RenderSettings(diffuse_reflection_ray_count=4),
               {"rays": 16, "shared": 16}),
        "glass": (dict(with_refractive=True), RenderSettings(),
                  {"rays": 12, "shared_glass": 4}),
    }[frame]
    scene = make_test_scene(1920, 1080, 64, device=device, **scene_kw)
    before = modes("cluster_bin", BIN_COUNTERS)
    img = render_image(scene, st)
    after = modes("cluster_bin", BIN_COUNTERS)
    added = {m: after[m] - before[m] for m in BIN_COUNTERS
             if after[m] > before[m]}
    monkeypatch.setattr(cluster_trace, "bin_rays", binning.bin_rays_plain)
    monkeypatch.setattr(cluster_trace, "bin_apex_shared",
                        binning.bin_apex_shared_plain)
    plain = render_image(scene, st)
    torch.cuda.synchronize()
    assert added == expect
    assert modes("cluster_bin", BIN_COUNTERS) == after
    assert float(img.mean()) > 0
    assert torch.equal(img.view(torch.int32), plain.view(torch.int32))


# -- Phase A of the streaming trace: csrc/stream_bin.cu against its plain
# version ------------------------------------------------------------------

STREAM_BIN_MODES = stream_binning.MODES


def _stream_bin(x, mode, plain=False, cap=2):
    """One streaming Phase A call in ``mode`` over ``x``'s tensors (on
    their device), through ``bin_stream`` or ``bin_stream_plain``."""
    shaft = dict(apex=x["apex"], apex_slack=0.02)
    kw = {"rays": {},
          "shaft_capped": dict(shaft, per_tile_cap=cap),
          "shaft_exact": dict(shaft, r2=x["r2"]),
          "shaft": dict(shaft, lane_exact=False)}[mode]
    fn = stream_binning.bin_stream_plain if plain else stream_binning.bin_stream
    return fn(*x["boxes"], x["o"], x["d"], 1024, x["act"], **kw)


@pytest.fixture(scope="module", params=["quads3", "big24", "big32"])
def stream_bin_case(request, device):
    """The flat two-light shadow wavefront of a scene (light 1 active on x
    > 0 only, every third tile of pixels dead) with its streaming tables:
    the 24 quads at 3 clusters a supercluster (padded clusters in the last
    one), or 65,536 triangles at 24 (padded) and 32."""
    big, sc = {"quads3": (False, 3), "big24": (True, 24),
               "big32": (True, 32)}[request.param]
    scene = _sized_scene(big, device)
    tables = cluster_tables.build_cluster_tables(scene)
    st = stream_trace.build_stream_tables(tables, sc)
    o, d, r2, act, apex = _flat(*_dir_shadow_wavefront(scene, tables, 1024),
                                1024)
    return dict(boxes=stream_trace._boxes(st), o=o, d=d, r2=r2, act=act,
                apex=apex)


def _same_lists(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g.cpu(), w.cpu())


def _stream_bin_checked(x, mode, **kw):
    """``bin_stream`` in ``mode``: one launch under its mode's counter and
    one read of the list's length; its lists equal the plain version's on
    the card and on the CPU, and so do the counted pairs."""
    c0 = tracing.counters()
    got = _stream_bin(x, mode, **kw)
    c1 = tracing.counters()
    want = _stream_bin(x, mode, plain=True, **kw)
    c2 = tracing.counters()
    cpu = _stream_bin(_on_cpu(x), mode, plain=True, **kw)
    torch.cuda.synchronize()
    assert (tracing.total(c1, "crt.launches")
            - tracing.total(c0, "crt.launches")) == 1
    assert (c1[f"crt.launches.stream_bin.{mode}"]
            - c0[f"crt.launches.stream_bin.{mode}"]) == 1
    assert (c1["crt.host_reads.stream_pairs"]
            - c0["crt.host_reads.stream_pairs"]) == 1
    for name in ("crt.binning.pairs.supercluster", "crt.binning.pairs.hull"):
        assert c1[name] - c0[name] == c2[name] - c1[name]
    _same_lists(got, want)
    _same_lists(got, cpu)
    return got


@pytest.mark.parametrize("mode", STREAM_BIN_MODES)
def test_stream_bin_matches_plain(device, stream_bin_case, mode):
    """Phase A's streaming kernel in every mode: one launch, and the pair
    list, member words and tile ranges of the plain version bit for bit,
    with dead tiles, one-light tiles and padded clusters."""
    _, _, start = _stream_bin_checked(stream_bin_case, mode)
    assert int(start[-1]) > 0
    assert bool((start[1:] == start[:-1]).any())  # tiles without a pair


def _edge_case(device, empty=False):
    """Boxes and a wavefront of 8 tiles built to reach the edges: every
    other supercluster the copy of the one before (equal distances, ties in
    index order); the last member of every third a pad (+-3.4e38); tile 0
    without an active lane, tile 1 with one; tile 2's light at x = 1.8e19
    inside long superclusters whose centres lie past it, so that their
    squared distance from the tile overflows to +inf, above the refused
    superclusters' 3.4e38.  ``empty``
    moves every lane, and its light further, below every box."""
    gen = torch.Generator().manual_seed(5)
    L2, sc, tiles = 300, 6, 8
    centre = torch.randn((L2, 1, 3), generator=gen) * 4.0
    lo = centre + torch.rand((L2, sc, 3), generator=gen) - 0.5
    hi = lo + 0.5 * torch.rand((L2, sc, 3), generator=gen)
    lo[-6:] = torch.tensor([0.9e19, -1.0, -1.0]) + torch.rand(
        (6, sc, 3), generator=gen) * torch.tensor([1e18, 0.5, 0.5])
    hi[-6:] = torch.cat([torch.full((6, sc, 1), 3.2e19),
                         lo[-6:, :, 1:] + 1.0], dim=-1)
    lo[1::2], hi[1::2] = lo[0::2], hi[0::2]
    lo[::3, -1], hi[::3, -1] = 3.4e38, -3.4e38
    cl_min, cl_max = lo.reshape(-1, 3), hi.reshape(-1, 3)
    boxes = (lo.amin(dim=1), hi.amax(dim=1), cl_min, cl_max)

    at = torch.rand((tiles, 1, 3), generator=gen) * 12.0 - 6.0
    at[2] = 0.0
    o = at + 0.3 * torch.rand((tiles, 1024, 3), generator=gen)
    lights = torch.rand((tiles, 3), generator=gen) * 16.0 - 8.0
    lights[2] = torch.tensor([1.8e19, 0.0, 0.0])
    if empty:
        o = o - torch.tensor([0.0, 1e3, 0.0])
        lights = lights - torch.tensor([0.0, 2e3, 0.0])
    lv = lights[:, None, :].double() - o.double()
    r2 = (lv * lv).sum(dim=-1)
    d = (lv / torch.sqrt(r2)[..., None]).float()
    r2 = r2.float()
    act = torch.rand((tiles, 1024), generator=gen) < 0.5
    act[0] = False
    act[1] = False
    act[1, 77] = True
    x = dict(boxes=boxes, o=o.reshape(-1, 3), d=d.reshape(-1, 3),
             r2=r2.reshape(-1), act=act.reshape(-1), apex=lights)
    return {k: tuple(t.to(device) for t in v) if isinstance(v, tuple)
            else v.to(device).contiguous() for k, v in x.items()}


@pytest.mark.parametrize("keys", ["shared", "global"])
@pytest.mark.parametrize("mode,cap", [
    ("rays", 2), ("shaft", 2), ("shaft_exact", 2),
    *(("shaft_capped", c) for c in (1, 2, 3, 10, 1000))])
def test_stream_bin_edges_match_plain(device, monkeypatch, mode, cap, keys):
    """Equal distances, padded clusters, a dead tile, a one-lane tile, keys
    of +inf (after the refused superclusters in the plain version's sort,
    so a cap counts those too), caps from 1 to over every tile's survivors,
    and the sort keys in shared memory or, past its size, in global
    memory: the kernel's lists equal the plain version's."""
    x = _edge_case(device)
    if keys == "global":  # room for the bitsets and not for the keys
        monkeypatch.setattr(stream_binning, "_SMEM_BYTES", 4 * 16 * 2)
    pair_sc, _, start = _stream_bin_checked(x, mode, cap=cap)
    per_tile = (start[1:] - start[:-1]).cpu()
    assert per_tile[0] == 0 and per_tile[1:].sum() > 0
    if mode == "shaft":
        lists = [pair_sc[start[t]:start[t + 1]].cpu().tolist()
                 for t in range(8)]
        assert any(c >= 294 for c in lists[2])  # a key of +inf listed
        assert any(c % 2 == 0 and c + 1 in lst
                   and lst.index(c + 1) == lst.index(c) + 1
                   for lst in lists for c in lst)  # a tie, index order


@pytest.mark.parametrize("mode", STREAM_BIN_MODES)
def test_stream_bin_empty_list(device, mode):
    """A wavefront whose shafts and frusta reach no box: one launch, no
    pack, an empty list and tile ranges of zeros, as the plain version."""
    pair_sc, bits, start = _stream_bin_checked(_edge_case(device, True),
                                               mode)
    assert pair_sc.shape == (0,) and bits.shape == (0,)
    assert not bool(start.any())


def _cloned_args(args, kw):
    def c(v):
        return v.clone() if isinstance(v, torch.Tensor) else v

    return tuple(map(c, args)), {k: c(v) for k, v in kw.items()}


@pytest.mark.parametrize("frame", ["1m", "k0"])
def test_stream_bin_frames_bit_equal_to_plain_binning(device, monkeypatch,
                                                      frame):
    """The 1 M-triangle 1080p frame (default settings: a rays, a
    shaft_capped and a shaft_exact call) and a 65,536-triangle 1080p frame
    with ``stream_shadow_k=0`` (a rays and a shaft_exact call): each Phase
    A call launches the kernel once and lists what the plain version lists,
    and the image equals, bit for bit, the one rendered with the plain
    Phase A in the kernel's place."""
    n, settings, expect = {
        "1m": (1_000_000, RenderSettings(),
               {"rays": 1, "shaft_capped": 1, "shaft_exact": 1}),
        "k0": (65536, RenderSettings(backend="stream", stream_shadow_k=0),
               {"rays": 1, "shaft_exact": 1}),
    }[frame]
    scene = make_big_scene(n, 1920, 1080, seed=0, device=device)
    calls = []
    real = stream_binning.bin_stream

    def record(*args, **kw):
        calls.append(_cloned_args(args, kw))
        out = real(*args, **kw)
        calls[-1] += (out,)
        return out

    monkeypatch.setattr(stream_binning, "bin_stream", record)
    before = modes("stream_bin", STREAM_BIN_MODES)
    img = render_image(scene, settings)
    after = modes("stream_bin", STREAM_BIN_MODES)
    assert {m: after[m] - before[m] for m in STREAM_BIN_MODES
            if after[m] > before[m]} == expect
    assert len(calls) == sum(expect.values())
    for args, kw, out in calls:
        _same_lists(out, stream_binning.bin_stream_plain(*args, **kw))
    monkeypatch.setattr(stream_binning, "bin_stream",
                        stream_binning.bin_stream_plain)
    plain = render_image(scene, settings)
    torch.cuda.synchronize()
    assert modes("stream_bin", STREAM_BIN_MODES) == after
    assert float(img.mean()) > 0
    assert torch.equal(img.view(torch.int32), plain.view(torch.int32))


# ---------------------------------------------------------------------------
# The KD walk (csrc/tree_walk.cu) vs the plain lock-step walk
# ---------------------------------------------------------------------------

def _tree_walks(scene):
    """Each closest_hit_tree call of one tree frame of ``scene``: (accel,
    tri, o [R, 3], d [R, 3], active [R] or None), cloned."""
    from crt_tpu_torch.ops import traverse

    calls = []
    real = traverse.closest_hit_tree

    def record(accel, tri, o, d, active=None):
        calls.append((accel, tri, o.reshape(-1, 3).clone(),
                      d.reshape(-1, 3).clone(),
                      None if active is None else active.reshape(-1).clone()))
        return real(accel, tri, o, d, active)

    traverse.closest_hit_tree = record
    try:
        render_image(scene, RenderSettings(backend="tree"))
    finally:
        traverse.closest_hit_tree = real
    return calls


@pytest.fixture(scope="module")
def tree_frame(device):
    scene = make_test_scene(1920, 1080, num_quads=64, device=device)
    return scene, _tree_walks(scene)


def _walk_both(accel, tri, o, d, active=None):
    """(kernel, plain) results of one walk; the kernel's launch counted."""
    from crt_tpu_torch.ops import traverse

    before = launched("tree_walk")
    k = traverse.walk(accel, tri, o, d, active)
    assert launched("tree_walk") == before + 1
    p = traverse.closest_hit_tree_plain(accel, tri, o, d, active)
    torch.cuda.synchronize()
    return k, p


def _same_walk(k, p):
    assert torch.equal(k[1], p[1])
    assert torch.equal(k[0].view(torch.int32), p[0].view(torch.int32))


@pytest.mark.parametrize("which", ["camera", "bounce", "shadow"])
def test_tree_walk_matches_plain_on_the_frame(device, tree_frame, which):
    """The 1080p quads frame's walks: the camera rays, every mirror bounce
    (inactive lanes given NaN directions) and the stacked two-light shadow
    passes with their active masks."""
    _, calls = tree_frame
    R = calls[0][2].shape[0]  # the camera rays, padded to whole tiles
    assert len(calls) == 8
    if which == "camera":
        picked = calls[:1]
    elif which == "bounce":
        picked = [c for c in calls[1:] if c[2].shape[0] == R]
        nan = torch.full((3,), float("nan"), device=device)
        picked = [(a, t, o, torch.where(act[:, None], d, nan), act)
                  for a, t, o, d, act in picked]
    else:
        picked = [c for c in calls if c[2].shape[0] == 2 * R]
    assert picked
    for accel, tri, o, d, act in picked:
        k, p = _walk_both(accel, tri, o, d, act)
        _same_walk(k, p)
        if act is not None:
            assert bool((k[1][~act] == -1).all())
            assert bool(torch.isinf(k[0][~act]).all())
    assert bool((k[1] >= 0).any())


def test_tree_walk_on_axis_rays_and_node_planes(device, tree_frame):
    """Random rays with zero direction components of both signs, from
    origins on the nodes' box planes."""
    scene, calls = tree_frame
    accel, tri = calls[0][0], calls[0][1]
    gen = torch.Generator().manual_seed(17)
    n = 1 << 16
    lo = accel.node_min.cpu()
    hi = accel.node_max.cpu()
    node = torch.randint(0, lo.shape[0], (n,), generator=gen)
    u = torch.rand((n, 3), generator=gen)
    o = lo[node] + u * (hi[node] - lo[node])
    axis = torch.randint(0, 3, (n,), generator=gen)
    side = torch.where(torch.rand(n, generator=gen) < 0.5, lo[node, axis],
                       hi[node, axis])
    o[torch.arange(n), axis] = side
    d = torch.randn((n, 3), generator=gen)
    d = d / d.norm(dim=1, keepdim=True)
    zero = torch.randint(0, 3, (n,), generator=gen)
    sign = torch.where(torch.rand(n, generator=gen) < 0.5, 0.0, -0.0)
    d[torch.arange(n), zero] = sign
    d[: n // 16, :2] = 0.0  # rays along z
    d[: n // 16, 2] = 1.0
    k, p = _walk_both(accel, tri, o.to(device).contiguous(),
                      d.to(device).contiguous())
    _same_walk(k, p)
    assert bool((k[1] >= 0).any()) and bool((k[1] < 0).any())


@pytest.mark.parametrize("case", ["soup65k", "deep_leaves"])
def test_tree_walk_matches_plain_on_other_trees(device, case):
    """The 65,536-triangle soup's tree, and a tree cut at depth 3 whose
    leaves hold more than 16 triangles (leaf_size > 16)."""
    from crt_tpu_torch.ops import traverse
    from crt_tpu_torch.scene.accel import build_accel_tree

    if case == "soup65k":
        scene = make_big_scene(65536, 480, 270, device=device)
        accel = scene.accel
    else:
        scene = make_test_scene(480, 270, num_quads=64, device=device)
        accel = build_accel_tree(scene.vertices.cpu().numpy(),
                                 scene.tri_vidx.cpu().numpy(), max_depth=3,
                                 device=device)
        assert accel.leaf_size > 16
    tri = traverse.build_triangle_gather(
        scene.vertices, scene.tri_vidx,
        scene.mat_backface[scene.tri_material.long()])
    o, d = _wavefront(scene)
    act = torch.arange(o.shape[0], device=device) % 5 != 0
    for a in (None, act):
        k, p = _walk_both(accel, tri, o, d, a)
        _same_walk(k, p)
    assert bool((k[1] >= 0).any())


def _per_ray_leaves(accel, o, d, active):
    """Hit leaves of the reference's per-ray stack walk, in float32 NumPy
    with the port's slab test (the CPU tests' count)."""
    import numpy as np

    from crt_tpu_torch.ops import traverse

    lo, hi = accel.node_min.cpu().numpy(), accel.node_max.cpu().numpy()
    kids = accel.node_children.cpu().numpy()
    leaf = accel.node_leaf_id.cpu().numpy()
    inv = traverse._inverse(d.cpu()).numpy()
    oo, act = o.cpu().numpy(), active.cpu().numpy()
    leaves = 0
    for r in np.nonzero(act)[0]:
        stack = [0]
        while stack:
            n = stack.pop()
            t1, t2 = (lo[n] - oo[r]) * inv[r], (hi[n] - oo[r]) * inv[r]
            near = max(np.minimum(t1, t2).max(), np.float32(0.0))
            if np.maximum(t1, t2).min() < near:
                continue
            if leaf[n] >= 0:
                leaves += 1
            else:
                stack += [int(c) for c in kids[n] if c >= 0]
    return leaves


def test_tree_walk_counts_leaf_lanes_on_the_device(device):
    """While tracing is on the kernel counts the (ray, leaf) pairs at a
    hit leaf, as the plain walk and a per-ray walk count them; one launch
    a walk and no host read."""
    from crt_tpu_torch.ops import traverse

    scene = make_test_scene(64, 32, num_quads=16, with_edges=True,
                            device=device)
    o, d = _wavefront(scene)
    act = torch.arange(o.shape[0], device=device) % 3 != 0
    tri = traverse.build_triangle_gather(
        scene.vertices, scene.tri_vidx,
        scene.mat_backface[scene.tri_material.long()])
    with tracing.recording() as kc:
        k = traverse.walk(scene.accel, tri, o, d, act)
    with tracing.recording() as pc:
        p = traverse.closest_hit_tree_plain(scene.accel, tri, o, d, act)
    _same_walk(k, p)
    want = _per_ray_leaves(scene.accel, o, d, act)
    assert kc["crt.tree.leaf_lanes"] == pc["crt.tree.leaf_lanes"] == want > 0
    assert kc["crt.launches.tree_walk"] == kc["crt.tree.walks"] == 1
    assert kc["crt.host_reads.tree_walk"] == 0
    assert kc["crt.tree.iterations"] == 0 < pc["crt.tree.iterations"]


def test_tree_frame_launches_one_walk_kernel_a_walk(device):
    """A tree frame: every walk is one launch, no walk reads the host, and
    the frame is bit-equal with tracing on and off."""
    from torch.profiler import ProfilerActivity, profile

    scene = make_test_scene(480, 270, num_quads=64, device=device)
    settings = RenderSettings(backend="tree")
    with tracing.recording() as c:
        off = render_image(scene, settings)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        on = render_image(scene, settings)
        torch.cuda.synchronize()
    assert torch.equal(on.view(torch.int32), off.view(torch.int32))
    assert c["crt.launches.tree_walk"] == c["crt.tree.walks"] == 8
    assert c["crt.host_reads.tree_walk"] == 0
    assert c["crt.tree.leaf_lanes"] > 0
    host = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU]
    assert sum(e.name == "crt.tree.walk" for e in host) == 8
    assert any("tree_walk_kernel" in e.name for e in prof.events())

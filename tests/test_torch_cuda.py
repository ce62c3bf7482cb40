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

import pytest
import torch

from crt_tpu_torch import RenderSettings, render_image
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
from crt_tpu_torch.renderer import make_tiler
from crt_tpu_torch.scene.procedural import make_big_scene, make_test_scene

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


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
    before = cluster_trace.closest_hit_launches
    k = cluster_trace.closest_hit(tables, o, d, cl, cnt, rows_table)
    assert cluster_trace.closest_hit_launches == before + 1
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
    before = cluster_trace.occlusion_w_launches
    k = cluster_trace.occlusion_w(tables, shadow_o, point, lights, cl, cnt)
    assert cluster_trace.occlusion_w_launches == before + 1
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
    before = dict(cluster_trace.occlusion_w_mode_launches)
    k = cluster_trace.occlusion_w(tables, shadow_o, point, lights, cl, cnt,
                                  **kw)
    after = cluster_trace.occlusion_w_mode_launches
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
                scl=scl, scnt=scnt)


@pytest.mark.parametrize("kernel", ["closest_hit", "compact", "merged",
                                    "occlusion_w"])
def test_cluster_kernels_on_lists_longer_than_a_batch(device, long_lists,
                                                      kernel):
    """K1 (and K4 / K7, which take its walk) and K2 on lists of tens to
    hundreds of clusters, staged in many batches: bit-equal to the plain
    version on every lane."""
    L = long_lists
    tables, o, d = L["tables"], L["o"], L["d"]
    if kernel == "occlusion_w":
        assert int(L["scnt"].max()) > 8 * 8
        k = cluster_trace.occlusion_w(tables, *L["shadow"], L["scl"],
                                      L["scnt"])
        p = cluster_trace.occlusion_w_plain(tables, *L["shadow"], L["scl"],
                                            L["scnt"])
        torch.cuda.synchronize()
        assert torch.equal(k, p) and k.any() and not k.all()
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


@pytest.mark.parametrize("kernel", ["closest_hit", "occlusion_w"])
def test_dead_tiles_between_live_ones(device, kernel):
    """A wavefront of more units (256-lane quarter tiles) than the
    persistent grid has blocks, its tiles dead and live in a pattern, so
    each block walks some units and writes the miss result of others:
    bit-equal to the plain version on every lane, misses on dead tiles."""
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


@pytest.mark.parametrize("mode", ["capped", "uncapped_masked", "glass"])
def test_occlusion_w_with_repeated_rays(device, mode):
    """Lanes that share their warp's first lane's ray, bit for bit, take
    its answer: every other warp of the wavefront repeats that lane's ray
    (as a frame's lanes without a hit repeat the camera's), the rest are
    distinct; bit-equal to the plain version in each mode."""
    scene = make_test_scene(192, 128, num_quads=24, with_refractive=True,
                            device=device)
    tables = cluster_tables.build_cluster_tables(scene)
    gm, gmin, gmax = cluster_tables.glass_subset(scene, tables)
    shadow_o, point, lights, act = _shadow_wavefront(scene, tables)
    lane = torch.arange(shadow_o.shape[0], device=device)
    lead = lane - lane % 32
    rep = (lane // 32) % 2 == 1
    src = torch.where(rep, lead, lane)
    shadow_o, point = shadow_o[src].contiguous(), point[src].contiguous()
    kw, bin_kw = dict(
        capped=({}, {}),
        uncapped_masked=(dict(capped=False, member_mask=gm),
                         dict(boxes=(gmin, gmax), capped=False)),
        glass=(dict(member_mask=gm, glass_flag=True),
               dict(glass_boxes=(gmin, gmax))))[mode]
    cl, cnt = binning.bin_apex_shared(tables, shadow_o, lights, act, 1024,
                                      0.02, **bin_kw)
    k = cluster_trace.occlusion_w(tables, shadow_o, point, lights, cl, cnt,
                                  **kw)
    p = cluster_trace.occlusion_w_plain(tables, shadow_o, point, lights, cl,
                                        cnt, **kw)
    torch.cuda.synchronize()
    k = k if isinstance(k, tuple) else (k,)
    p = p if isinstance(p, tuple) else (p,)
    for got, want in zip(k, p):
        assert torch.equal(got, want)
    assert k[0].any() and not k[0].all()


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
    before = (cluster_trace.closest_hit_compact_launches,
              cluster_trace.closest_hit_launches)
    k = cluster_trace.closest_hit_compact(tables, o, d, cl, cnt, rows_table,
                                          tile_mod=tile_mod)
    assert (cluster_trace.closest_hit_compact_launches,
            cluster_trace.closest_hit_launches) == (before[0] + 1, before[1])
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
    before = (cluster_trace.closest_hit_compact_launches,
              cluster_trace.live_tiles_launches)
    k = cluster_trace.closest_hit_compact(tables, o, d, cl, cnt, rows_table,
                                          tile_mod=mod)
    assert (cluster_trace.closest_hit_compact_launches,
            cluster_trace.live_tiles_launches) == (before[0] + 1,
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
    before = cluster_trace.live_tiles_launches
    ids, n_live = cluster_trace.live_tiles(counts)
    assert cluster_trace.live_tiles_launches == before + 1
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
    before = (cluster_trace.closest_hit_merged_launches,
              cluster_trace.closest_hit_launches)
    k = cluster_trace.closest_hit_merged(tables, o, d, cl, cnt, rows_table,
                                         merge=merge)
    assert (cluster_trace.closest_hit_merged_launches,
            cluster_trace.closest_hit_launches) == (before[0] + 1, before[1])
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


def test_tile_merge_render_on_card(device, monkeypatch):
    """With the merge at 2 every closest hit of the frame takes K7 (6
    tiles) and the image equals the default one bit for bit."""
    scene = make_test_scene(96, 64, num_quads=16, with_edges=True,
                            device=device)
    default = render_image(scene)
    monkeypatch.setattr(cluster_trace, "_TILE_MERGE", 2)
    before = (cluster_trace.closest_hit_merged_launches,
              cluster_trace.closest_hit_launches)
    img = render_image(scene)
    assert (cluster_trace.closest_hit_merged_launches,
            cluster_trace.closest_hit_launches) == (before[0] + 4, before[1])
    assert torch.equal(img, default)


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
    before = (dict(cluster_trace.occlusion_w_mode_launches),
              cluster_trace.closest_hit_compact_launches)
    gpu = render_image(scene.to(device), st).cpu()
    after = cluster_trace.occlusion_w_mode_launches
    assert after["glass"] > before[0]["glass"]
    assert after["capped"] == before[0]["capped"]
    assert ((cluster_trace.closest_hit_compact_launches > before[1])
            == bool(settings.get("compact_bounces")))
    torch.testing.assert_close(gpu, cpu, rtol=1e-5, atol=1e-6)


def test_render_on_card_matches_cpu(device):
    """The card render (kernels) vs the CPU render (plain versions): the
    trace is bit-equal, the shading ops may round differently on the two
    devices (rtol 1e-5 / atol 1e-6, test_pallas_trace.py's tolerance)."""
    scene = make_test_scene(96, 64, num_quads=16, with_edges=True,
                            device="cpu")
    cpu = render_image(scene)
    before = (cluster_trace.closest_hit_launches,
              cluster_trace.occlusion_w_launches)
    gpu = render_image(scene.to(device), RenderSettings()).cpu()
    after = (cluster_trace.closest_hit_launches,
             cluster_trace.occlusion_w_launches)
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
    before = dict(cluster_trace.occlusion_d_mode_launches)
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
    after = cluster_trace.occlusion_d_mode_launches
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
        before = stream_trace.closest_hit_stream_launches
        k = stream_trace.closest_hit_stream(
            st.fused, st.tables.tri_id, o, d, pair_sc, bits, start, sc,
            tile_rays)
        assert stream_trace.closest_hit_stream_launches == before + 1
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
        before = stream_trace.occlusion_stream_launches
        k9 = stream_trace.occlusion_stream(st.fused, o_f, d_f, r2_f, ~a_f,
                                           pair_sc, bits, start, sc,
                                           tile_rays)
        assert stream_trace.occlusion_stream_launches == before + 1
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
    return (dict(stream_trace.closest_hit_stream_layout_launches),
            dict(stream_trace.occlusion_stream_layout_launches))


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
def test_stream_render_layout_on_card(device, monkeypatch, layout):
    """CRT_STREAM_LAYOUT alone moves a streaming frame's launches (one
    closest hit and two any-hit passes per shading level) to the layout's
    kernels; the image equals the fused frame bit for bit."""
    scene = make_test_scene(96, 64, num_quads=16, with_edges=True,
                            device=device)
    settings = RenderSettings(backend="stream")
    monkeypatch.delenv("CRT_STREAM_LAYOUT", raising=False)
    fused = render_image(scene, settings)
    monkeypatch.setenv("CRT_STREAM_LAYOUT", layout)
    before = _layout_counts()
    img = render_image(scene, settings)
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
    two K9 launches of the two-phase shadow resolve."""
    scene = make_test_scene(96, 64, num_quads=16, with_edges=True,
                            device="cpu")
    st = RenderSettings(backend="pallas_stream")
    cpu = render_image(scene, st)
    before = (stream_trace.closest_hit_stream_launches,
              stream_trace.occlusion_stream_launches,
              cluster_trace.closest_hit_launches)
    stream_binning.stream_host_syncs = 0
    gpu = render_image(scene.to(device), st)
    after = (stream_trace.closest_hit_stream_launches,
             stream_trace.occlusion_stream_launches,
             cluster_trace.closest_hit_launches)
    assert after == (before[0] + 4, before[1] + 8, before[2])
    assert stream_binning.stream_host_syncs == 16
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


def test_direction_form_render_on_card(device, monkeypatch):
    """With the w form off the cluster backend's shadows take K5: the image
    equals the streaming backend's bit for bit (both direction form)."""
    scene = make_test_scene(96, 64, num_quads=16, with_edges=True,
                            device=device)
    monkeypatch.setattr(cluster_trace, "_APEX_W", False)
    before = (dict(cluster_trace.occlusion_d_mode_launches),
              cluster_trace.occlusion_w_launches)
    img = render_image(scene, RenderSettings(backend="cluster"))
    assert cluster_trace.occlusion_d_mode_launches["compact"] \
        == before[0]["compact"] + 4
    assert cluster_trace.occlusion_w_launches == before[1]
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
    before = segsum.segsum_launches
    out = segsum.segment_accumulate(ids, g, T)
    assert segsum.segsum_launches == before + 1
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
    before = segsum.segsum_launches
    out = segsum.segment_accumulate(ids, g, T)
    assert segsum.segsum_launches == before + 1
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
    before = segsum.segsum_launches
    out = segsum.segment_accumulate(ids, g, T)
    assert segsum.segsum_launches == before + 1
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
        before = segsum.segsum_launches
        img = render_image(scene.replace(**params))
        (img * img).sum().backward()
        launched = segsum.segsum_launches - before
        # per shading level: the packed rows and the tex_color_a rows
        assert launched == (0 if dev == "cpu" else 8)
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
    before = segsum.segsum_launches
    with pytest.raises(ValueError):
        segsum.segment_accumulate(ids, g, 66)
    assert segsum.segsum_launches == before

"""The chunked walk of the streaming kernels, modelled in plain torch.

K8 / K9 (``csrc/stream_trace.cu``) cut each tile's walk into chunks of at
most ``chunk`` live members (``stream_trace.stream_items``), walk the
chunks on any block in any order, and combine them: the any-hit ORs hits
into a mask that starts as the seed; the closest hit keeps per lane the
least 64-bit key (the bits of t with -0.0 made +0.0, above the member's
index in the walk) and then re-tests the winning cluster under the (t, id)
rule.  Here, on the CPU:

  - the item builder covers every tile's walk exactly once and in order,
    as the kernels decode it (random pair lists with empty pairs, tiles
    without pairs, tiles many chunks long, lane groups), longest tile
    first, within the bound the host sizes the grid by;
  - a model of the chunked walk and its combine equals the plain versions
    (``closest_hit_stream_plain`` / ``occlusion_stream_plain``) bit for bit
    in the fused, lane and rows layouts, with exact-t ties between clusters
    in different chunks and a -0.0 hit distance in the first cluster
    walked against a +0.0 in the next;
  - on that tie scene crt_tpu's streaming trace (interpret-mode
    ``pallas_stream``, in a subprocess without FMA) gives the model's
    bits, -0.0 included, and the plain version's bits and ids; routed
    through the cluster backend, ``closest_hit_plain`` gives the bits of
    crt_tpu's binned closest hit (interpret-mode ``pallas_trace``).

The plain versions are held to interpret-mode ``pallas_stream`` on larger
inputs by tests/test_torch_stream.py; the CUDA kernels to the plain
versions, forced small chunks included, by tests/test_torch_cuda.py and
chip_smoke.py on the card.

Tolerance: EXACT; t is compared by its bits (-0.0 and +0.0 differ), the
plain versions' too: they take t from the winning member itself, so on a
tie of -0.0 with +0.0 they keep the zero of the cluster walked first.
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
from crt_tpu_torch.ops import binning
from crt_tpu_torch.ops import cluster_tables as tct
from crt_tpu_torch.ops import stream_trace as tst
from crt_tpu_torch.ops.cluster_trace import _member_hit, _member_t
from crt_tpu_torch.scene.procedural import make_test_scene
from test_torch_trace_kernels import tie_rays, tie_scene_dict
from torch_port_fixtures import _one_torch_thread, _release_heap  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
TR = 256
NO_KEY = torch.iinfo(torch.int64).max
SCENE = dict(width=64, height=32, num_quads=600, with_reflective=False)
LIGHT = [1.5, 6.0, 1.0]


# ---------------------------------------------------------------------------
# The kernels' decoding, in Python
# ---------------------------------------------------------------------------

def decode_items(items: tst.StreamItems, tile_start):
    """Every item as the walk kernel decodes it -> [(work tile, first
    member, member count)], items in launch order."""
    item_end = items.item_end.tolist()
    order = items.order.tolist()
    off = items.pair_off.tolist()
    start = tile_start.tolist()
    out = []
    for i in range(item_end[-1] if item_end else 0):
        pos = next(k for k, e in enumerate(item_end) if e > i)
        wt = order[pos]
        c = i - (item_end[pos - 1] if pos else 0)
        tile = wt // items.groups
        g0 = off[start[tile]] + c * items.chunk
        out.append((wt, g0, min(items.chunk, off[start[tile + 1]] - g0)))
    return out


def member_clusters(pair_sc, pair_bits, tile_start, off, sc: int, tile: int,
                    g0: int, n: int):
    """Clusters of members g0 .. g0 + n - 1 of a tile's walk, found as the
    kernels find them: the last pair of the tile whose offset is <= g0,
    its lowest set bits dropped up to g0, then the set bits in order."""
    a, b = int(tile_start[tile]), int(tile_start[tile + 1]) - 1
    while a < b:
        mid = (a + b + 1) >> 1
        a, b = (mid, b) if off[mid] <= g0 else (a, mid - 1)
    p, bits = a, int(pair_bits[a]) & 0xFFFFFFFF
    for _ in range(g0 - off[a]):
        bits &= bits - 1
    out = []
    for _ in range(n):
        while bits == 0:
            p += 1
            bits = int(pair_bits[p]) & 0xFFFFFFFF
        m = (bits & -bits).bit_length() - 1
        bits &= bits - 1
        out.append(int(pair_sc[p]) * sc + m)
    return out


def random_pairs(gen, tiles, max_pairs, sc=32):
    """A random tile-major pair list: some tiles without pairs, some pairs
    without live members, some with every member live."""
    per_tile = gen.integers(0, max_pairs + 1, tiles)
    per_tile[gen.random(tiles) < 0.3] = 0
    P = int(per_tile.sum())
    bits = gen.integers(0, 2 ** 32, P, dtype=np.uint64)
    bits[gen.random(P) < 0.1] = 0
    bits[gen.random(P) < 0.1] = 2 ** 32 - 1
    if sc < 32:
        bits &= (1 << sc) - 1
    start = np.concatenate([[0], np.cumsum(per_tile)]).astype(np.int32)
    return (torch.tensor(gen.integers(0, 50, P), dtype=torch.int32),
            torch.tensor(bits.astype(np.uint32).view(np.int32)),
            torch.tensor(start))


@pytest.mark.parametrize("chunk", [1, 3, 8, 64])
@pytest.mark.parametrize("groups", [1, 4])
def test_items_cover_every_walk_once_in_order(chunk, groups):
    gen = np.random.default_rng(chunk * 10 + groups)
    for max_pairs in (0, 3, 40):
        pair_sc, bits, start = random_pairs(gen, 12, max_pairs)
        items = tst.stream_items(bits, start, chunk, groups)
        cl_list, counts = tst.pair_lists(pair_sc, bits, start, 32)
        off = items.pair_off.tolist()
        walk = [off[s] for s in start.tolist()]
        decoded = decode_items(items, start)
        # the bound the host sizes the persistent grid by
        assert len(decoded) <= tst._max_items(12, bits.shape[0], items)
        seen = {}
        for wt, g0, n in decoded:
            assert 1 <= n <= chunk
            seen.setdefault(wt, []).append((g0, n))
            tile = wt // groups
            got = member_clusters(pair_sc, bits, start, off, 32, tile, g0,
                                  n)
            pos = g0 - walk[tile]
            assert got == cl_list[tile, pos:pos + n].tolist()
        for wt in range(12 * groups):
            tile = wt // groups
            runs = seen.get(wt, [])
            # consecutive, from the walk's first member to its last
            assert [g0 for g0, _ in runs] == list(
                range(walk[tile], walk[tile + 1], chunk))
            assert sum(n for _, n in runs) == int(counts[tile])
        # longest walk first; equal walks in work-tile order
        n_w = [int(counts[wt // groups]) for wt in items.order.tolist()]
        assert n_w == sorted(n_w, reverse=True)
        assert sorted(items.order.tolist()) == list(range(12 * groups))


def test_chunk_checks():
    o = torch.zeros((TR, 3))
    none = torch.zeros((0,), dtype=torch.int32)
    start = torch.zeros((2,), dtype=torch.int32)
    table = torch.zeros((4, 16, 18))
    tid = torch.zeros((4, 16), dtype=torch.int32)
    for bad in (0, -3, 2.5):
        with pytest.raises(ValueError):
            tst.closest_hit_stream(table, tid, o, o, none, none, start, 4, TR,
                                   chunk=bad)
        with pytest.raises(ValueError):
            tst.occlusion_stream(table, o, o, torch.ones(TR),
                                 torch.zeros(TR, dtype=torch.bool), none,
                                 none, start, 4, TR, chunk=bad)


# ---------------------------------------------------------------------------
# The chunked walk and its combine, modelled
# ---------------------------------------------------------------------------

def _walk_clusters(pair_sc, pair_bits, tile_start, sc):
    """Cluster of every member of the walks, by global walk index."""
    member = ((pair_bits.long()[:, None] >> torch.arange(sc)) & 1).bool()
    p_idx, m_idx = torch.nonzero(member).unbind(dim=1)
    return pair_sc.long()[p_idx] * sc + m_idx


def _lanes(wt, groups, tile_rays):
    tile, group = divmod(wt, groups)
    return tile * tile_rays + group * 256 + torch.arange(256)


def _rays(x, lanes):
    return [x[lanes, i].reshape(1, 1, 1, -1) for i in range(3)]


def chunked_closest_hit(table, tri_id, o, d, pair_sc, pair_bits, tile_start,
                        sc, tile_rays, layout, chunk, gen):
    """K8's chunked walk: per item the least key of each lane over its
    members, min-combined over the items (taken in a random order), then
    the winning cluster re-tested under the (t, id) rule."""
    walker = tst._walker_tables(table, tri_id, layout)
    items = tst.stream_items(pair_bits, tile_start, chunk, tile_rays // 256)
    clusters = _walk_clusters(pair_sc, pair_bits, tile_start, sc)
    key = torch.full((o.shape[0],), NO_KEY, dtype=torch.int64)
    decoded = decode_items(items, tile_start)
    for k in gen.permutation(len(decoded)):
        wt, g0, n = decoded[k]
        lanes = _lanes(wt, items.groups, tile_rays)
        cl = clusters[g0:g0 + n][None]  # [1, n]
        tt = _member_t(walker, cl, *_rays(o, lanes), *_rays(d, lanes))
        t = tt.amin(dim=2)[0]  # [n, lanes]: each member cluster's best t
        bits = torch.where(t == 0, torch.zeros_like(t), t).view(
            torch.int32).long()
        g = torch.arange(g0, g0 + n)[:, None]
        k_item = torch.where(torch.isfinite(t), bits << 32 | g,
                             NO_KEY).amin(dim=0)
        key[lanes] = torch.minimum(key[lanes], k_item)
    # the second kernel: the cluster each key names, under the (t, id) rule
    t_out = torch.full((o.shape[0],), float("inf"))
    tri_out = torch.full((o.shape[0],), -1, dtype=torch.int32)
    hit = key != NO_KEY
    if hit.any():
        r = torch.nonzero(hit)[:, 0]
        cl = clusters[key[r] & 0xFFFFFFFF][:, None]  # [H, 1]
        tt = _member_t(walker, cl, *[x.reshape(-1, 1, 1, 1) for x in
                                     (o[r, 0], o[r, 1], o[r, 2], d[r, 0],
                                      d[r, 1], d[r, 2])])[:, 0, :, 0]
        best = tt.amin(dim=1)
        tid = walker.tri_id[cl[:, 0]]
        t_out[r] = best
        tri_out[r] = torch.where(tt <= best[:, None], tid,
                                 2 ** 30).amin(dim=1)
    return t_out, tri_out


def chunked_occlusion(table, o, d, r2, seed, pair_sc, pair_bits, tile_start,
                      sc, tile_rays, layout, chunk, gen):
    """K9's chunked walk: the seed, ORed with each item's hits."""
    walker = tst._walker_tables(table, None, layout)
    items = tst.stream_items(pair_bits, tile_start, chunk, tile_rays // 256)
    clusters = _walk_clusters(pair_sc, pair_bits, tile_start, sc)
    occ = seed.clone()
    decoded = decode_items(items, tile_start)
    for k in gen.permutation(len(decoded)):
        wt, g0, n = decoded[k]
        lanes = _lanes(wt, items.groups, tile_rays)
        valid, t = _member_hit(walker, clusters[g0:g0 + n][None],
                               *_rays(o, lanes), *_rays(d, lanes))
        hit = valid & (t * t <= r2[lanes].reshape(1, 1, 1, -1))
        occ[lanes] |= hit.any(dim=2).any(dim=1)[0]
    return occ


def same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _scene_wavefronts(tile_rays):
    """The small quad-soup scene: its primary wavefront and one light's
    shadow wavefront (origins just off the hit points, active where the
    primary ray hit)."""
    from crt_tpu_torch.ops import camera
    from crt_tpu_torch.renderer import make_tiler

    scene = make_test_scene(**SCENE, device="cpu")
    rx, ry, _ = make_tiler(scene.height, scene.width, device=scene.device)
    o, d = camera.generate_rays(scene.cam_position, scene.cam_rotation,
                                scene.cam_tan_half_fov, scene.width,
                                scene.height, rx, ry)
    o, d = o.contiguous(), d.contiguous()
    tables = tct.build_cluster_tables(scene)
    hit, _ = tst.closest_hit_stream_flat(
        tst.build_stream_tables(tables, 4), o, d, None, tile_rays,
        layout="fused")
    act = hit.tri >= 0
    p = o + d * torch.where(act, hit.t, torch.zeros_like(hit.t))[:, None]
    sd = torch.tensor(LIGHT) - p
    r2 = (sd * sd).sum(dim=1)
    so = p + 0.02 * sd / r2.sqrt()[:, None]
    return scene, tables, (o, d), (so.contiguous(), sd.contiguous(), r2, act)


@pytest.mark.parametrize("sc,tr", [(4, 256), (32, 256), (32, 1024)])
def test_chunked_walk_equals_plain(sc, tr):
    """At 1,024-lane tiles a tile is four work tiles of 256 lanes."""
    gen = np.random.default_rng(sc)
    scene, tables, (o, d), (so, sd, r2, act) = _scene_wavefronts(tr)
    st = tst.build_stream_tables(tables, sc, layout="lane")
    apex = torch.tensor([LIGHT]).expand(o.shape[0] // tr, 3)
    lane = torch.arange(o.shape[0])
    primary = tst.bin_stream_pairs(st, binning.tile_bounds(
        o, d, tr, (lane % 3 != 0) & ((lane // tr) % 4 != 1)))
    shadow = tst.bin_stream_pairs(st, binning.tile_bounds(so, sd, tr, act),
                                  apex, 0.02, near_first=True)
    walk = tst.stream_items(primary[1], primary[2], 1, 1).item_end
    assert (primary[2][1:] == primary[2][:-1]).any()  # tiles without pairs
    assert int(walk[0]) > 16  # the longest walk takes several chunks
    for layout in tst.LAYOUTS:
        table = tst.layout_table(st, layout)
        want = tst.closest_hit_stream_plain(table, st.tables.tri_id, o, d,
                                            *primary, sc, tr, layout)
        want9 = tst.occlusion_stream_plain(table, so, sd, r2, ~act, *shadow,
                                           sc, tr, layout)
        assert (want[1] >= 0).any() and want9[act].any()
        assert not want9[act].all()
        for chunk in (1, 5, 16, 64):
            t, tri = chunked_closest_hit(table, st.tables.tri_id, o, d,
                                         *primary, sc, tr, layout, chunk, gen)
            assert same_bits(t, want[0]) and torch.equal(tri, want[1])
            occ = chunked_occlusion(table, so, sd, r2, ~act, *shadow, sc, tr,
                                    layout, chunk, gen)
            assert torch.equal(occ, want9)


def tie_scene_negzero():
    """tests/test_torch_trace_kernels.py's tie scene with B's winding
    reversed, and rays: 1024 through the overlap from the origin (A, in
    cluster 0, and B, in cluster 1, hit at the same t), then 1024 that
    start on the shared plane inside both, where A's t is -0.0 and B's
    +0.0."""
    spec = tie_scene_dict()
    spec["objects"][15]["triangles"] = [0, 2, 1]
    o1, d1 = tie_rays()
    gen = np.random.default_rng(0)
    o2 = np.stack([gen.uniform(0.3, 1.0, 1024), gen.uniform(0.3, 0.9, 1024),
                   np.full(1024, -5.0)], -1).astype(np.float32)
    d2 = np.stack([gen.uniform(-0.2, 0.2, 1024), gen.uniform(-0.2, 0.2, 1024),
                   np.full(1024, -1.0)], -1)
    d2 = (d2 / np.linalg.norm(d2, axis=-1, keepdims=True)).astype(np.float32)
    return spec, np.concatenate([o1, o2]), np.concatenate([d1, d2])


def test_ties_and_negative_zero_across_chunks():
    """With one cluster per supercluster and one member per chunk, A and B
    are walked by different items: the first walked must still win the
    exact-t ties, and A's -0.0 must beat B's +0.0 though +0.0 has the
    smaller bits (hence the key's -0.0 -> +0.0).  The walk and the plain
    version both return A's -0.0: the plain version takes t from the
    winning member, not as the least over the walk positions (which may be
    either zero), so t is held to it by its bits."""
    spec, o, d = tie_scene_negzero()
    scene = scene_from_dict(spec, device="cpu")
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    st = tst.build_stream_tables(tct.build_cluster_tables(scene), 1,
                                 layout="lane")
    pairs = tst.bin_stream_pairs(st, binning.tile_bounds(o, d, TR, None))
    want = tst.closest_hit_stream_plain(st.fused, st.tables.tri_id, o, d,
                                        *pairs, 1, TR)
    assert (want[1] == 16).all() and (want[0][1024:] == 0).all()
    assert torch.signbit(want[0][1024:]).all()  # the plain version: A's zero
    gen = np.random.default_rng(1)
    for layout in tst.LAYOUTS:
        table = tst.layout_table(st, layout)
        for chunk in (1, 2):
            t, tri = chunked_closest_hit(table, st.tables.tri_id, o, d,
                                         *pairs, 1, TR, layout, chunk, gen)
            assert same_bits(t, want[0]) and torch.equal(tri, want[1])
            assert torch.signbit(t[1024:]).all()  # A's own zero


_REF_SCRIPT = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from crt_tpu.ops import pallas_stream as ps
from crt_tpu.scene.json_loader import scene_from_dict

spec = json.load(open(sys.argv[2]))
scene = scene_from_dict(spec["scene"], build_accel=False)
trace = ps.make_stream_trace_fn(scene, tile_rays=spec["tr"], interpret=True,
                                sc_clusters=1)
hit = trace(jnp.asarray(spec["o"], jnp.float32),
            jnp.asarray(spec["d"], jnp.float32))
np.savez(sys.argv[1], t=np.asarray(hit.t), tri=np.asarray(hit.tri))
"""


def test_ties_and_negative_zero_match_crt_tpu(tmp_path):
    spec, o, d = tie_scene_negzero()
    (tmp_path / "spec.json").write_text(json.dumps(
        {"scene": spec, "tr": TR, "o": o.tolist(), "d": d.tolist()}))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX "
                         "--xla_cpu_multi_thread_eigen=false",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", _REF_SCRIPT, str(tmp_path / "ref.npz"),
         str(tmp_path / "spec.json")],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(tmp_path / "ref.npz") as z:
        ref_t, ref_tri = torch.from_numpy(z["t"]), torch.from_numpy(z["tri"])
    scene = scene_from_dict(spec, device="cpu")
    hit = tst.make_stream_trace_fn(scene, tile_rays=TR, sc_clusters=1)(
        torch.from_numpy(o), torch.from_numpy(d))
    assert torch.equal(hit.tri, ref_tri.to(torch.int32))
    assert same_bits(hit.t, ref_t)  # the plain version: by its bits
    gen = np.random.default_rng(2)
    st = tst.build_stream_tables(tct.build_cluster_tables(scene), 1)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    pairs = tst.bin_stream_pairs(st, binning.tile_bounds(o, d, TR, None))
    t, tri = chunked_closest_hit(st.fused, st.tables.tri_id, o, d, *pairs, 1,
                                 TR, "fused", 1, gen)
    assert same_bits(t, ref_t) and torch.equal(tri, ref_tri.to(torch.int32))


_CLUSTER_REF_SCRIPT = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from crt_tpu.ops import pallas_trace as pt
from crt_tpu.scene.json_loader import scene_from_dict

spec = json.load(open(sys.argv[2]))
scene = scene_from_dict(spec["scene"], build_accel=False)
trace = pt.make_pallas_trace_fn(scene, interpret=True)
hit = jax.jit(trace)(jnp.asarray(spec["o"], jnp.float32),
                     jnp.asarray(spec["d"], jnp.float32))
np.savez(sys.argv[1], t=np.asarray(hit.t), tri=np.asarray(hit.tri))
"""


def test_negative_zero_cluster_backend_matches_crt_tpu(tmp_path):
    """The tie scene through the cluster backend: ``closest_hit_plain`` (by
    itself on bin_rays' lists, and through the trace factory) returns
    crt_tpu's binned closest hit bit for bit, A's -0.0 included, where a
    least over the walk positions could return B's +0.0."""
    from crt_tpu_torch.ops import cluster_trace as tct_trace

    spec, o, d = tie_scene_negzero()
    (tmp_path / "spec.json").write_text(json.dumps(
        {"scene": spec, "o": o.tolist(), "d": d.tolist()}))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX "
                         "--xla_cpu_multi_thread_eigen=false",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", _CLUSTER_REF_SCRIPT, str(tmp_path / "ref.npz"),
         str(tmp_path / "spec.json")],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(tmp_path / "ref.npz") as z:
        ref_t = torch.from_numpy(z["t"])
        ref_tri = torch.from_numpy(z["tri"]).to(torch.int32)
    assert torch.signbit(ref_t[1024:]).all() and (ref_tri == 16).all()
    scene = scene_from_dict(spec, device="cpu")
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    tables = tct.build_cluster_tables(scene)
    cl, cnt = binning.bin_rays(tables, o, d, 1024)
    assert cl[:, :2].tolist() == [[0, 1], [0, 1]] and cnt.tolist() == [2, 2]
    t, tri, _ = tct_trace.closest_hit_plain(tables, o, d, cl, cnt)
    assert same_bits(t, ref_t) and torch.equal(tri, ref_tri)
    hit = tct_trace.make_cluster_trace_fn(scene)(o, d)
    assert same_bits(hit.t, ref_t) and torch.equal(hit.tri, ref_tri)

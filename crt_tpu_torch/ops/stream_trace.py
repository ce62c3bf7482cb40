"""The streaming backend for large scenes: kernel wrappers and the factory.

Counterpart of the launch half of ``crt_tpu/ops/pallas_stream.py``:

  - ``closest_hit_stream`` (``csrc/stream_trace.cu``) replaces
    ``_make_f_kernel(occl=False)`` as launched by ``_launch_stream_kernel``
    on the fused table (K8), the same with ``lane_sc`` on the lane slab
    (K10) and ``_stream_kernel`` on the six row arrays (K11);
  - ``occlusion_stream`` (``csrc/stream_trace.cu``) replaces
    ``_make_f_kernel(occl=True)`` as launched by ``_launch_stream_occl``
    (K9, K10 with ``lane_sc``) and ``_stream_occl_kernel`` (K11);
  - ``closest_hit_stream_flat``, ``occluded_stream_flat`` and
    ``occluded_stream_twophase`` replace the functions of those names;
    ``StreamTracer`` replaces the trace of ``make_stream_trace_fn``, over
    any tables, and combines each launch's answer across the ranks that
    hold the other shards of a scene (``parallel/scene_sharded.py``);
    ``make_stream_trace_fn`` builds a scene's tables and its tracer.

The cluster backend tests every tile against every cluster; at a million
triangles that mask and its intermediates are GBs per trace.  Here Phase A
(``ops/stream_binning.py``) lists the (tile, supercluster) pairs that can
interact and the live member clusters of each, and the kernels walk, per
tile, that tile's range of the pair list over the table in one of three
layouts (``StreamTracer``'s ``layout``): "fused" [L, 16, 18],
"lane" [L2, 18, sc*16] (each supercluster's fused rows transposed) or
"rows" (the six cluster-major arrays).  The layouts change how the table is
read, never a result.  One launch serves any pair count: each tile's walk
is cut into chunks of at most ``chunk`` live members (``CHUNK_MEMBERS``),
``stream_items`` lists them on the device, and the kernels' blocks take
them longest tile first and combine the chunks of a tile (crt_tpu cuts its
launches at 16,384 pairs and carries the result across them).

Each wrapper launches its CUDA kernel for CUDA tensors (or raises) and
takes its plain PyTorch version only for CPU tensors.  The plain versions
expand the pair list to per-tile cluster lists (``pair_lists``) and walk
them with ``cluster_trace``'s plain walkers, so on a scene both backends
hold, streaming hits equal the cluster backend's bit for bit.
Each CUDA launch is counted in ``utils/trace.py``'s registry as
``crt.launches.closest_hit_stream.<layout>`` or
``crt.launches.occlusion_stream.<layout>``; the plain versions count
nothing.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from crt_tpu_torch.ops import stream_binning as sb
# benchmark/harness/spans.py wraps this name as Phase A
from crt_tpu_torch.ops.binning import tile_bounds  # noqa: F401
from crt_tpu_torch.ops.cluster_tables import (
    CLUSTER_SIZE,
    TILE_RAYS,
    ClusterTables,
    build_cluster_tables,
)
from crt_tpu_torch.ops.cluster_trace import (
    _check_rays,
    _check_tables,
    _cuda_stream,
    _raise_on,
    _require,
    closest_hit_plain,
    occlusion_d_plain,
    pad_rays,
)
from crt_tpu_torch.ops.intersect import Hit
from crt_tpu_torch.ops.tracer import Tracer
from crt_tpu_torch.utils import trace as tracing

LAYOUTS = ("fused", "lane", "rows")
_LAYOUT_CODE = {name: i for i, name in enumerate(LAYOUTS)}  # stream_trace.cu
# Live members of a tile's walk in one work item of the kernels (the
# wrappers' ``chunk=None``); chip_smoke.py sweeps it on the 1 M frame.
CHUNK_MEMBERS = 64


def _check_layout(layout: str) -> str:
    """``layout``; ValueError if unknown."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown stream layout {layout!r}")
    return layout


class StreamTables(NamedTuple):
    """What the streaming trace keeps per scene."""

    tables: ClusterTables  # cluster axis padded to a multiple of ``sc``
    sc_min: torch.Tensor  # [L2, 3] supercluster boxes
    sc_max: torch.Tensor
    fused: torch.Tensor  # [L, 16, 18] f32 (build_fused_table)
    sc: int  # clusters per supercluster
    lane: torch.Tensor | None = None  # [L2, 18, sc*16] f32 (lane_slab)


def lane_slab(fused, sc: int):
    """The lane layout: [L2, 18, sc*16], each supercluster's [sc*16, 18]
    fused rows transposed, contiguous (crt_tpu builds it the same way)."""
    L = fused.shape[0]
    return fused.reshape(L // sc, sc * CLUSTER_SIZE, 18).transpose(
        1, 2).contiguous()


@tracing.spanned("crt.tables.stream")
def build_stream_tables(tables: ClusterTables,
                        sc_clusters: int = sb.SC_CLUSTERS,
                        layout: str = "fused") -> StreamTables:
    """The scene's streaming tables; the lane slab too when ``layout`` is
    "lane"."""
    layout = _check_layout(layout)
    tables, sc_min, sc_max = sb.build_supercluster_boxes(tables, sc_clusters)
    fused = sb.build_fused_table(tables)
    lane = lane_slab(fused, sc_clusters) if layout == "lane" else None
    return StreamTables(tables, sc_min, sc_max, fused, sc_clusters, lane)


def layout_table(st: StreamTables, layout: str):
    """The table the kernels read in ``layout``: the fused table, the lane
    slab (built here when ``st`` was built without it) or the padded
    cluster tables."""
    if layout == "fused":
        return st.fused
    if layout == "lane":
        return st.lane if st.lane is not None else lane_slab(st.fused, st.sc)
    return st.tables


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def pair_lists(pair_sc, pair_bits, tile_start, sc: int):
    """The pair list as per-tile cluster lists -> (cluster_list [tiles, W]
    i32, counts [tiles] i32): each tile's pairs in list order, the set bits
    of a pair's member mask lowest first."""
    dev = pair_sc.device
    tiles = tile_start.shape[0] - 1
    per_tile = (tile_start[1:] - tile_start[:-1]).long()
    pair_tile = torch.repeat_interleave(
        torch.arange(tiles, device=dev), per_tile)
    member = ((pair_bits.long()[:, None] >> torch.arange(sc, device=dev)) & 1
              ).bool()  # [P, sc]
    p_idx, m_idx = torch.nonzero(member).unbind(dim=1)  # pair-major
    tile = pair_tile[p_idx]
    cluster = pair_sc.long()[p_idx] * sc + m_idx
    counts = torch.bincount(tile, minlength=tiles)
    width = max(int(counts.max()) if tiles else 0, 1)
    pos = torch.arange(tile.shape[0], device=dev) - (
        counts.cumsum(dim=0) - counts)[tile]
    cluster_list = torch.zeros((tiles, width), dtype=torch.int32, device=dev)
    cluster_list[tile, pos] = cluster.to(torch.int32)
    return cluster_list, counts.to(torch.int32)


def _walker_tables(table, tri_id, layout: str) -> ClusterTables:
    """The columns of ``table`` (in ``layout``) under the names the plain
    walkers read, cluster-major: the fused table's column slices, the lane
    slab transposed back to them, or the six row arrays."""
    if layout == "rows":
        return table._replace(tri_id=tri_id)
    if layout == "lane":
        table = table.transpose(1, 2).reshape(-1, CLUSTER_SIZE, 18)
    return ClusterTables(n=table[..., 0:3], nv0=table[..., 3],
                         m=table[..., 4:13], c=table[..., 13:16],
                         nobf=table[..., 16], tri_id=tri_id, cl_min=None,
                         cl_max=None, rank=None)


def closest_hit_stream_plain(table, tri_id, origins, dirs, pair_sc,
                             pair_bits, tile_start, sc: int,
                             tile_rays: int = TILE_RAYS,
                             layout: str = "fused"):
    """Plain version of ``closest_hit_stream`` -> (t [R], tri [R])."""
    cluster_list, counts = pair_lists(pair_sc, pair_bits, tile_start, sc)
    t, tri, _ = closest_hit_plain(_walker_tables(table, tri_id, layout),
                                  origins, dirs, cluster_list, counts,
                                  tile_rays=tile_rays)
    return t, tri


def occlusion_stream_plain(table, origins, dirs, r2, seed, pair_sc,
                           pair_bits, tile_start, sc: int,
                           tile_rays: int = TILE_RAYS, layout: str = "fused"):
    """Plain version of ``occlusion_stream`` -> blocked [R] bool."""
    cluster_list, counts = pair_lists(pair_sc, pair_bits, tile_start, sc)
    return occlusion_d_plain(_walker_tables(table, None, layout), origins,
                             dirs, r2, cluster_list, counts, tile_rays,
                             seed=seed)


# ---------------------------------------------------------------------------
# Work items of the kernels
# ---------------------------------------------------------------------------

class StreamItems(NamedTuple):
    """The kernels' work items: chunk c of work tile w covers members
    [pair_off[tile_start[w // groups]] + c * chunk, + chunk) of the walk of
    tile w // groups (clipped to the tile's end), for the tile's lane group
    w % groups.  Item i is chunk i - item_end[pos - 1] of work tile
    order[pos], pos the first with item_end[pos] > i."""

    order: torch.Tensor  # [wtiles] i32, the work tiles longest walk first
    item_end: torch.Tensor  # [wtiles] i32, inclusive prefix of their chunks
    pair_off: torch.Tensor  # [P + 1] i32, live members before each pair
    groups: int  # work tiles per tile
    chunk: int  # live members per item at most


def stream_items(pair_bits, tile_start, chunk: int,
                 groups: int = 1) -> StreamItems:
    """The work items of a launch, on the device, with no host read."""
    dev = pair_bits.device
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    live = ((pair_bits[:, None] >> shifts) & 1).sum(dim=1)
    pair_off = torch.zeros((pair_bits.shape[0] + 1,), dtype=torch.int32,
                           device=dev)
    pair_off[1:] = live.cumsum(dim=0)
    walk = pair_off[tile_start.long()]
    n = (walk[1:] - walk[:-1]).repeat_interleave(groups)  # per work tile
    order = torch.argsort(n, descending=True, stable=True)
    item_end = torch.div(n + (chunk - 1), chunk, rounding_mode="floor")[
        order].cumsum(dim=0).to(torch.int32)
    return StreamItems(order.to(torch.int32), item_end, pair_off, groups,
                       chunk)


def _max_items(tiles: int, pairs: int, items: StreamItems) -> int:
    """A bound on the item count that the host knows: each work tile has
    at most one partial chunk, and a tile's walk at most 32 members a
    pair."""
    return (tiles * items.groups
            + items.groups * pairs * -(-32 // items.chunk))


def _check_chunk(chunk) -> int:
    """``chunk``, or ``CHUNK_MEMBERS`` when None; ValueError unless >= 1."""
    chunk = CHUNK_MEMBERS if chunk is None else chunk
    _require(isinstance(chunk, int) and chunk >= 1,
             "chunk must be a positive int")
    return chunk


def _items_for(pair_bits, tile_start, tile_rays: int, chunk: int):
    """The launch's items: a work tile is 256 lanes, a kernel block."""
    return stream_items(pair_bits, tile_start, chunk, tile_rays // 256)


def _item_ptrs(items: StreamItems, nxt) -> list:
    return [items.order.data_ptr(), items.item_end.data_ptr(),
            items.pair_off.data_ptr(), nxt.data_ptr()]


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_table(table, layout: str, sc: int, dev) -> int:
    """Check the streamed table of ``layout``; return its cluster count."""
    _require(layout in LAYOUTS, f"unknown stream layout {layout!r}")
    _require(1 <= sc <= 32, "sc must be in 1..32")
    if layout == "rows":
        _check_tables(table, dev)
        L = table.n.shape[0]
    else:
        shape = ((CLUSTER_SIZE, 18) if layout == "fused"
                 else (18, sc * CLUSTER_SIZE))
        _require(table.device == dev and table.dtype == torch.float32
                 and table.is_contiguous() and table.dim() == 3
                 and tuple(table.shape[1:]) == shape,
                 f"the {layout} table must be a contiguous float32 "
                 f"[*, {shape[0]}, {shape[1]}] on {dev}")
        L = table.shape[0] * (sc if layout == "lane" else 1)
    _require(L % sc == 0, "the cluster count must be a multiple of sc")
    return L


def _table_ptrs(table, layout: str) -> list:
    """The five table pointers of csrc/stream_trace.cu's host entries."""
    if layout == "rows":
        return [table.n.data_ptr(), table.nv0.data_ptr(), table.m.data_ptr(),
                table.c.data_ptr(), table.nobf.data_ptr()]
    return [table.data_ptr(), None, None, None, None]


def _check_pairs(pair_sc, pair_bits, tile_start, tiles, dev):
    P = pair_sc.shape[0]
    for name, x in (("pair_sc", pair_sc), ("pair_bits", pair_bits)):
        _require(x.device == dev and x.dtype == torch.int32
                 and x.is_contiguous() and tuple(x.shape) == (P,),
                 f"{name} must be a contiguous int32 [{P}] on {dev}")
    _require(tile_start.device == dev and tile_start.dtype == torch.int32
             and tile_start.is_contiguous()
             and tuple(tile_start.shape) == (tiles + 1,),
             f"tile_start must be a contiguous int32 [{tiles + 1}] on {dev}")


def closest_hit_stream(table, tri_id, origins, dirs, pair_sc, pair_bits,
                       tile_start, sc: int, tile_rays: int = TILE_RAYS,
                       layout: str = "fused", chunk: int | None = None):
    """K8 (fused), K10 (lane), K11 (rows): closest hit of each ray over its
    tile's pairs.

    table: in ``layout`` (``LAYOUTS``), the fused table [L, 16, 18] f32,
    the lane slab [L / sc, 18, sc * 16] f32 (``lane_slab``) or the padded
    ``ClusterTables`` (rows); tri_id [L, 16] i32, L a multiple of ``sc``;
    origins, dirs [R, 3] f32 with R % tile_rays == 0; pair_sc, pair_bits
    [P] i32 (supercluster index and member mask of each pair, tile-major);
    tile_start [tiles + 1] i32 with tile_start[-1] == P.
    Returns (t [R] f32, tri [R] i32); +inf and -1 where nothing is hit.
    The three layouts give the same bits.  ``layout`` names the form of
    ``table``.  ``chunk`` (None: ``CHUNK_MEMBERS``) is the kernel's item
    length in live members; it changes no bit, and the plain version has
    no use for it.
    """
    dev = origins.device
    R = origins.shape[0]
    _require(tile_rays > 0 and R % tile_rays == 0,
             f"R must be a multiple of {tile_rays}")
    tiles = R // tile_rays
    _check_rays("origins", origins, dev, R)
    _check_rays("dirs", dirs, dev, R)
    L = _check_table(table, layout, sc, dev)
    _check_pairs(pair_sc, pair_bits, tile_start, tiles, dev)
    _require(tri_id.device == dev and tri_id.dtype == torch.int32
             and tri_id.is_contiguous()
             and tuple(tri_id.shape) == (L, CLUSTER_SIZE),
             f"tri_id must be a contiguous int32 [{L}, 16] beside the table")
    chunk = _check_chunk(chunk)

    if dev.type == "cpu":
        return closest_hit_stream_plain(table, tri_id, origins, dirs, pair_sc,
                                        pair_bits, tile_start, sc, tile_rays,
                                        layout)
    if dev.type != "cuda":
        raise NotImplementedError(
            f"closest_hit_stream has no kernel for {dev}")
    _require(tile_rays % 256 == 0, "the kernel takes 256-lane blocks")

    from crt_tpu_torch.ops import cuda_lib

    lib, _ = cuda_lib.load()
    best_t = torch.empty((R,), dtype=torch.float32, device=dev)
    best_tri = torch.empty((R,), dtype=torch.int32, device=dev)
    if tiles:
        items = _items_for(pair_bits, tile_start, tile_rays, chunk)
        nxt = torch.zeros((1,), dtype=torch.int32, device=dev)
        key = torch.full((R,), -1, dtype=torch.int64, device=dev)  # no hit
        with torch.cuda.device(dev):
            err = lib.crt_closest_hit_stream(
                origins.data_ptr(), dirs.data_ptr(), _LAYOUT_CODE[layout],
                *_table_ptrs(table, layout), tri_id.data_ptr(),
                pair_sc.data_ptr(), pair_bits.data_ptr(),
                tile_start.data_ptr(), *_item_ptrs(items, nxt), sc, tiles,
                tile_rays, items.groups, items.chunk,
                _max_items(tiles, pair_sc.shape[0], items), key.data_ptr(),
                best_t.data_ptr(), best_tri.data_ptr(), _cuda_stream(dev),
            )
        _raise_on(err, "closest_hit_stream")
        tracing.count("crt.launches.closest_hit_stream." + layout)
    return best_t, best_tri


def occlusion_stream(table, origins, dirs, r2, seed, pair_sc, pair_bits,
                     tile_start, sc: int, tile_rays: int = TILE_RAYS,
                     layout: str = "fused", chunk: int | None = None):
    """K9 (fused), K10 (lane), K11 (rows): any-hit occlusion of each ray
    over its tile's pairs.

    Arguments as ``closest_hit_stream`` (no ids: the rows layout's tri_id
    is not passed to the kernel), with r2 [R] f32 (squared reach) and seed
    [R] bool: a lane starts, and a lane of a tile without pairs stays, at
    its seed (True on lanes whose answer nothing consumes, so they never
    hold a tile's walk open).  Returns blocked [R] bool.  ``chunk`` as in
    ``closest_hit_stream``.
    """
    dev = origins.device
    R = origins.shape[0]
    _require(tile_rays > 0 and R % tile_rays == 0,
             f"R must be a multiple of {tile_rays}")
    tiles = R // tile_rays
    _check_rays("origins", origins, dev, R)
    _check_rays("dirs", dirs, dev, R)
    _check_table(table, layout, sc, dev)
    _check_pairs(pair_sc, pair_bits, tile_start, tiles, dev)
    _require(r2.device == dev and r2.dtype == torch.float32
             and r2.is_contiguous() and tuple(r2.shape) == (R,),
             f"r2 must be a contiguous float32 [{R}] on {dev}")
    _require(seed.device == dev and seed.dtype == torch.bool
             and seed.is_contiguous() and tuple(seed.shape) == (R,),
             f"seed must be a contiguous bool [{R}] on {dev}")
    chunk = _check_chunk(chunk)

    if dev.type == "cpu":
        return occlusion_stream_plain(table, origins, dirs, r2, seed,
                                      pair_sc, pair_bits, tile_start, sc,
                                      tile_rays, layout)
    if dev.type != "cuda":
        raise NotImplementedError(f"occlusion_stream has no kernel for {dev}")
    _require(tile_rays % 256 == 0, "the kernel takes 256-lane blocks")

    from crt_tpu_torch.ops import cuda_lib

    lib, _ = cuda_lib.load()
    occ = seed.clone()  # the kernel ORs the hits in
    if tiles:
        items = _items_for(pair_bits, tile_start, tile_rays, chunk)
        nxt = torch.zeros((1,), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            err = lib.crt_occlusion_stream(
                origins.data_ptr(), dirs.data_ptr(), r2.data_ptr(),
                _LAYOUT_CODE[layout], *_table_ptrs(table, layout),
                pair_sc.data_ptr(), pair_bits.data_ptr(),
                tile_start.data_ptr(), *_item_ptrs(items, nxt), sc, tiles,
                tile_rays, items.groups, items.chunk,
                _max_items(tiles, pair_sc.shape[0], items), occ.data_ptr(),
                _cuda_stream(dev),
            )
        _raise_on(err, "occlusion_stream")
        tracing.count("crt.launches.occlusion_stream." + layout)
    return occ


# ---------------------------------------------------------------------------
# Phase A + kernel
# ---------------------------------------------------------------------------

def _boxes(st: StreamTables):
    """The supercluster and cluster boxes ``sb.bin_stream`` bins against."""
    return st.sc_min, st.sc_max, st.tables.cl_min, st.tables.cl_max


def bin_stream_pairs(st: StreamTables, bounds, apex=None, apex_slack=0.0,
                     **bin_kw):
    """The plain Phase A lists of a wavefront's ``tile_bounds`` ->
    (pair_sc [P] i32, pair_bits [P] i32, tile_start [tiles + 1] i32), the
    kernels' list arguments (``sb.pair_list``)."""
    return sb.pair_list(*_boxes(st), bounds, apex, apex_slack, **bin_kw)


def closest_hit_stream_flat(st: StreamTables, origins, dirs, active=None,
                            tile_rays: int = TILE_RAYS,
                            layout: str = "fused"):
    """Streaming closest hit of a flat wavefront (R % tile_rays == 0) over
    the table in ``layout``.
    Returns (Hit, number of pairs)."""
    layout = _check_layout(layout)
    with tracing.span("crt.binning"):
        pair_sc, bits, tile_start = sb.bin_stream(*_boxes(st), origins, dirs,
                                                  tile_rays, active)
    t, tri = closest_hit_stream(layout_table(st, layout), st.tables.tri_id,
                                origins, dirs, pair_sc, bits, tile_start,
                                st.sc, tile_rays, layout)
    return Hit(t=t, tri=tri), pair_sc.shape[0]


def occluded_stream_flat(st: StreamTables, origins, dirs, r2, active, apex,
                         apex_slack, tile_rays: int = TILE_RAYS,
                         per_tile_cap: int | None = None,
                         lane_exact: bool = True,
                         layout: str = "fused"):
    """Streaming any-hit occlusion of a point-light shadow wavefront ->
    blocked [R] bool over the table in ``layout``.  ``apex`` [tiles, 3] is
    each tile's light.  Pairs come nearest first.  A complete walk
    (``per_tile_cap`` None) admits a pair only if some lane's own segment
    reaches the supercluster (``lane_exact_sc_mask`` over the shaft hull's
    survivors); a truncated one skips that test, its list being short
    anyway.  Lanes outside
    ``active`` return True."""
    layout = _check_layout(layout)
    with tracing.span("crt.binning"):
        pair_sc, bits, tile_start = sb.bin_stream(
            *_boxes(st), origins, dirs, tile_rays, active, apex, apex_slack,
            r2, per_tile_cap, lane_exact)
    seed = (torch.zeros(r2.shape, dtype=torch.bool, device=r2.device)
            if active is None else ~active)
    return occlusion_stream(layout_table(st, layout), origins, dirs, r2, seed,
                            pair_sc, bits, tile_start, st.sc, tile_rays,
                            layout)


def occluded_stream_twophase(st: StreamTables, shadow_o, light_dirs, r2,
                             light_positions, active, origin_slack,
                             tile_rays: int = TILE_RAYS, phase1_k: int = 8,
                             lane_exact: bool = True,
                             layout: str = "fused", combine=None):
    """Two-phase streaming shadow occlusion -> [Ll, R] bool.

    Phase 1 walks only each tile's ``phase1_k`` nearest superclusters.
    Phase 2 moves the lanes that are active and still unblocked to the
    front of each light's row (a stable sort, so they stay in pixel-tile
    order and each row keeps its light) and walks their complete lists:
    tiles, and so pairs, shrink to what is left.  Exact: every lane phase
    1 left open gets a complete walk.

    shadow_o [R, 3] per-pixel origins shared by the lights; light_dirs
    [Ll, R, 3]; r2, active [Ll, R]; light_positions [Ll, 3].  Both phases
    read the table in ``layout``.
    ``combine`` ([Ll, R] bool -> [Ll, R] bool) merges each phase's bits
    with the other shards' before they are used: phase 1's before the
    compaction, so every shard walks the same survivors in phase 2.
    """
    layout = _check_layout(layout)
    Ll, R = r2.shape
    tpl = R // tile_rays
    apex = light_positions.repeat_interleave(tpl, dim=0)
    occ1 = occluded_stream_flat(
        st, shadow_o.expand(Ll, R, 3).reshape(-1, 3).contiguous(),
        light_dirs.reshape(-1, 3).contiguous(), r2.reshape(-1).contiguous(),
        active.reshape(-1), apex, origin_slack, tile_rays,
        per_tile_cap=phase1_k, layout=layout).reshape(Ll, R)
    if combine is not None:
        occ1 = combine(occ1)

    surv = active & ~occ1
    perm = torch.argsort((~surv).to(torch.uint8), dim=1, stable=True)
    occ2 = occluded_stream_flat(
        st, shadow_o[perm].reshape(-1, 3),
        torch.gather(light_dirs, 1, perm[..., None].expand(Ll, R, 3)
                     ).reshape(-1, 3),
        torch.gather(r2, 1, perm).reshape(-1),
        torch.gather(surv, 1, perm).reshape(-1), apex, origin_slack,
        tile_rays, lane_exact=lane_exact, layout=layout).reshape(Ll, R)
    if combine is not None:
        occ2 = combine(occ2)
    occ2_back = torch.empty_like(occ2).scatter_(1, perm, occ2)
    return occ1 | (occ2_back & surv)


class StreamTracer(Tracer):
    """The streaming backend ("pallas_stream") over ``tables``.

    Rays are padded to a tile multiple of ``tile_rays`` with direction
    (0, 0, -1) and inactive lanes.  ``shadow`` is the point-light shadow
    pass, binned by the light-side shaft against supercluster and member
    boxes, for a flat wavefront of whole tiles (any other is the generic
    closest hit and a compare); ``shadow_k`` is the phase-1 depth of its
    two-phase resolve (``RenderSettings.stream_shadow_k``; 0 walks every
    list in one phase).  The tracer emits no packed rows: shading gathers
    them.  Every launch reads the table in ``layout``; only the lane
    layout builds its slab.  ``combine_hits`` (Hit -> Hit) and
    ``combine_bits`` (occlusion bits -> bits) merge each launch's answer
    with those of the other shards of a partitioned scene; the shadow
    pass's two phases are merged one by one (``occluded_stream_twophase``).
    """

    def __init__(self, tables: ClusterTables, tile_rays: int | None = None,
                 sc_clusters: int = sb.SC_CLUSTERS, shadow_k: int = 2,
                 layout: str = "fused", combine_hits=None,
                 combine_bits=None):
        self.tile_rays = tile_rays or TILE_RAYS
        self.shadow_k = shadow_k
        self.layout = _check_layout(layout)
        self.combine_hits = combine_hits
        self.combine_bits = combine_bits
        self.st = build_stream_tables(tables, sc_clusters, self.layout)
        self.rank = tables.rank

    def __call__(self, origins, dirs, active=None) -> Hit:
        batch_shape = origins.shape[:-1]
        R = origins[..., 0].numel()
        o, d, a = pad_rays(origins.detach().reshape(-1, 3),
                           dirs.detach().reshape(-1, 3), active,
                           self.tile_rays, pad_all_active=True)
        hit, _ = closest_hit_stream_flat(self.st, o, d, a, self.tile_rays,
                                         layout=self.layout)
        hit = Hit(t=hit.t[:R].reshape(batch_shape),
                  tri=hit.tri[:R].reshape(batch_shape))
        return hit if self.combine_hits is None else self.combine_hits(hit)

    def shadow(self, point, shadow_o, light_positions, light_dirs, r2,
               active, origin_slack):
        tile_rays = self.tile_rays
        if point.dim() != 2 or r2.shape[1] % tile_rays:
            return super().shadow(point, shadow_o, light_positions,
                                  light_dirs, r2, active, origin_slack)
        Ll, R = r2.shape
        shadow_o = shadow_o.detach()
        light_dirs = light_dirs.detach()
        r2 = r2.detach()
        light_positions = light_positions.detach()
        if self.shadow_k > 0:
            return occluded_stream_twophase(
                self.st, shadow_o, light_dirs, r2, light_positions, active,
                origin_slack, tile_rays, phase1_k=self.shadow_k,
                layout=self.layout, combine=self.combine_bits)
        apex = light_positions.repeat_interleave(R // tile_rays, dim=0)
        occ = occluded_stream_flat(
            self.st, shadow_o.expand(Ll, R, 3).reshape(-1, 3).contiguous(),
            light_dirs.reshape(-1, 3).contiguous(),
            r2.reshape(-1).contiguous(), active.reshape(-1), apex,
            origin_slack, tile_rays, layout=self.layout).reshape(Ll, R)
        return occ if self.combine_bits is None else self.combine_bits(occ)


def make_stream_trace_fn(scene, **kw) -> StreamTracer:
    """The streaming backend of ``scene``: its cluster tables built, and
    ``StreamTracer(tables, **kw)``."""
    return StreamTracer(build_cluster_tables(scene), **kw)

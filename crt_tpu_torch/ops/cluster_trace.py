"""The binned cluster trace: kernel wrappers and the tracer.

Counterpart of the launch half of ``crt_tpu/ops/pallas_trace.py``:

  - ``closest_hit`` (K1, ``csrc/closest_hit.cu``) replaces
    ``_trace_kernel`` / ``_trace_tile_body`` as launched by
    ``_closest_hit_binned``, with emitted packed rows;
  - ``closest_hit_compact`` (K4, ``csrc/closest_hit.cu``) replaces
    ``_trace_kernel_compact`` as launched by
    ``_closest_hit_binned_compact``: K1 over the live tiles, whose list
    ``live_tiles`` builds on the device;
  - ``closest_hit_merged`` (K7, ``csrc/closest_hit.cu``) replaces
    ``_trace_kernel_merged`` as launched by ``_closest_hit_binned_merged``:
    K1 with ``merge`` tiles per block;
  - ``occlusion_w`` (K2, ``csrc/occlusion_w.cu``) replaces
    ``_occl_kernel_compact_w`` as launched by
    ``_occluded_binned_compact_w``, in its capped, ``capped=False``,
    member-masked and glass-flag modes;
  - ``occlusion_d`` (K5 and K6, ``csrc/occlusion_d.cu``) replaces
    ``_occl_kernel_compact`` as launched by ``_occluded_binned_compact``
    (direction-form any-hit over the live tiles, ``tile_mod`` origins) and,
    with ``exit=True``, ``_occlusion_kernel`` as launched by
    ``occluded_pallas_flat`` (the same test seeded with the inactive
    lanes, leaving a tile once all its lanes are blocked);
  - ``ClusterTracer`` replaces the trace of ``make_pallas_trace_fn``, over
    any tables (a rank's shard of them, ``parallel/scene_sharded.py``);
    ``make_cluster_trace_fn`` builds a scene's tables and its tracer.

Each wrapper launches its CUDA kernel for CUDA tensors (or raises) and
takes its plain PyTorch version, in this module, only for CPU tensors.
The plain versions walk the same lists in the same order with the same
arithmetic, so on the card the kernels must match them bit for bit.
Each CUDA launch is counted in ``utils/trace.py``'s registry as
``crt.launches.closest_hit`` / ``closest_hit_compact`` /
``closest_hit_merged`` / ``live_tiles``, ``crt.launches.occlusion_w.<mode>``
(``occlusion_mode``) and ``crt.launches.occlusion_d.<compact|exit>``; the
plain versions count nothing.
"""

from __future__ import annotations

import torch

from crt_tpu_torch.ops.binning import bin_apex_shared, bin_rays
from crt_tpu_torch.ops.cluster_tables import (
    CLUSTER_SIZE,
    TILE_RAYS,
    ClusterTables,
    build_cluster_tables,
    emit_rows_table,
    glass_subset,
)
from crt_tpu_torch.ops.intersect import PARALLEL_EPS, Hit
from crt_tpu_torch.ops.tracer import Tracer
from crt_tpu_torch.utils import trace as tracing

_BIGID = 2**30

# Tiles per step of the plain versions, and elements of one of their
# [tiles, positions, 16, TR] temporaries: a step takes as many walk
# positions as keep it within _PLAIN_ELEMS (at least one), which bounds
# the temporaries (~64 MB each for 1024 tiles of 1024 rays) and lets a
# walk over a few tiles take many positions per step.
_PLAIN_TILE_CHUNK = 1024
_PLAIN_ELEMS = 1 << 22


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _member_hit(tables: ClusterTables, cl, ox, oy, oz, dx, dy, dz):
    """([nt, p, 16, TR] hit at t >= 0, its t) of every member of clusters
    ``cl`` ([nt, p]) for the rays of each tile (components [nt, 1, 1, TR]).
    The op order of the kernels' member test (csrc/cluster_common.cuh)."""
    n = tables.n[cl]  # [nt, p, 16, 3]
    nx, ny, nz = n[..., 0:1], n[..., 1:2], n[..., 2:3]
    nd = nx * dx + ny * dy + nz * dz
    no = nx * ox + ny * oy + nz * oz
    opd = tables.nv0[cl][..., None] - no
    not_parallel = nd.abs() >= PARALLEL_EPS
    face_ok = (opd < 0.0) | (tables.nobf[cl][..., None] > 0.5)
    t = opd / torch.where(not_parallel, nd, torch.ones_like(nd))
    valid = not_parallel & face_ok & (t >= 0.0)
    m = tables.m[cl]
    c = tables.c[cl]
    for e in range(3):
        mx, my, mz = m[..., 3 * e:3 * e + 1], m[..., 3 * e + 1:3 * e + 2], \
            m[..., 3 * e + 2:3 * e + 3]
        md = mx * dx + my * dy + mz * dz
        mo = mx * ox + my * oy + mz * oz
        valid = valid & ((mo - c[..., e:e + 1]) + t * md >= 0.0)
    return valid, t


def _member_t(tables: ClusterTables, cl, ox, oy, oz, dx, dy, dz):
    """[nt, p, 16, TR] hit distance of every member; +inf where not hit."""
    valid, t = _member_hit(tables, cl, ox, oy, oz, dx, dy, dz)
    return torch.where(valid, t, torch.full_like(t, float("inf")))


def _planes(x, nt, tile_rays=TILE_RAYS):
    """[nt*TR, 3] -> three [nt, 1, 1, TR] component planes."""
    x = x.reshape(nt, 1, 1, tile_rays, 3)
    return x[..., 0], x[..., 1], x[..., 2]


def _steps(width: int, nt: int, tile_rays: int):
    """The walk positions [0, width) in steps of as many positions as keep
    a [nt, p, 16, TR] temporary within _PLAIN_ELEMS."""
    p = max(1, _PLAIN_ELEMS // max(1, nt * CLUSTER_SIZE * tile_rays))
    return [(i, min(i + p, width)) for i in range(0, width, p)]


def closest_hit_plain(tables: ClusterTables, origins, dirs, cluster_list,
                      counts, rows_table=None, tile_rays: int = TILE_RAYS):
    """Plain version of ``closest_hit``: loop over steps of walk positions,
    vectorized over tiles x positions x 16 members x rays.  Across
    positions the first one with the least t wins, which is the kernel's
    strict ``<`` in walk order.  t is always the winner's own value (a
    gather, never a reduction's least), so on a tie of -0.0 with +0.0 the
    zero of the member that won is returned, as the kernel returns it."""
    R = origins.shape[0]
    tiles = R // tile_rays
    dev = origins.device
    best_t = torch.full((tiles, tile_rays), float("inf"), device=dev)
    best_tri = torch.full((tiles, tile_rays), -1, dtype=torch.int32,
                          device=dev)
    best_slot = torch.full((tiles, tile_rays), -1, dtype=torch.int64,
                           device=dev)
    for s in range(0, tiles, _PLAIN_TILE_CHUNK):
        e = min(s + _PLAIN_TILE_CHUNK, tiles)
        nt = e - s
        ox, oy, oz = _planes(origins[s * tile_rays:e * tile_rays], nt,
                             tile_rays)
        dx, dy, dz = _planes(dirs[s * tile_rays:e * tile_rays], nt,
                             tile_rays)
        cnt = counts[s:e]
        bt, btri, bslot = best_t[s:e], best_tri[s:e], best_slot[s:e]
        width = int(cnt.max()) if nt else 0
        for i0, i1 in _steps(width, nt, tile_rays):
            live = cnt[:, None] > torch.arange(i0, i1, device=dev)  # [nt, p]
            cl = cluster_list[s:e, i0:i1].long()
            tt = _member_t(tables, cl, ox, oy, oz, dx, dy, dz)
            tid = tables.tri_id[cl][..., None]  # [nt, p, 16, 1]
            at_best = tt <= tt.amin(dim=2, keepdim=True)
            cl_tri = torch.where(at_best, tid, _BIGID).amin(dim=2)
            # the winning member: the one whose (t, id) won the reduction;
            # its own t, so a -0.0 that won a tie with +0.0 stays -0.0
            win = (at_best & (tid == cl_tri[:, :, None])).to(
                torch.int32).argmax(dim=2, keepdim=True)  # [nt, p, 1, TR]
            cl_best = tt.gather(2, win)[:, :, 0]  # [nt, p, TR]
            slot = cl[..., None] * CLUSTER_SIZE + win[:, :, 0]
            # the step's first position with its least t (its own t), then
            # the strict < against the walk so far
            cl_best = torch.where(live[..., None], cl_best, float("inf"))
            first = (cl_best == cl_best.amin(dim=1, keepdim=True)).to(
                torch.int32).argmax(dim=1, keepdim=True)
            least = cl_best.gather(1, first)[:, 0]  # [nt, TR]
            better = least < bt
            bt = torch.where(better, least, bt)
            btri = torch.where(better, cl_tri.gather(1, first)[:, 0], btri)
            bslot = torch.where(better, slot.gather(1, first)[:, 0], bslot)
        best_t[s:e], best_tri[s:e], best_slot[s:e] = bt, btri, bslot

    rows = None
    if rows_table is not None:
        kp = rows_table.shape[-1]
        flat = rows_table.reshape(-1, kp)
        slot = best_slot.reshape(-1)
        rows = torch.where((slot >= 0)[:, None], flat[slot.clamp(min=0)],
                           torch.zeros((), device=dev)).T.contiguous()
    return best_t.reshape(-1), best_tri.reshape(-1), rows


def live_tiles_plain(counts):
    """Plain version of ``live_tiles``: the stable argsort of the dead
    flags, as crt_tpu's ``_closest_hit_binned_compact`` orders its tiles,
    -> (tile_ids [tiles] i32, n_live [1] i32)."""
    live = counts > 0
    order = torch.argsort((~live).to(torch.int32), stable=True)
    return (order.to(torch.int32),
            live.sum(dtype=torch.int32).reshape(1))


def closest_hit_compact_plain(tables: ClusterTables, origins, dirs,
                              cluster_list, counts, rows_table=None,
                              tile_mod: int = 0):
    """Plain version of ``closest_hit_compact``: the live tiles (counts >
    0) are gathered to the front, walked by ``closest_hit_plain``, and
    scattered back over a miss-filled result.  ``origins`` holds
    ``tile_mod`` tiles when ``tile_mod`` is given, and tile i reads origin
    tile i % tile_mod."""
    tiles = counts.shape[0]
    dev = dirs.device
    R = tiles * TILE_RAYS
    order, n_live = live_tiles_plain(counts)
    n_live = int(n_live)
    ids = order[:n_live].long()
    o_ids = ids % tile_mod if tile_mod else ids
    lanes = torch.arange(TILE_RAYS, device=dev)
    t = torch.full((R,), float("inf"), device=dev)
    tri = torch.full((R,), -1, dtype=torch.int32, device=dev)
    rows = None
    if rows_table is not None:
        rows = torch.zeros((rows_table.shape[-1], R), device=dev)
    if n_live:
        r = (ids[:, None] * TILE_RAYS + lanes).reshape(-1)
        r_o = (o_ids[:, None] * TILE_RAYS + lanes).reshape(-1)
        lt, ltri, lrows = closest_hit_plain(
            tables, origins[r_o], dirs[r], cluster_list[ids], counts[ids],
            rows_table)
        t[r], tri[r] = lt, ltri
        if rows is not None:
            rows[:, r] = lrows
    return t, tri, rows


def closest_hit_merged_plain(tables: ClusterTables, origins, dirs,
                             cluster_list, counts, rows_table=None,
                             merge: int = 2):
    """Plain version of ``closest_hit_merged``: group g walks its sub-tiles
    g*merge + sub, sub = 0 .. merge-1, in turn, each list as
    ``closest_hit_plain`` walks it; here the step ``sub`` of every group is
    one call, vectorized over the groups."""
    tiles = counts.shape[0]
    _require(merge >= 1 and tiles % merge == 0,
             f"the tile count {tiles} must divide by merge={merge}")
    dev = origins.device
    R = tiles * TILE_RAYS
    t = torch.empty((R,), device=dev)
    tri = torch.empty((R,), dtype=torch.int32, device=dev)
    rows = (None if rows_table is None else
            torch.empty((rows_table.shape[-1], R), device=dev))
    lanes = torch.arange(TILE_RAYS, device=dev)
    for sub in range(merge):
        ids = torch.arange(sub, tiles, merge, device=dev)  # one per group
        r = (ids[:, None] * TILE_RAYS + lanes).reshape(-1)
        st, stri, srows = closest_hit_plain(
            tables, origins[r], dirs[r], cluster_list[ids], counts[ids],
            rows_table)
        t[r], tri[r] = st, stri
        if rows is not None:
            rows[:, r] = srows
    return t, tri, rows


def occlusion_w_plain(tables: ClusterTables, shadow_o, point, light_positions,
                      cluster_list, counts, capped: bool = True,
                      member_mask=None, glass_flag: bool = False):
    """Plain version of ``occlusion_w`` with the same mode arguments: loop
    over steps of walk positions, vectorized over tiles x positions x 16
    members x lanes."""
    tpl = shadow_o.shape[0] // TILE_RAYS
    tiles = counts.shape[0]
    dev = shadow_o.device
    o_tiles = shadow_o.reshape(tpl, TILE_RAYS, 3)
    p_tiles = point.reshape(tpl, TILE_RAYS, 3)
    blocked = torch.zeros((tiles, TILE_RAYS), dtype=torch.bool, device=dev)
    glass = torch.zeros_like(blocked) if glass_flag else None
    for s in range(0, tiles, _PLAIN_TILE_CHUNK):
        e = min(s + _PLAIN_TILE_CHUNK, tiles)
        nt = e - s
        idx = torch.arange(s, e, device=dev)
        ox, oy, oz = _planes(o_tiles[idx % tpl], nt)
        px, py, pz = _planes(p_tiles[idx % tpl], nt)
        apex = light_positions[idx // tpl][:, None, None, None]  # [nt,...,3]
        wx = apex[..., 0] - px
        wy = apex[..., 1] - py
        wz = apex[..., 2] - pz
        cnt = counts[s:e]
        blk = blocked[s:e]
        gls = glass[s:e] if glass_flag else None
        width = int(cnt.max()) if nt else 0
        for i0, i1 in _steps(width, nt, TILE_RAYS):
            live = (cnt[:, None] > torch.arange(i0, i1, device=dev)
                    )[..., None]  # [nt, p, 1]
            cl = cluster_list[s:e, i0:i1].long()
            base, tt = _member_hit(tables, cl, ox, oy, oz, wx, wy, wz)
            in_subset = None
            if member_mask is not None:
                in_subset = (member_mask[cl] > 0.5)[..., None]  # [nt,p,16,1]
            if in_subset is not None and not glass_flag:
                base = base & in_subset
            hit = base & (tt <= 1.0) if capped else base
            blk = blk | (hit.any(dim=2) & live).any(dim=1)
            if glass_flag:
                gls = gls | ((base & in_subset).any(dim=2) & live).any(dim=1)
        blocked[s:e] = blk
        if glass_flag:
            glass[s:e] = gls
    if glass_flag:
        return blocked.reshape(-1), glass.reshape(-1)
    return blocked.reshape(-1)


def occlusion_d_plain(tables: ClusterTables, origins, dirs, r2, cluster_list,
                      counts, tile_rays: int = TILE_RAYS, tile_mod: int = 0,
                      seed=None):
    """Plain version of ``occlusion_d`` (and, on the lists of
    ``stream_trace.pair_lists``, of the streaming any-hit): per lane the OR,
    over the members of its tile's list, of "hit at t >= 0 with t * t <=
    r2", started from ``seed`` ([R] bool) where one is given.  The kernels'
    early exits change no lane, so there is nothing of them here."""
    tiles = counts.shape[0]
    dev = dirs.device
    o_tiles = origins.reshape(-1, tile_rays, 3)
    d_tiles = dirs.reshape(tiles, tile_rays, 3)
    r2_tiles = r2.reshape(tiles, 1, 1, tile_rays)
    blocked = (torch.zeros((tiles, tile_rays), dtype=torch.bool, device=dev)
               if seed is None else seed.reshape(tiles, tile_rays).clone())
    for s in range(0, tiles, _PLAIN_TILE_CHUNK):
        e = min(s + _PLAIN_TILE_CHUNK, tiles)
        nt = e - s
        idx = torch.arange(s, e, device=dev)
        ox, oy, oz = _planes(o_tiles[idx % tile_mod if tile_mod else idx], nt,
                             tile_rays)
        dx, dy, dz = _planes(d_tiles[s:e], nt, tile_rays)
        cnt = counts[s:e]
        blk = blocked[s:e]
        width = int(cnt.max()) if nt else 0
        for i0, i1 in _steps(width, nt, tile_rays):
            live = (cnt[:, None] > torch.arange(i0, i1, device=dev)
                    )[..., None]  # [nt, p, 1]
            cl = cluster_list[s:e, i0:i1].long()
            valid, tt = _member_hit(tables, cl, ox, oy, oz, dx, dy, dz)
            hit = valid & (tt * tt <= r2_tiles[s:e])
            blk = blk | (hit.any(dim=2) & live).any(dim=1)
        blocked[s:e] = blk
    return blocked.reshape(-1)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def _check_tables(tables: ClusterTables, device):
    for name in ("n", "nv0", "m", "c", "nobf"):
        x = getattr(tables, name)
        _require(x.device == device and x.dtype == torch.float32
                 and x.is_contiguous(),
                 f"tables.{name} must be contiguous float32 on {device}")
    _require(tables.tri_id.device == device
             and tables.tri_id.dtype == torch.int32
             and tables.tri_id.is_contiguous(),
             f"tables.tri_id must be contiguous int32 on {device}")
    L = tables.n.shape[0]
    _require(tuple(tables.n.shape) == (L, CLUSTER_SIZE, 3)
             and tuple(tables.m.shape) == (L, CLUSTER_SIZE, 9)
             and tuple(tables.c.shape) == (L, CLUSTER_SIZE, 3)
             and tuple(tables.nv0.shape) == (L, CLUSTER_SIZE)
             and tuple(tables.nobf.shape) == (L, CLUSTER_SIZE),
             "cluster tables have inconsistent shapes")


def _check_rays(name, x, device, rows):
    _require(x.device == device and x.dtype == torch.float32
             and x.is_contiguous() and tuple(x.shape) == (rows, 3),
             f"{name} must be a contiguous float32 [{rows}, 3] on {device}")


def _check_lists(cluster_list, counts, tiles, L, device):
    _require(cluster_list.device == device
             and cluster_list.dtype == torch.int32
             and cluster_list.is_contiguous()
             and tuple(cluster_list.shape) == (tiles, L),
             f"cluster_list must be a contiguous int32 [{tiles}, {L}]")
    _require(counts.device == device and counts.dtype == torch.int32
             and counts.is_contiguous() and tuple(counts.shape) == (tiles,),
             f"counts must be a contiguous int32 [{tiles}]")


def _cuda_stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _check_rows_table(rows_table, L, device) -> int:
    if rows_table is None:
        return 0
    kp = rows_table.shape[-1]
    _require(rows_table.device == device
             and rows_table.dtype == torch.float32
             and rows_table.is_contiguous()
             and tuple(rows_table.shape) == (L, CLUSTER_SIZE, kp),
             f"rows_table must be a contiguous float32 [{L}, 16, Kp]")
    return kp


def _check_closest_hit(tables, origins, dirs, cluster_list, counts,
                       rows_table):
    """Check K1's / K7's arguments -> (R, tiles, L, kp)."""
    dev = origins.device
    R = origins.shape[0]
    _require(R % TILE_RAYS == 0, f"R must be a multiple of {TILE_RAYS}")
    tiles = R // TILE_RAYS
    L = tables.n.shape[0]
    _check_rays("origins", origins, dev, R)
    _check_rays("dirs", dirs, dev, R)
    _check_tables(tables, dev)
    _check_lists(cluster_list, counts, tiles, L, dev)
    return R, tiles, L, _check_rows_table(rows_table, L, dev)


def closest_hit(tables: ClusterTables, origins, dirs, cluster_list, counts,
                rows_table=None):
    """K1: closest hit of each ray over its tile's binned cluster list.

    origins, dirs: [R, 3] f32 with R % TILE_RAYS == 0; cluster_list
    [tiles, L] i32; counts [tiles] i32; rows_table [L, 16, Kp] or None.
    Returns (t [R] f32, tri [R] i32, rows [Kp, R] f32 or None).
    """
    dev = origins.device
    R, tiles, L, kp = _check_closest_hit(tables, origins, dirs, cluster_list,
                                         counts, rows_table)

    if dev.type == "cpu":
        return closest_hit_plain(tables, origins, dirs, cluster_list, counts,
                                 rows_table)
    if dev.type != "cuda":
        raise NotImplementedError(f"closest_hit has no kernel for {dev}")

    from crt_tpu_torch.ops import cuda_lib

    lib, _ = cuda_lib.load()
    best_t = torch.empty((R,), dtype=torch.float32, device=dev)
    best_tri = torch.empty((R,), dtype=torch.int32, device=dev)
    rows = (torch.empty((kp, R), dtype=torch.float32, device=dev)
            if kp else None)
    if tiles:
        with torch.cuda.device(dev):
            err = lib.crt_closest_hit(
                origins.data_ptr(), dirs.data_ptr(), tables.n.data_ptr(),
                tables.nv0.data_ptr(), tables.m.data_ptr(),
                tables.c.data_ptr(), tables.nobf.data_ptr(),
                tables.tri_id.data_ptr(), cluster_list.data_ptr(),
                counts.data_ptr(),
                rows_table.data_ptr() if kp else None,
                L, tiles, TILE_RAYS, kp,
                best_t.data_ptr(), best_tri.data_ptr(),
                rows.data_ptr() if kp else None,
                _cuda_stream(dev),
            )
        _raise_on(err, "closest_hit")
        tracing.count("crt.launches.closest_hit")
    return best_t, best_tri, rows


def live_tiles(counts):
    """The live-first tile list of ``counts`` [tiles] i32 ->
    (tile_ids [tiles] i32, n_live [1] i32): the tiles with counts > 0 in
    ascending order, then the others in ascending order, and how many are
    live.  On the card one block of ``live_tiles_kernel``
    (``csrc/closest_hit.cu``), which ``closest_hit_compact`` launches
    itself; ``live_tiles_plain`` for CPU tensors.  Both equal bit for bit.
    """
    _require(counts.dtype == torch.int32 and counts.is_contiguous()
             and counts.dim() == 1, "counts must be a contiguous int32 [tiles]")
    dev = counts.device
    if dev.type == "cpu":
        return live_tiles_plain(counts)
    if dev.type != "cuda":
        raise NotImplementedError(f"live_tiles has no kernel for {dev}")

    from crt_tpu_torch.ops import cuda_lib

    lib, _ = cuda_lib.load()
    tiles = counts.shape[0]
    lst = torch.empty((tiles + 1,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.crt_live_tiles(counts.data_ptr(), tiles, lst.data_ptr(),
                                 _cuda_stream(dev))
    _raise_on(err, "live_tiles")
    tracing.count("crt.launches.live_tiles")
    return lst[:tiles], lst[tiles:]


def closest_hit_compact(tables: ClusterTables, origins, dirs, cluster_list,
                        counts, rows_table=None, tile_mod: int = 0):
    """K4: ``closest_hit`` launched over the live tiles (counts > 0).

    A live-first tile list and the live count are built on the device from
    ``counts`` (``live_tiles``' kernel, launched by the same call); tiles
    with an empty list get the miss result (t = inf, tri = -1, rows 0).
    With ``tile_mod`` > 0 ``origins`` is [tile_mod * TILE_RAYS, 3] and tile
    i reads origin tile i % tile_mod.  The launch reads the live count on
    the device, so it needs no device-to-host read.  Outputs equal
    ``closest_hit``'s on the same lists bit for bit.
    """
    dev = dirs.device
    R = dirs.shape[0]
    _require(R % TILE_RAYS == 0, f"R must be a multiple of {TILE_RAYS}")
    tiles = R // TILE_RAYS
    L = tables.n.shape[0]
    _require(tile_mod >= 0 and (tile_mod == 0 or tiles % tile_mod == 0),
             "tile_mod must divide the tile count")
    _check_rays("origins", origins, dev,
                tile_mod * TILE_RAYS if tile_mod else R)
    _check_rays("dirs", dirs, dev, R)
    _check_tables(tables, dev)
    _check_lists(cluster_list, counts, tiles, L, dev)
    kp = _check_rows_table(rows_table, L, dev)

    if dev.type == "cpu":
        return closest_hit_compact_plain(tables, origins, dirs, cluster_list,
                                         counts, rows_table, tile_mod)
    if dev.type != "cuda":
        raise NotImplementedError(
            f"closest_hit_compact has no kernel for {dev}")

    from crt_tpu_torch.ops import cuda_lib

    lib, _ = cuda_lib.load()
    best_t = torch.empty((R,), dtype=torch.float32, device=dev)
    # tri, then the scratch the launch writes its live-first tile list and
    # n_live into (one allocation: the wrapper's host time is the launch's
    # floor on a sparse wavefront)
    tri_and_list = torch.empty((R + tiles + 1,), dtype=torch.int32,
                               device=dev)
    best_tri = tri_and_list[:R]
    rows = (torch.empty((kp, R), dtype=torch.float32, device=dev)
            if kp else None)
    if tiles:
        with torch.cuda.device(dev):
            err = lib.crt_closest_hit_compact(
                tri_and_list.data_ptr() + 4 * R,
                origins.data_ptr(), dirs.data_ptr(), tables.n.data_ptr(),
                tables.nv0.data_ptr(), tables.m.data_ptr(),
                tables.c.data_ptr(), tables.nobf.data_ptr(),
                tables.tri_id.data_ptr(), cluster_list.data_ptr(),
                counts.data_ptr(),
                rows_table.data_ptr() if kp else None,
                L, tiles, TILE_RAYS, tile_mod, kp,
                best_t.data_ptr(), best_tri.data_ptr(),
                rows.data_ptr() if kp else None,
                _cuda_stream(dev),
            )
        _raise_on(err, "closest_hit_compact")
        tracing.count("crt.launches.closest_hit_compact")
        tracing.count("crt.launches.live_tiles")  # K4's list, same launch
    return best_t, best_tri, rows


def closest_hit_merged(tables: ClusterTables, origins, dirs, cluster_list,
                       counts, rows_table=None, merge: int = 2):
    """K7: ``closest_hit`` with ``merge`` consecutive tiles per block.

    Arguments and outputs as ``closest_hit``; the tile count must divide
    by ``merge`` (ValueError otherwise).  Outputs equal ``closest_hit``'s
    on the same lists bit for bit.
    """
    dev = origins.device
    R, tiles, L, kp = _check_closest_hit(tables, origins, dirs, cluster_list,
                                         counts, rows_table)
    _require(merge >= 1 and tiles % merge == 0,
             f"the tile count {tiles} must divide by merge={merge}")

    if dev.type == "cpu":
        return closest_hit_merged_plain(tables, origins, dirs, cluster_list,
                                        counts, rows_table, merge)
    if dev.type != "cuda":
        raise NotImplementedError(
            f"closest_hit_merged has no kernel for {dev}")

    from crt_tpu_torch.ops import cuda_lib

    lib, _ = cuda_lib.load()
    best_t = torch.empty((R,), dtype=torch.float32, device=dev)
    best_tri = torch.empty((R,), dtype=torch.int32, device=dev)
    rows = (torch.empty((kp, R), dtype=torch.float32, device=dev)
            if kp else None)
    if tiles:
        with torch.cuda.device(dev):
            err = lib.crt_closest_hit_merged(
                origins.data_ptr(), dirs.data_ptr(), tables.n.data_ptr(),
                tables.nv0.data_ptr(), tables.m.data_ptr(),
                tables.c.data_ptr(), tables.nobf.data_ptr(),
                tables.tri_id.data_ptr(), cluster_list.data_ptr(),
                counts.data_ptr(),
                rows_table.data_ptr() if kp else None,
                L, tiles, TILE_RAYS, merge, kp,
                best_t.data_ptr(), best_tri.data_ptr(),
                rows.data_ptr() if kp else None,
                _cuda_stream(dev),
            )
        _raise_on(err, "closest_hit_merged")
        tracing.count("crt.launches.closest_hit_merged")
    return best_t, best_tri, rows


def walk_stats(device):
    """The two-word buffer that K2, K5 and K6 add their walks' repacks and
    member tests to, while tracing is on; None (no count, no work)
    otherwise.  ``count_walk`` counts it."""
    if not tracing.enabled():
        return None
    return torch.zeros((2,), dtype=torch.int64, device=device)


def count_walk(stats) -> None:
    """Count a launch's ``walk_stats`` buffer on the device:
    ``crt.shadow.repacks`` (the long walks' repacks) and
    ``crt.shadow.lane_tests`` (member tests issued by the lanes of the warps
    that tested: 32 x 16 x the clusters of each batch a warp tests)."""
    if stats is not None:
        tracing.count("crt.shadow.repacks", stats[0])
        tracing.count("crt.shadow.lane_tests", stats[1])


def occlusion_mode(capped: bool, glass_flag: bool) -> str:
    """The suffix of ``crt.launches.occlusion_w`` a launch counts under."""
    if glass_flag:
        return "glass"
    return "capped" if capped else "uncapped"


def occlusion_w(tables: ClusterTables, shadow_o, point, light_positions,
                cluster_list, counts, capped: bool = True, member_mask=None,
                glass_flag: bool = False):
    """K2: w-form shadow occlusion of Ll lights over R pixel lanes.

    shadow_o (biased origins), point (unbiased hit points): [R, 3] f32;
    light_positions [Ll, 3]; cluster_list [Ll*tpl, L] i32 and counts
    [Ll*tpl] i32 from bin_apex_shared.  Returns blocked [Ll*R] bool,
    light-major, False on tiles with an empty list.

    ``capped=False`` drops the s <= 1 condition (any hit on the unbounded
    ray).  ``member_mask`` ([L, 16] f32, 1.0 = in the subset) restricts
    hits to a triangle subset.  ``glass_flag`` (needs ``member_mask``)
    instead keeps every member in ``blocked`` and returns a second mask,
    (blocked, glass): some member of the subset is hit anywhere on the
    ray, uncapped.
    """
    dev = shadow_o.device
    R = shadow_o.shape[0]
    _require(R % TILE_RAYS == 0, f"R must be a multiple of {TILE_RAYS}")
    tpl = R // TILE_RAYS
    Ll = light_positions.shape[0]
    L = tables.n.shape[0]
    _check_rays("shadow_o", shadow_o, dev, R)
    _check_rays("point", point, dev, R)
    _check_rays("light_positions", light_positions, dev, Ll)
    _check_tables(tables, dev)
    _check_lists(cluster_list, counts, Ll * tpl, L, dev)
    _require(member_mask is not None or not glass_flag,
             "glass_flag needs the member mask of the glass subset")
    if member_mask is not None:
        _require(member_mask.device == dev
                 and member_mask.dtype == torch.float32
                 and member_mask.is_contiguous()
                 and tuple(member_mask.shape) == (L, CLUSTER_SIZE),
                 f"member_mask must be a contiguous float32 [{L}, 16]")

    if dev.type == "cpu":
        return occlusion_w_plain(tables, shadow_o, point, light_positions,
                                 cluster_list, counts, capped, member_mask,
                                 glass_flag)
    if dev.type != "cuda":
        raise NotImplementedError(f"occlusion_w has no kernel for {dev}")

    from crt_tpu_torch.ops import cuda_lib

    lib, _ = cuda_lib.load()
    occ = torch.empty((Ll * R,), dtype=torch.bool, device=dev)
    glass = (torch.empty((Ll * R,), dtype=torch.bool, device=dev)
             if glass_flag else None)
    if Ll * tpl:
        stats = walk_stats(dev)
        with torch.cuda.device(dev):
            err = lib.crt_occlusion_w(
                shadow_o.data_ptr(), point.data_ptr(),
                light_positions.data_ptr(), tables.n.data_ptr(),
                tables.nv0.data_ptr(), tables.m.data_ptr(),
                tables.c.data_ptr(), tables.nobf.data_ptr(),
                member_mask.data_ptr() if member_mask is not None else None,
                cluster_list.data_ptr(), counts.data_ptr(),
                L, Ll * tpl, tpl, TILE_RAYS,
                int(capped), int(member_mask is not None and not glass_flag),
                int(glass_flag),
                occ.data_ptr(),
                glass.data_ptr() if glass_flag else None,
                _cuda_stream(dev),
                stats.data_ptr() if stats is not None else None,
            )
        _raise_on(err, "occlusion_w")
        count_walk(stats)
        tracing.count("crt.launches.occlusion_w."
                    + occlusion_mode(capped, glass_flag))
    return (occ, glass) if glass_flag else occ


def occlusion_d(tables: ClusterTables, origins, dirs, r2, cluster_list,
                counts, tile_rays: int = TILE_RAYS, tile_mod: int = 0,
                exit: bool = False, active=None):
    """K5 / K6: direction-form any-hit occlusion over binned lists.

    dirs [R, 3] f32 unit directions, r2 [R] f32 squared reach, cluster_list
    [tiles, L] i32, counts [tiles] i32 with tiles = R / tile_rays.  Returns
    blocked [R] bool: some member of the lane's tile list is hit at t >= 0
    with t * t <= r2.

    K5 (``exit=False``): the shadow launch.  origins is [tile_mod *
    tile_rays, 3] when ``tile_mod`` > 0 and tile i reads origin tile i %
    tile_mod (the lights of a shadow pass share the pixel origins), else
    [R, 3].  A tile with an empty list is all False; no lane is seeded.

    K6 (``exit=True``): the any-hit query over every tile.  Lanes outside
    ``active`` ([R] bool, None = all active) start, and so return, blocked;
    a tile with an empty list returns that seed.

    Both leave a tile once every lane of a block is blocked, which changes
    no lane's answer.
    """
    dev = dirs.device
    R = dirs.shape[0]
    _require(tile_rays > 0 and R % tile_rays == 0,
             f"R must be a multiple of {tile_rays}")
    tiles = R // tile_rays
    L = tables.n.shape[0]
    _require(tile_mod >= 0 and (tile_mod == 0 or tiles % tile_mod == 0),
             "tile_mod must divide the tile count")
    _require(exit or active is None, "active seeds the exit mode only")
    _require(not (exit and tile_mod), "the exit mode takes no tile_mod")
    _check_rays("origins", origins, dev,
                tile_mod * tile_rays if tile_mod else R)
    _check_rays("dirs", dirs, dev, R)
    _require(r2.device == dev and r2.dtype == torch.float32
             and r2.is_contiguous() and tuple(r2.shape) == (R,),
             f"r2 must be a contiguous float32 [{R}] on {dev}")
    _check_tables(tables, dev)
    _check_lists(cluster_list, counts, tiles, L, dev)
    seed = None
    if active is not None:
        _require(active.device == dev and active.dtype == torch.bool
                 and tuple(active.shape) == (R,),
                 f"active must be a bool [{R}] on {dev}")
        seed = ~active

    if dev.type == "cpu":
        return occlusion_d_plain(tables, origins, dirs, r2, cluster_list,
                                 counts, tile_rays, tile_mod, seed)
    if dev.type != "cuda":
        raise NotImplementedError(f"occlusion_d has no kernel for {dev}")
    _require(tile_rays % 256 == 0, "the kernel takes 256-lane blocks")

    from crt_tpu_torch.ops import cuda_lib

    lib, _ = cuda_lib.load()
    occ = torch.empty((R,), dtype=torch.bool, device=dev)
    if tiles:
        stats = walk_stats(dev)
        with torch.cuda.device(dev):
            err = lib.crt_occlusion_d(
                origins.data_ptr(), dirs.data_ptr(), r2.data_ptr(),
                seed.data_ptr() if seed is not None else None,
                tables.n.data_ptr(), tables.nv0.data_ptr(),
                tables.m.data_ptr(), tables.c.data_ptr(),
                tables.nobf.data_ptr(), cluster_list.data_ptr(),
                counts.data_ptr(), L, tiles, tile_rays, tile_mod,
                occ.data_ptr(), _cuda_stream(dev),
                stats.data_ptr() if stats is not None else None,
            )
        _raise_on(err, "occlusion_d")
        count_walk(stats)
        tracing.count("crt.launches.occlusion_d."
                    + ("exit" if exit else "compact"))
    return occ


# ---------------------------------------------------------------------------
# The tracer
# ---------------------------------------------------------------------------

def _count_shadow(counts, active):
    """A shadow pass's (tile, cluster) list pairs and active lanes, summed
    on the device."""
    tracing.count("crt.shadow.pairs", counts)
    tracing.count("crt.shadow.lanes", active)


def pad_rays(o, d, active, tile_rays, pad_all_active: bool = False):
    """Flat rays padded to a tile multiple, as the JAX factories pad them:
    origin 0, direction (0, 0, -1), inactive.  ``pad_all_active`` turns a
    missing mask into "the real lanes" once there is padding (the any-hit
    and streaming factories do; the closest-hit one leaves it None).
    Returns (o, d, active or None), contiguous."""
    R = o.shape[0]
    pad = (-R) % tile_rays
    a = None if active is None else active.reshape(-1)
    if pad:
        o = torch.cat([o, o.new_zeros((pad, 3))])
        tracing.count("crt.host_reads.pad_rays")  # a copy to the card
        d = torch.cat([d, d.new_tensor([[0.0, 0.0, -1.0]]).expand(pad, 3)])
        if a is None and pad_all_active:
            a = torch.ones((R,), dtype=torch.bool, device=o.device)
        if a is not None:
            a = torch.cat([a, a.new_zeros((pad,))])
    return o.contiguous(), d.contiguous(), a


SHADOW_KERNELS = ("w", "d", "anyhit")


class ClusterTracer(Tracer):
    """The cluster backend (``make_pallas_trace_fn``) over ``tables``.

    Rays are padded to a tile multiple with direction (0, 0, -1) and
    inactive lanes, as the JAX factory does.  Built with the ``scene`` the
    tables come from, it also emits the packed rows (``with_rows``) and,
    for a scene with refractive materials, routes the transmissive march
    (``shadow_glass``); both read the scene's shading tables.

    ``compact_masked`` sends every trace that comes with an ``active``
    mask through the live-tile compacted kernel (``closest_hit_compact``).
    Every other trace whose tile count divides by ``tile_merge``, when
    that is above 1, goes through the tile-merged kernel
    (``closest_hit_merged``), as crt_tpu chooses it; K1 takes the rest.

    ``shadow_kernel`` picks the kernel of the opaque shadow pass, each
    equal to the closest hit with a t^2 <= r^2 compare: "w" (K2, the
    default) tests occlusion in the kernel along the unnormalized w =
    light - point (s <= 1); "d" (K5) is the direction form, the light-side
    shaft binning of ``bin_rays``' apex mode and K5 over the live tiles,
    the origin tiles stored once for all lights (``tile_mod``); "anyhit"
    (K6) is the any-hit query ``occluded`` over the stacked wavefront.  K2
    and K5 take a flat wavefront of whole tiles; any other shadow pass is
    the generic closest hit and a compare.
    """

    def __init__(self, tables: ClusterTables, scene=None,
                 compact_masked: bool = False, tile_merge: int = 1,
                 shadow_kernel: str = "w"):
        if shadow_kernel not in SHADOW_KERNELS:
            raise ValueError(f"unknown shadow kernel {shadow_kernel!r}")
        self.tables = tables
        self.scene = scene
        self.compact_masked = compact_masked
        self.tile_merge = tile_merge
        self.shadow_kernel = shadow_kernel
        self.emits_rows = scene is not None
        self.rank = tables.rank
        self._glass_router = (shadow_kernel == "w" and scene is not None
                              and scene.has_materials
                              and scene.has_refractive)
        self._rows_table = None  # emit_rows_table, built at first use
        self._glass = None  # glass_subset, built at first use

    def _trace(self, origins, dirs, active, want_rows):
        tables = self.tables
        batch_shape = origins.shape[:-1]
        R = origins[..., 0].numel()
        o, d, a = pad_rays(origins.detach().reshape(-1, 3),
                           dirs.detach().reshape(-1, 3), active, TILE_RAYS)
        rows_table = None
        if want_rows:
            if self._rows_table is None:
                self._rows_table = emit_rows_table(self.scene, tables)
            rows_table = self._rows_table
        cluster_list, counts = bin_rays(tables, o, d, TILE_RAYS, a)
        args = (tables, o, d, cluster_list, counts, rows_table)
        if self.compact_masked and a is not None:
            t, tri, rows = closest_hit_compact(*args)
        elif self.tile_merge > 1 and counts.shape[0] % self.tile_merge == 0:
            t, tri, rows = closest_hit_merged(*args, merge=self.tile_merge)
        else:
            t, tri, rows = closest_hit(*args)
        hit = Hit(t=t[:R].reshape(batch_shape),
                  tri=tri[:R].reshape(batch_shape))
        if want_rows:
            return hit, rows[:, :R]
        return hit

    def __call__(self, origins, dirs, active=None) -> Hit:
        return self._trace(origins, dirs, active, False)

    def with_rows(self, origins, dirs, active=None):
        """(Hit, rows [K+1, R]): kernel-emitted packed rows + slot rank."""
        return self._trace(origins, dirs, active, True)

    def _shadow_w(self, point, shadow_o, light_positions, active,
                  origin_slack, capped=True, masked=False, glass_flag=False):
        """Bin the shadow shafts and run K2 in one mode -> [Ll, R] masks
        (a pair of them with ``glass_flag``); None when R is not a tile
        multiple."""
        tables = self.tables
        Ll, R = active.shape
        if R % TILE_RAYS:
            return None
        shadow_o = shadow_o.detach().contiguous()
        point = point.detach().contiguous()
        light_positions = light_positions.detach().contiguous()
        gm = None
        bin_kw = {}
        if masked or glass_flag:
            if self._glass is None:
                self._glass = glass_subset(self.scene, tables)
            gm, gmin, gmax = self._glass
            if glass_flag:
                bin_kw = dict(glass_boxes=(gmin, gmax))
            else:
                bin_kw = dict(boxes=(gmin, gmax), capped=capped)
        cluster_list, counts = bin_apex_shared(
            tables, shadow_o, light_positions, active, TILE_RAYS,
            origin_slack, **bin_kw,
        )
        _count_shadow(counts, active)
        out = occlusion_w(tables, shadow_o, point, light_positions,
                          cluster_list, counts, capped, gm, glass_flag)
        if glass_flag:
            return out[0].reshape(Ll, R), out[1].reshape(Ll, R)
        return out.reshape(Ll, R)

    def _shadow_d(self, shadow_o, light_dirs, r2, light_positions, active,
                  origin_slack):
        """Direction-form occlusion masks (K5) of a flat point-light
        shadow wavefront of whole tiles -> [Ll, R]."""
        Ll, R = r2.shape
        tpl = R // TILE_RAYS
        shadow_o = shadow_o.detach()
        o_flat = shadow_o.expand(Ll, R, 3).reshape(-1, 3)
        d_flat = light_dirs.detach().reshape(-1, 3).contiguous()
        apex = light_positions.detach().repeat_interleave(tpl, dim=0)
        cluster_list, counts = bin_rays(
            self.tables, o_flat, d_flat, TILE_RAYS, active.reshape(-1),
            apex=apex, apex_slack=origin_slack)
        _count_shadow(counts, active)
        occ = occlusion_d(self.tables, shadow_o.contiguous(), d_flat,
                          r2.detach().reshape(-1).contiguous(), cluster_list,
                          counts, TILE_RAYS, tile_mod=tpl)
        return occ.reshape(Ll, R)

    def shadow(self, point, shadow_o, light_positions, light_dirs, r2,
               active, origin_slack):
        if self.shadow_kernel == "anyhit":
            return self.occluded(
                shadow_o.detach().expand(light_dirs.shape).reshape(-1, 3),
                light_dirs.detach().reshape(-1, 3), r2.detach().reshape(-1),
                active.reshape(-1)).reshape(r2.shape)
        if point.dim() != 2 or r2.shape[1] % TILE_RAYS:
            return super().shadow(point, shadow_o, light_positions,
                                  light_dirs, r2, active, origin_slack)
        if self.shadow_kernel == "w":
            return self._shadow_w(point, shadow_o, light_positions, active,
                                  origin_slack)
        return self._shadow_d(shadow_o, light_dirs, r2, light_positions,
                              active, origin_slack)

    def shadow_glass(self, point, shadow_o, light_positions, active,
                     origin_slack):
        """One K2 pass in its glass-flag mode -> (occluded [Ll, R],
        glass_on_ray [Ll, R]): the bits of the w form plus "some
        refractive member is hit anywhere on the unbounded ray".  The
        bend-walk this routes around bends at glass even beyond the light,
        so the lists are the union of the capped shaft hull and the
        uncapped glass-member reach, and the glass accumulator drops the
        s <= 1 cap.  None without the router (``shadow_kernel`` not "w",
        or no glass in the scene) or when the wavefront is not a flat one
        of whole tiles."""
        if not self._glass_router or point.dim() != 2:
            return None
        return self._shadow_w(point, shadow_o, light_positions, active,
                              origin_slack, glass_flag=True)

    def refr_ray_hit_w(self, point, shadow_o, light_positions, active,
                       origin_slack):
        """[Ll, R] bool: can the uncapped shadow ray touch refractive
        geometry?  A separate any-hit pass over the refractive members
        alone, binned against their boxes with no cap: the independent
        check of ``shadow_glass``'s second output (None when R is not a
        tile multiple)."""
        return self._shadow_w(point, shadow_o, light_positions, active,
                              origin_slack, capped=False, masked=True)

    def occluded(self, origins, dirs, r2, active=None):
        """Any-hit occlusion query (K6) -> blocked, shaped like ``r2``;
        inactive lanes return True."""
        batch_shape = origins.shape[:-1]
        R = r2.numel()
        o, d, a = pad_rays(origins.detach().reshape(-1, 3),
                           dirs.detach().reshape(-1, 3), active, TILE_RAYS,
                           pad_all_active=True)
        rr = r2.detach().reshape(-1)
        rr = torch.cat([rr, rr.new_zeros((o.shape[0] - R,))]).contiguous()
        cluster_list, counts = bin_rays(self.tables, o, d, TILE_RAYS, a)
        occ = occlusion_d(self.tables, o, d, rr, cluster_list, counts,
                          TILE_RAYS, exit=True, active=a)
        return occ[:R].reshape(batch_shape)


def make_cluster_trace_fn(scene, **kw) -> ClusterTracer:
    """The cluster backend of ``scene``: its tables built, and
    ``ClusterTracer(tables, scene, **kw)``."""
    return ClusterTracer(build_cluster_tables(scene), scene, **kw)

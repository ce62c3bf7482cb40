"""The binned cluster trace: kernel wrappers and the trace factory.

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
  - ``make_cluster_trace_fn`` replaces ``make_pallas_trace_fn``.

Each wrapper launches its CUDA kernel for CUDA tensors (or raises) and
takes its plain PyTorch version, in this module, only for CPU tensors.
The plain versions walk the same lists in the same order with the same
arithmetic, so on the card the kernels must match them bit for bit.
``closest_hit_launches`` / ``closest_hit_compact_launches`` /
``closest_hit_merged_launches`` / ``occlusion_w_launches`` /
``occlusion_d_launches`` / ``live_tiles_launches`` count kernel launches
(CUDA launches only; the plain versions do not count);
``occlusion_w_mode_launches`` and ``occlusion_d_mode_launches`` split the
last two by mode.

``CRT_APEX_W=0`` in the environment (read at import, as crt_tpu reads it)
takes ``shadow_apex_w`` off the traces built here, so shadows go through
the direction form (``trace.shadow_apex``, K5).  ``CRT_TILE_MERGE=k`` with
k > 1 (read at import, as crt_tpu reads it) sends every closest hit of the
traces built here through K7 with ``merge=k`` when the wavefront's tile
count divides by k and the launch is not the compacted one.
"""

from __future__ import annotations

import os

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

_BIGID = 2**30
# Launch counts of the kernels (plain module-level integers).
closest_hit_launches = 0
closest_hit_compact_launches = 0
live_tiles_launches = 0  # K4's live-list kernel, by either wrapper
closest_hit_merged_launches = 0
occlusion_w_launches = 0  # every mode
occlusion_w_mode_launches = {"capped": 0, "uncapped": 0, "glass": 0}
occlusion_d_launches = 0  # both modes
occlusion_d_mode_launches = {"compact": 0, "exit": 0}

# In-kernel shadow directions (the w form) on by default; "0" leaves the
# direction form as the shadow path of the traces built here.
_APEX_W = os.environ.get("CRT_APEX_W", "1") != "0"

# Tiles per block of the closest hit (K7 when > 1), as crt_tpu's flag.
_TILE_MERGE = int(os.environ.get("CRT_TILE_MERGE", "1"))

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
    The op order of csrc/cluster_common.cuh member_hit."""
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
        global closest_hit_launches
        closest_hit_launches += 1
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
    global live_tiles_launches
    live_tiles_launches += 1
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
        global closest_hit_compact_launches, live_tiles_launches
        closest_hit_compact_launches += 1
        live_tiles_launches += 1
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
        global closest_hit_merged_launches
        closest_hit_merged_launches += 1
    return best_t, best_tri, rows


def occlusion_mode(capped: bool, glass_flag: bool) -> str:
    """The name ``occlusion_w_mode_launches`` counts a launch under."""
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
            )
        _raise_on(err, "occlusion_w")
        global occlusion_w_launches
        occlusion_w_launches += 1
        occlusion_w_mode_launches[occlusion_mode(capped, glass_flag)] += 1
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
        with torch.cuda.device(dev):
            err = lib.crt_occlusion_d(
                origins.data_ptr(), dirs.data_ptr(), r2.data_ptr(),
                seed.data_ptr() if seed is not None else None,
                tables.n.data_ptr(), tables.nv0.data_ptr(),
                tables.m.data_ptr(), tables.c.data_ptr(),
                tables.nobf.data_ptr(), cluster_list.data_ptr(),
                counts.data_ptr(), L, tiles, tile_rays, tile_mod,
                occ.data_ptr(), _cuda_stream(dev),
            )
        _raise_on(err, "occlusion_d")
        global occlusion_d_launches
        occlusion_d_launches += 1
        occlusion_d_mode_launches["exit" if exit else "compact"] += 1
    return occ


# ---------------------------------------------------------------------------
# The trace factory
# ---------------------------------------------------------------------------

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
        d = torch.cat([d, d.new_tensor([[0.0, 0.0, -1.0]]).expand(pad, 3)])
        if a is None and pad_all_active:
            a = torch.ones((R,), dtype=torch.bool, device=o.device)
        if a is not None:
            a = torch.cat([a, a.new_zeros((pad,))])
    return o.contiguous(), d.contiguous(), a


def occluded_by_closest_hit(trace, shadow_o, light_dirs, r2, active):
    """[Ll, R] occlusion masks from the generic closest hit of the stacked
    [Ll * R] shadow wavefront: the fallback of the direction-form shadow
    paths when R is not a tile multiple."""
    Ll, R = r2.shape
    sh = trace(shadow_o.expand(Ll, R, 3).reshape(-1, 3),
               light_dirs.reshape(-1, 3), active.reshape(-1))
    return (sh.valid & (sh.t * sh.t <= r2.reshape(-1))).reshape(Ll, R)


def make_cluster_trace_fn(scene, compact_masked: bool = False,
                          use_occlusion_kernel: bool = False,
                          apex_w: bool | None = None,
                          tile_merge: int | None = None):
    """trace_fn factory for the cluster backend (``make_pallas_trace_fn``).

    ``trace(o, d, active=None) -> Hit``; ``trace.with_rows(o, d, active)
    -> (Hit, rows [K+1, R])`` with the kernel-emitted packed rows and the
    slot-rank row; ``trace.shadow_apex_w(point, shadow_o, light_positions,
    active [Ll, R], origin_slack) -> occluded [Ll, R]`` (None when R is
    not a tile multiple); ``trace.rank`` is the tables' triangle id ->
    slot rank map.  Rays are padded to a tile multiple with
    direction (0, 0, -1) and inactive lanes, as the JAX factory does.

    ``trace.shadow_apex(shadow_o, light_dirs [Ll, R, 3], r2 [Ll, R],
    light_positions, active [Ll, R], origin_slack) -> occluded [Ll, R]`` is
    the direction form of the shadow pass: the light-side shaft binning of
    ``bin_rays``'s apex mode and K5 over the live tiles, the origin tiles
    stored once for all lights (``tile_mod``); when R is not a tile
    multiple, the generic trace and a compare.  ``apex_w`` (None: the
    module's ``CRT_APEX_W`` flag) off leaves ``shadow_apex_w`` and the
    glass router off the trace, so shading takes ``shadow_apex``.  The
    any-hit query ``occluded(o, d, r2, active=None) -> blocked`` (K6;
    inactive lanes return True) is ``trace.occluded`` with
    ``use_occlusion_kernel`` (shading then prefers it) and
    ``trace.occluded_kernel`` otherwise.

    ``compact_masked`` sends every trace that comes with an ``active``
    mask through the live-tile compacted kernel (``closest_hit_compact``).
    Every other trace whose tile count divides by ``tile_merge`` (None: the
    module's ``CRT_TILE_MERGE`` flag), when that is above 1, goes through
    the tile-merged kernel (``closest_hit_merged``), as crt_tpu chooses it;
    K1 takes the rest.
    A scene with refractive materials also gets, with the arguments of
    ``shadow_apex_w``, ``trace.shadow_apex_w_glass -> (occluded, glass)``
    (the one-pass march router: the capped occlusion bits plus "some
    refractive member lies anywhere on the unbounded ray") and
    ``trace.refr_ray_hit_w -> glass`` (the same flag from a separate
    uncapped pass over the refractive members alone).
    """
    tables = build_cluster_tables(scene)
    rows_table_cache = []
    glass_cache = []
    if apex_w is None:
        apex_w = _APEX_W
    if tile_merge is None:
        tile_merge = _TILE_MERGE

    def _trace_impl(origins, dirs, active, want_rows):
        batch_shape = origins.shape[:-1]
        R = origins[..., 0].numel()
        o, d, a = pad_rays(origins.detach().reshape(-1, 3),
                           dirs.detach().reshape(-1, 3), active, TILE_RAYS)
        rows_table = None
        if want_rows:
            if not rows_table_cache:
                rows_table_cache.append(emit_rows_table(scene, tables))
            rows_table = rows_table_cache[0]
        cluster_list, counts = bin_rays(tables, o, d, TILE_RAYS, a)
        args = (tables, o, d, cluster_list, counts, rows_table)
        if compact_masked and a is not None:
            t, tri, rows = closest_hit_compact(*args)
        elif tile_merge > 1 and counts.shape[0] % tile_merge == 0:
            t, tri, rows = closest_hit_merged(*args, merge=tile_merge)
        else:
            t, tri, rows = closest_hit(*args)
        hit = Hit(t=t[:R].reshape(batch_shape),
                  tri=tri[:R].reshape(batch_shape))
        if want_rows:
            return hit, rows[:, :R]
        return hit

    def trace(origins, dirs, active=None):
        return _trace_impl(origins, dirs, active, False)

    def trace_with_rows(origins, dirs, active=None):
        """(Hit, rows [K+1, R]): kernel-emitted packed rows + slot rank."""
        return _trace_impl(origins, dirs, active, True)

    def _shadow_w(point, shadow_o, light_positions, active, origin_slack,
                  capped=True, masked=False, glass_flag=False):
        """Bin the shadow shafts and run K2 in one mode -> [Ll, R] masks."""
        Ll, R = active.shape
        if R % TILE_RAYS:
            return None  # caller falls back to the generic shadow trace
        shadow_o = shadow_o.detach().contiguous()
        point = point.detach().contiguous()
        light_positions = light_positions.detach().contiguous()
        gm = None
        bin_kw = {}
        if masked or glass_flag:
            if not glass_cache:
                glass_cache.append(glass_subset(scene, tables))
            gm, gmin, gmax = glass_cache[0]
            if glass_flag:
                bin_kw = dict(glass_boxes=(gmin, gmax))
            else:
                bin_kw = dict(boxes=(gmin, gmax), capped=capped)
        cluster_list, counts = bin_apex_shared(
            tables, shadow_o, light_positions, active, TILE_RAYS,
            origin_slack, **bin_kw,
        )
        out = occlusion_w(tables, shadow_o, point, light_positions,
                          cluster_list, counts, capped, gm, glass_flag)
        if glass_flag:
            return out[0].reshape(Ll, R), out[1].reshape(Ll, R)
        return out.reshape(Ll, R)

    def shadow_apex_w(point, shadow_o, light_positions, active, origin_slack):
        """Occlusion masks with in-kernel shadow directions -> [Ll, R]."""
        return _shadow_w(point, shadow_o, light_positions, active,
                         origin_slack)

    def shadow_apex_w_glass(point, shadow_o, light_positions, active,
                            origin_slack):
        """One K2 pass -> (occluded [Ll, R], glass_on_ray [Ll, R]): the
        bits of ``shadow_apex_w`` plus "some refractive member is hit
        anywhere on the unbounded ray".  The bend-walk this routes around
        bends at glass even beyond the light, so the lists are the union
        of the capped shaft hull and the uncapped glass-member reach, and
        the glass accumulator drops the s <= 1 cap."""
        return _shadow_w(point, shadow_o, light_positions, active,
                         origin_slack, glass_flag=True)

    def refr_ray_hit_w(point, shadow_o, light_positions, active,
                       origin_slack):
        """[Ll, R] bool: can the uncapped shadow ray touch refractive
        geometry?  A separate any-hit pass over the refractive members
        alone, binned against their boxes with no cap: the independent
        check of ``shadow_apex_w_glass``'s second output."""
        return _shadow_w(point, shadow_o, light_positions, active,
                         origin_slack, capped=False, masked=True)

    def shadow_apex(shadow_o, light_dirs, r2, light_positions, active,
                    origin_slack):
        """Direction-form occlusion masks of a point-light shadow wavefront
        -> [Ll, R]."""
        Ll, R = r2.shape
        shadow_o = shadow_o.detach()
        light_dirs = light_dirs.detach()
        r2 = r2.detach()
        if R % TILE_RAYS:
            return occluded_by_closest_hit(trace, shadow_o, light_dirs, r2,
                                           active)
        tpl = R // TILE_RAYS
        o_flat = shadow_o.expand(Ll, R, 3).reshape(-1, 3)
        d_flat = light_dirs.reshape(-1, 3).contiguous()
        apex = light_positions.detach().repeat_interleave(tpl, dim=0)
        cluster_list, counts = bin_rays(
            tables, o_flat, d_flat, TILE_RAYS, active.reshape(-1), apex=apex,
            apex_slack=origin_slack)
        occ = occlusion_d(tables, shadow_o.contiguous(), d_flat,
                          r2.reshape(-1).contiguous(), cluster_list, counts,
                          TILE_RAYS, tile_mod=tpl)
        return occ.reshape(Ll, R)

    def occluded(origins, dirs, r2, active=None):
        """Any-hit occlusion query -> blocked, shaped like ``r2``."""
        batch_shape = origins.shape[:-1]
        R = r2.numel()
        o, d, a = pad_rays(origins.detach().reshape(-1, 3),
                           dirs.detach().reshape(-1, 3), active, TILE_RAYS,
                           pad_all_active=True)
        rr = r2.detach().reshape(-1)
        rr = torch.cat([rr, rr.new_zeros((o.shape[0] - R,))]).contiguous()
        cluster_list, counts = bin_rays(tables, o, d, TILE_RAYS, a)
        occ = occlusion_d(tables, o, d, rr, cluster_list, counts, TILE_RAYS,
                          exit=True, active=a)
        return occ[:R].reshape(batch_shape)

    trace.with_rows = trace_with_rows
    trace.shadow_apex = shadow_apex
    if apex_w:
        trace.shadow_apex_w = shadow_apex_w
        if scene.has_materials and scene.has_refractive:
            trace.shadow_apex_w_glass = shadow_apex_w_glass
            trace.refr_ray_hit_w = refr_ray_hit_w
    if use_occlusion_kernel:
        trace.occluded = occluded
    else:
        trace.occluded_kernel = occluded  # offered, not taken by shading
    trace.rank = tables.rank
    return trace

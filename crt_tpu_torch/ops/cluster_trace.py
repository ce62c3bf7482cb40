"""The binned cluster trace: kernel wrappers and the trace factory.

Counterpart of the launch half of ``crt_tpu/ops/pallas_trace.py``:

  - ``closest_hit`` (K1, ``csrc/closest_hit.cu``) replaces
    ``_trace_kernel`` / ``_trace_tile_body`` as launched by
    ``_closest_hit_binned``, with emitted packed rows;
  - ``occlusion_w`` (K2, ``csrc/occlusion_w.cu``) replaces
    ``_occl_kernel_compact_w`` as launched by
    ``_occluded_binned_compact_w`` (capped mode);
  - ``make_cluster_trace_fn`` replaces ``make_pallas_trace_fn``.

Each wrapper launches its CUDA kernel for CUDA tensors (or raises) and
takes its plain PyTorch version, in this module, only for CPU tensors.
The plain versions walk the same lists in the same order with the same
arithmetic, so on the card the kernels must match them bit for bit.
``closest_hit_launches`` / ``occlusion_w_launches`` count kernel launches
(CUDA launches only; the plain versions do not count).
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
)
from crt_tpu_torch.ops.intersect import PARALLEL_EPS, Hit

_BIGID = 2**30
# Launch counts of the two kernels (plain module-level integers).
closest_hit_launches = 0
occlusion_w_launches = 0

# Tiles per step of the plain versions: bounds their [tiles, 16, TR]
# temporaries (~64 MB each at 1024-ray tiles) on the card.
_PLAIN_TILE_CHUNK = 1024


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _member_t(tables: ClusterTables, cl, ox, oy, oz, dx, dy, dz):
    """[nt, 16, TR] hit distance of every member of clusters ``cl`` ([nt])
    for the rays of each tile (components [nt, 1, TR]); +inf where not hit.
    The op order of csrc/cluster_common.cuh member_t."""
    n = tables.n[cl]  # [nt, 16, 3]
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
    return torch.where(valid, t, torch.full_like(t, float("inf")))


def _planes(x, nt):
    """[nt*TR, 3] -> three [nt, 1, TR] component planes."""
    x = x.reshape(nt, 1, TILE_RAYS, 3)
    return x[..., 0], x[..., 1], x[..., 2]


def closest_hit_plain(tables: ClusterTables, origins, dirs, cluster_list,
                      counts, rows_table=None):
    """Plain version of ``closest_hit``: loop over walk positions,
    vectorized over tiles x 16 members x rays."""
    R = origins.shape[0]
    tiles = R // TILE_RAYS
    dev = origins.device
    best_t = torch.full((tiles, TILE_RAYS), float("inf"), device=dev)
    best_tri = torch.full((tiles, TILE_RAYS), -1, dtype=torch.int32,
                          device=dev)
    best_slot = torch.full((tiles, TILE_RAYS), -1, dtype=torch.int64,
                           device=dev)
    for s in range(0, tiles, _PLAIN_TILE_CHUNK):
        e = min(s + _PLAIN_TILE_CHUNK, tiles)
        nt = e - s
        ox, oy, oz = _planes(origins[s * TILE_RAYS:e * TILE_RAYS], nt)
        dx, dy, dz = _planes(dirs[s * TILE_RAYS:e * TILE_RAYS], nt)
        cnt = counts[s:e]
        bt, btri, bslot = best_t[s:e], best_tri[s:e], best_slot[s:e]
        for i in range(int(cnt.max()) if nt else 0):
            live = cnt > i  # [nt]
            cl = cluster_list[s:e, i].long()
            tt = _member_t(tables, cl, ox, oy, oz, dx, dy, dz)
            cl_best = tt.amin(dim=1)  # [nt, TR]
            tid = tables.tri_id[cl][..., None]  # [nt, 16, 1]
            at_best = tt <= cl_best[:, None]
            cl_tri = torch.where(at_best, tid, _BIGID).amin(dim=1)
            better = (cl_best < bt) & live[:, None]
            # the winning member: the one whose (t, id) won the reduction
            win = (at_best & (tid == cl_tri[:, None])).to(torch.int32)
            slot = cl[:, None] * CLUSTER_SIZE + win.argmax(dim=1)
            bt = torch.where(better, cl_best, bt)
            btri = torch.where(better, cl_tri, btri)
            bslot = torch.where(better, slot, bslot)
        best_t[s:e], best_tri[s:e], best_slot[s:e] = bt, btri, bslot

    rows = None
    if rows_table is not None:
        kp = rows_table.shape[-1]
        flat = rows_table.reshape(-1, kp)
        slot = best_slot.reshape(-1)
        rows = torch.where((slot >= 0)[:, None], flat[slot.clamp(min=0)],
                           torch.zeros((), device=dev)).T.contiguous()
    return best_t.reshape(-1), best_tri.reshape(-1), rows


def occlusion_w_plain(tables: ClusterTables, shadow_o, point, light_positions,
                      cluster_list, counts):
    """Plain version of ``occlusion_w``: loop over walk positions,
    vectorized over tiles x 16 members x lanes."""
    tpl = shadow_o.shape[0] // TILE_RAYS
    tiles = counts.shape[0]
    dev = shadow_o.device
    o_tiles = shadow_o.reshape(tpl, TILE_RAYS, 3)
    p_tiles = point.reshape(tpl, TILE_RAYS, 3)
    blocked = torch.zeros((tiles, TILE_RAYS), dtype=torch.bool, device=dev)
    for s in range(0, tiles, _PLAIN_TILE_CHUNK):
        e = min(s + _PLAIN_TILE_CHUNK, tiles)
        nt = e - s
        idx = torch.arange(s, e, device=dev)
        ox, oy, oz = _planes(o_tiles[idx % tpl], nt)
        px, py, pz = _planes(p_tiles[idx % tpl], nt)
        apex = light_positions[idx // tpl]  # [nt, 3]
        wx = apex[:, 0, None, None] - px
        wy = apex[:, 1, None, None] - py
        wz = apex[:, 2, None, None] - pz
        cnt = counts[s:e]
        blk = blocked[s:e]
        for i in range(int(cnt.max()) if nt else 0):
            live = cnt > i
            cl = cluster_list[s:e, i].long()
            tt = _member_t(tables, cl, ox, oy, oz, wx, wy, wz)
            blk = blk | ((tt <= 1.0).any(dim=1) & live[:, None])
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


def closest_hit(tables: ClusterTables, origins, dirs, cluster_list, counts,
                rows_table=None):
    """K1: closest hit of each ray over its tile's binned cluster list.

    origins, dirs: [R, 3] f32 with R % TILE_RAYS == 0; cluster_list
    [tiles, L] i32; counts [tiles] i32; rows_table [L, 16, Kp] or None.
    Returns (t [R] f32, tri [R] i32, rows [Kp, R] f32 or None).
    """
    dev = origins.device
    R = origins.shape[0]
    _require(R % TILE_RAYS == 0, f"R must be a multiple of {TILE_RAYS}")
    tiles = R // TILE_RAYS
    L = tables.n.shape[0]
    _check_rays("origins", origins, dev, R)
    _check_rays("dirs", dirs, dev, R)
    _check_tables(tables, dev)
    _check_lists(cluster_list, counts, tiles, L, dev)
    kp = 0
    if rows_table is not None:
        kp = rows_table.shape[-1]
        _require(rows_table.device == dev
                 and rows_table.dtype == torch.float32
                 and rows_table.is_contiguous()
                 and tuple(rows_table.shape) == (L, CLUSTER_SIZE, kp),
                 f"rows_table must be a contiguous float32 [{L}, 16, Kp]")

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


def occlusion_w(tables: ClusterTables, shadow_o, point, light_positions,
                cluster_list, counts):
    """K2: w-form shadow occlusion of Ll lights over R pixel lanes.

    shadow_o (biased origins), point (unbiased hit points): [R, 3] f32;
    light_positions [Ll, 3]; cluster_list [Ll*tpl, L] i32 and counts
    [Ll*tpl] i32 from bin_apex_shared.  Returns blocked [Ll*R] bool,
    light-major, False on tiles with an empty list.
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

    if dev.type == "cpu":
        return occlusion_w_plain(tables, shadow_o, point, light_positions,
                                 cluster_list, counts)
    if dev.type != "cuda":
        raise NotImplementedError(f"occlusion_w has no kernel for {dev}")

    from crt_tpu_torch.ops import cuda_lib

    lib, _ = cuda_lib.load()
    occ = torch.empty((Ll * R,), dtype=torch.bool, device=dev)
    if Ll * tpl:
        with torch.cuda.device(dev):
            err = lib.crt_occlusion_w(
                shadow_o.data_ptr(), point.data_ptr(),
                light_positions.data_ptr(), tables.n.data_ptr(),
                tables.nv0.data_ptr(), tables.m.data_ptr(),
                tables.c.data_ptr(), tables.nobf.data_ptr(),
                cluster_list.data_ptr(), counts.data_ptr(),
                L, Ll * tpl, tpl, TILE_RAYS,
                occ.data_ptr(), _cuda_stream(dev),
            )
        _raise_on(err, "occlusion_w")
        global occlusion_w_launches
        occlusion_w_launches += 1
    return occ


# ---------------------------------------------------------------------------
# The trace factory
# ---------------------------------------------------------------------------

def make_cluster_trace_fn(scene):
    """trace_fn factory for the cluster backend (``make_pallas_trace_fn``).

    ``trace(o, d, active=None) -> Hit``; ``trace.with_rows(o, d, active)
    -> (Hit, rows [K+1, R])`` with the kernel-emitted packed rows and the
    slot-rank row; ``trace.shadow_apex_w(point, shadow_o, light_positions,
    active [Ll, R], origin_slack) -> occluded [Ll, R]`` (None when R is
    not a tile multiple); ``trace.rank`` is the tables' triangle id ->
    slot rank map.  Rays are padded to a tile multiple with
    direction (0, 0, -1) and inactive lanes, as the JAX factory does.
    """
    tables = build_cluster_tables(scene)
    rows_table_cache = []

    def _trace_impl(origins, dirs, active, want_rows):
        batch_shape = origins.shape[:-1]
        o = origins.detach().reshape(-1, 3)
        d = dirs.detach().reshape(-1, 3)
        R = o.shape[0]
        pad = (-R) % TILE_RAYS
        if pad:
            o = torch.cat([o, o.new_zeros((pad, 3))])
            d = torch.cat([d, d.new_tensor([[0.0, 0.0, -1.0]]).expand(pad, 3)])
        a = None
        if active is not None:
            a = active.reshape(-1)
            if pad:
                a = torch.cat([a, a.new_zeros((pad,))])
        o = o.contiguous()
        d = d.contiguous()
        rows_table = None
        if want_rows:
            if not rows_table_cache:
                rows_table_cache.append(emit_rows_table(scene, tables))
            rows_table = rows_table_cache[0]
        cluster_list, counts = bin_rays(tables, o, d, TILE_RAYS, a)
        t, tri, rows = closest_hit(tables, o, d, cluster_list, counts,
                                   rows_table)
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

    def shadow_apex_w(point, shadow_o, light_positions, active, origin_slack):
        """Occlusion masks with in-kernel shadow directions -> [Ll, R]."""
        Ll, R = active.shape
        if R % TILE_RAYS:
            return None  # caller falls back to the generic shadow trace
        shadow_o = shadow_o.detach().contiguous()
        point = point.detach().contiguous()
        light_positions = light_positions.detach().contiguous()
        cluster_list, counts = bin_apex_shared(
            tables, shadow_o, light_positions, active, TILE_RAYS,
            origin_slack,
        )
        occ = occlusion_w(tables, shadow_o, point, light_positions,
                          cluster_list, counts)
        return occ.reshape(Ll, R)

    trace.with_rows = trace_with_rows
    trace.shadow_apex_w = shadow_apex_w
    trace.rank = tables.rank
    return trace

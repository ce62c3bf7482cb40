"""Phase A of the streaming backend: two-level binning.

Counterpart of the binning half of ``crt_tpu/ops/pallas_stream.py``
(``build_supercluster_boxes``, ``_tile_bounds``, ``lane_exact_sc_mask``,
``_member_mask``, ``_member_runs``, ``bin_pairs``, ``build_fused_table``).

Level 1 is the cluster tables' Morton clusters of 16 triangles.  Level 2:
``sc_clusters`` (<= 32) consecutive clusters form a supercluster; Morton
order keeps its box tight.  A ray tile is tested against the supercluster
boxes (a [tiles, L2] mask, a few MB at a million triangles where the
cluster backend's [tiles, L] mask and its [tiles, L, 3] intermediates are
GBs), and the member clusters only for the (tile, supercluster) pairs that
survive.  Every test is conservative, so the kernels that walk the pairs
stay exact.

The pair list is tile-major: the ``nonzero`` of the mask, rows in tile
order.  Within a tile the pairs come in ascending supercluster order or,
with ``near_first``, nearest supercluster first (a stable sort, so equally
far ones keep their index order).  Each pair carries a 32-bit mask of its
surviving members; its set bits, lowest first, are crt_tpu's 5-bit-packed
live-first permutation (a stable sort of the live members to the front is
their ascending order).

A call's list comes from ``bin_stream``: for CUDA tensors one launch of
``csrc/stream_bin.cu`` (or a raise) and a pack launch once the list's
length is read, for CPU tensors ``bin_stream_plain``, the composition of
the plain functions here, which the kernel equals bit for bit.  Its modes
(``MODES``), read from what the caller passes: "rays" (the frustum,
ascending order), "shaft_capped" (the shaft, nearest first, cut to
``per_tile_cap`` a tile), "shaft_exact" (the shaft and the per-lane test,
nearest first) and "shaft" (``lane_exact=False``).

``utils/trace.py``'s registry counts each launch as
``crt.launches.stream_bin.<mode>``, the pairs listed as
``crt.binning.pairs.supercluster`` and, in "shaft_exact", the shaft's
candidates as ``crt.binning.pairs.hull``.  The list's length is one
device-to-host read: ``crt.host_reads.stream_pairs`` a launch, and
``crt.host_reads.stream_nonzero`` each ``nonzero`` of the plain versions.
"""

from __future__ import annotations

import torch

from crt_tpu_torch.ops.binning import (
    _INF,
    _SMEM_BYTES,
    _f32_rows,
    _frustum_box_mask,
    _require,
    _sum3,
    apex_shaft_mask,
    tile_bounds,
)
from crt_tpu_torch.ops.cluster_tables import ClusterTables
from crt_tpu_torch.ops.vecmath import sqrt
from crt_tpu_torch.utils import trace as tracing

SC_CLUSTERS = 32  # default clusters per supercluster (32 x 16 = 512 tris)

# Pairs per step of the member test and of the per-lane test: bounds their
# [pairs, 32, 3] and [pairs, tile_rays, 3] temporaries.
_MEMBER_PAIR_CHUNK = 1 << 16
_LANE_PAIR_CHUNK = 1 << 13

MODES = ("rays", "shaft_capped", "shaft_exact", "shaft")
_MODE_CODE = {"rays": 0, "shaft_capped": 1, "shaft": 1,
              "shaft_exact": 2}  # csrc/stream_bin.cu


def _nonzero(mask: torch.Tensor) -> torch.Tensor:
    """``torch.nonzero``, counted as the host read it is on the card."""
    tracing.count("crt.host_reads.stream_nonzero")
    return torch.nonzero(mask)


def build_supercluster_boxes(tables: ClusterTables,
                             sc_clusters: int = SC_CLUSTERS):
    """Pad the cluster axis to a multiple of ``sc_clusters`` (pad clusters
    can never be hit or admitted) and build the supercluster boxes.

    Returns (tables_padded, sc_min [L2, 3], sc_max [L2, 3])."""
    if not 1 <= sc_clusters <= 32:
        raise ValueError("sc_clusters must be in 1..32 (a 32-bit member mask)")
    L = tables.n.shape[0]
    pad = (-L) % sc_clusters
    if pad:
        def pad0(x, fill):
            return torch.cat(
                [x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])

        tables = tables._replace(
            n=pad0(tables.n, 0.0), nv0=pad0(tables.nv0, 0.0),
            m=pad0(tables.m, 0.0), c=pad0(tables.c, 1.0),
            nobf=pad0(tables.nobf, 0.0), tri_id=pad0(tables.tri_id, -1),
            cl_min=pad0(tables.cl_min, _INF),
            cl_max=pad0(tables.cl_max, -_INF),
        )
    L2 = tables.n.shape[0] // sc_clusters
    sc_min = tables.cl_min.reshape(L2, sc_clusters, 3).amin(dim=1)
    sc_max = tables.cl_max.reshape(L2, sc_clusters, 3).amax(dim=1)
    return tables, sc_min, sc_max


def build_fused_table(tables: ClusterTables) -> torch.Tensor:
    """[L, 16, 18] f32 per-slot constants in one array: n xyz | nv0 | m (9)
    | c (3) | nobf | triangle id.  The id rides as f32, exact below 2^24
    slots; the CUDA kernels read the int32 ``tri_id`` beside it."""
    L = tables.n.shape[0]
    if L * 16 >= (1 << 24):
        raise ValueError("triangle ids are not exact in float32")
    return torch.cat([
        tables.n, tables.nv0[..., None], tables.m, tables.c,
        tables.nobf[..., None], tables.tri_id.to(torch.float32)[..., None],
    ], dim=-1).contiguous()


def pair_mask(sc_min, sc_max, bounds, apex=None, apex_slack: float = 0.0):
    """[tiles, L2] bool: which superclusters each tile's rays can reach, by
    the generic frustum or, with ``apex`` ([tiles, 3] light points), by the
    light-side shaft with its cone and wedges."""
    o_lo, o_hi, d_lo, d_hi, tile_any = bounds
    if apex is not None:
        mask = apex_shaft_mask(apex, o_lo, o_hi, apex_slack, sc_min, sc_max)
    else:
        mask = _frustum_box_mask(o_lo, o_hi, d_lo, d_hi, sc_min, sc_max)
    if tile_any is not None:
        mask = mask & tile_any[:, None]
    return mask


def lane_exact_sc_mask(origins, dirs, r2, active, slack, sc_min, sc_max,
                       tile_rays: int, where=None):
    """[tiles, L2] bool: a (tile, supercluster) pair survives iff some
    active lane's slack-inflated [origin, light] segment hits the
    supercluster's box: the exact per-lane slab test, OR-ed per tile.  A
    dropped pair has no lane whose segment (boxes inflated by the 2 * slack
    the member tests use, t capped at sqrt(r2) * (1 + 1e-4) + 2 * slack)
    touches the box, so no member hit with t^2 <= r2 was possible.

    ``where`` ([tiles, L2] bool) names the pairs worth testing, the rest
    come out False: the shaft hull's survivors, since the caller ANDs the
    two masks.  The test runs pair by pair (chunked), so its cost follows
    the candidates and not tiles x L2."""
    tiles = origins.shape[0] // tile_rays
    L2 = sc_min.shape[0]
    dev = origins.device
    s = float(torch.tensor(slack, dtype=torch.float32))
    scale = float(torch.tensor(1.0 + 1e-4, dtype=torch.float32))
    tmax = sqrt(torch.clamp(r2, min=0.0)) * scale + 2.0 * s
    if active is not None:
        tmax = torch.where(active, tmax, -torch.ones_like(tmax))
    o_t = origins.reshape(tiles, tile_rays, 3)
    d_t = dirs.reshape(tiles, tile_rays, 3)
    t_t = tmax.reshape(tiles, tile_rays)
    small_t = d_t.abs() < 1e-12
    dsafe_t = torch.where(small_t, torch.ones_like(d_t), d_t)
    bmin = sc_min - 2.0 * s
    bmax = sc_max + 2.0 * s
    inf = torch.full((), _INF, dtype=origins.dtype, device=dev)

    out = torch.zeros((tiles, L2), dtype=torch.bool, device=dev)
    if where is None:
        where = torch.ones_like(out)
    cand = _nonzero(where)
    for k in range(0, cand.shape[0], _LANE_PAIR_CHUNK):
        ti, si = cand[k:k + _LANE_PAIR_CHUNK].unbind(dim=1)
        o, dsafe, sm = o_t[ti], dsafe_t[ti], small_t[ti]  # [P, TR, 3]
        bm, bx = bmin[si][:, None, :], bmax[si][:, None, :]  # [P, 1, 3]
        t1 = (bm - o) / dsafe
        t2 = (bx - o) / dsafe
        tlo = torch.minimum(t1, t2)
        thi = torch.maximum(t1, t2)
        inside = (o >= bm) & (o <= bx)
        # a lane parallel to a slab is inside it for every t or for none
        tlo = torch.where(sm & inside, -inf, torch.where(sm & ~inside, inf,
                                                         tlo))
        thi = torch.where(sm & inside, inf, torch.where(sm & ~inside, -inf,
                                                        thi))
        ent = tlo.amax(dim=-1)
        ext = thi.amin(dim=-1)
        hit = (ent <= ext) & (ext >= 0.0) & (ent <= t_t[ti])
        out[ti, si] = hit.any(dim=1)
    return out


def _member_mask(bounds, pair_tile, pair_sc, cl_min, cl_max, sc: int,
                 apex=None, apex_slack: float = 0.0):
    """[P, sc] bool: which member clusters of each pair its tile can reach,
    by the test that admitted the pair (``pair_mask``) against the member
    clusters' own boxes."""
    o_lo, o_hi, d_lo, d_hi, _ = bounds
    L2 = cl_min.shape[0] // sc
    mb_min = cl_min.reshape(L2, sc, 3)[pair_sc]  # [P, sc, 3]
    mb_max = cl_max.reshape(L2, sc, 3)[pair_sc]
    if apex is None:
        return _frustum_box_mask(o_lo[pair_tile], o_hi[pair_tile],
                                 d_lo[pair_tile], d_hi[pair_tile],
                                 mb_min, mb_max)
    return apex_shaft_mask(apex[pair_tile], o_lo[pair_tile], o_hi[pair_tile],
                           apex_slack, mb_min, mb_max)


def _member_runs(bounds, pair_tile, pair_sc, cl_min, cl_max, sc: int,
                 apex=None, apex_slack: float = 0.0):
    """(count [P] i32, bits [P] i32) of each pair's live members: bit m of
    ``bits`` is set when member cluster m survives ``_member_mask``.  Run
    in chunks of pairs."""
    dev = pair_tile.device
    weights = torch.ones((), dtype=torch.int64, device=dev) << torch.arange(
        sc, device=dev)
    counts, bits = [], []
    for k in range(0, pair_tile.shape[0], _MEMBER_PAIR_CHUNK):
        member = _member_mask(bounds, pair_tile[k:k + _MEMBER_PAIR_CHUNK],
                              pair_sc[k:k + _MEMBER_PAIR_CHUNK], cl_min,
                              cl_max, sc, apex, apex_slack)
        counts.append(member.sum(dim=1, dtype=torch.int32))
        word = (member * weights).sum(dim=1)  # < 2^32, in int64
        # the same 32 bits as a (signed) int32
        bits.append(torch.where(word >= 1 << 31, word - (1 << 32),
                                word).to(torch.int32))
    if not counts:
        empty = torch.zeros((0,), dtype=torch.int32, device=dev)
        return empty, empty.clone()
    return torch.cat(counts), torch.cat(bits)


def bin_pairs(sc_min, sc_max, bounds, apex=None, apex_slack: float = 0.0,
              near_first: bool = False, per_tile_cap: int | None = None,
              extra_mask=None):
    """Tile-major (tile, supercluster) interaction pairs of a wavefront
    whose per-tile ``bounds`` are ``binning.tile_bounds``'.

    ``near_first`` orders each tile's superclusters by the distance of
    their box centre from the tile's origin-box centre (an any-hit walk
    then finds its blockers early; the result of a complete walk does not
    depend on the order).  ``per_tile_cap`` keeps only each tile's nearest
    that many: a deliberately incomplete list, phase 1 of the two-phase
    shadow resolve.  ``extra_mask`` ([tiles, L2]) is ANDed in before
    either (``lane_exact_sc_mask``).

    Returns (pair_tile [P] i64, pair_sc [P] i64, tile_start [tiles + 1]
    i32): tile i owns pairs tile_start[i] .. tile_start[i + 1] - 1.
    """
    mask = pair_mask(sc_min, sc_max, bounds, apex, apex_slack)
    if extra_mask is not None:
        mask = mask & extra_mask
    if near_first:
        o_lo, o_hi = bounds[0], bounds[1]
        o_c = 0.5 * (o_lo + o_hi)  # [tiles, 3]
        sc_c = 0.5 * (sc_min + sc_max)  # [L2, 3]
        dist = _sum3((sc_c[None, :, :] - o_c[:, None, :]) ** 2)
        far = torch.full((), _INF, dtype=dist.dtype, device=dist.device)
        ord_d = torch.sort(torch.where(mask, dist, far), dim=1,
                           stable=True).indices  # live, nearest first
        mask = torch.gather(mask, 1, ord_d)
        if per_tile_cap is not None:
            mask = mask & (torch.arange(mask.shape[1], device=mask.device)[None]
                           < per_tile_cap)
    elif per_tile_cap is not None:
        raise ValueError("per_tile_cap needs near_first")
    per_tile = mask.sum(dim=1)
    tile_start = torch.cat([per_tile.new_zeros((1,)),
                            per_tile.cumsum(dim=0)]).to(torch.int32)
    pair_tile, rank = _nonzero(mask).unbind(dim=1)
    pair_sc = ord_d[pair_tile, rank] if near_first else rank
    tracing.count("crt.binning.pairs.supercluster", pair_tile.shape[0])
    return pair_tile, pair_sc, tile_start


def pair_list(sc_min, sc_max, cl_min, cl_max, bounds, apex=None,
              apex_slack: float = 0.0, **bin_kw):
    """``bin_pairs``' pairs of a wavefront whose per-tile ``bounds`` are
    ``tile_bounds``', as the kernels' list arguments -> (pair_sc [P] i32,
    pair_bits [P] i32, tile_start [tiles + 1] i32): each pair's member
    mask from ``_member_runs`` over the cluster boxes ``cl_min`` /
    ``cl_max`` ([L2 * sc, 3])."""
    pair_tile, pair_sc, tile_start = bin_pairs(sc_min, sc_max, bounds, apex,
                                               apex_slack, **bin_kw)
    _, bits = _member_runs(bounds, pair_tile, pair_sc, cl_min, cl_max,
                           cl_min.shape[0] // sc_min.shape[0], apex,
                           apex_slack)
    return pair_sc.to(torch.int32), bits, tile_start


def stream_mode(apex, per_tile_cap, lane_exact: bool) -> str:
    """The mode of a call (``MODES``): "rays" without ``apex``; with it,
    "shaft_capped" where ``per_tile_cap`` is given, else "shaft_exact" or,
    without ``lane_exact``, "shaft"."""
    if apex is None:
        _require(per_tile_cap is None, "per_tile_cap needs an apex")
        return "rays"
    if per_tile_cap is not None:
        return "shaft_capped"
    return "shaft_exact" if lane_exact else "shaft"


def bin_stream_plain(sc_min, sc_max, cl_min, cl_max, origins, dirs,
                     tile_rays: int, active=None, apex=None,
                     apex_slack: float = 0.0, r2=None, per_tile_cap=None,
                     lane_exact: bool = True):
    """Plain version of ``bin_stream``: ``tile_bounds``, then ``pair_list``
    of the mode's mask, ANDed in "shaft_exact" with ``lane_exact_sc_mask``
    over the shaft hull's survivors."""
    mode = stream_mode(apex, per_tile_cap, lane_exact)
    bounds = tile_bounds(origins, dirs, tile_rays, active)
    extra = None
    if mode == "shaft_exact":
        hull = pair_mask(sc_min, sc_max, bounds, apex, apex_slack)
        tracing.count("crt.binning.pairs.hull", hull)
        extra = lane_exact_sc_mask(origins, dirs, r2, active, apex_slack,
                                   sc_min, sc_max, tile_rays, where=hull)
    return pair_list(sc_min, sc_max, cl_min, cl_max, bounds, apex,
                     apex_slack, near_first=apex is not None,
                     per_tile_cap=per_tile_cap, extra_mask=extra)


def bin_stream(sc_min, sc_max, cl_min, cl_max, origins, dirs,
               tile_rays: int, active=None, apex=None,
               apex_slack: float = 0.0, r2=None, per_tile_cap=None,
               lane_exact: bool = True):
    """Phase A of one launch of the streaming kernels -> (pair_sc [P] i32,
    pair_bits [P] i32, tile_start [tiles + 1] i32): tile i owns pairs
    tile_start[i] .. tile_start[i + 1] - 1.

    sc_min, sc_max [L2, 3] supercluster boxes; cl_min, cl_max [L2 * sc, 3]
    their member clusters' boxes; origins, dirs [R, 3] f32, R % tile_rays
    == 0; active [R] bool or None; apex [tiles, 3] (the light of each tile:
    the shaft modes), apex_slack; r2 [R] f32 (squared reach: "shaft_exact"
    only).  The mode (``stream_mode``) follows ``apex``, ``per_tile_cap``
    and ``lane_exact``.  Launches ``csrc/stream_bin.cu`` for CUDA tensors
    (or raises) and takes ``bin_stream_plain`` for CPU tensors.
    """
    mode = stream_mode(apex, per_tile_cap, lane_exact)
    dev = origins.device
    if dev.type == "cpu":
        return bin_stream_plain(sc_min, sc_max, cl_min, cl_max, origins,
                                dirs, tile_rays, active, apex, apex_slack,
                                r2, per_tile_cap, lane_exact)
    if dev.type != "cuda":
        raise NotImplementedError(f"bin_stream has no kernel for {dev}")
    from crt_tpu_torch.ops import cuda_lib
    from crt_tpu_torch.ops.cluster_trace import _cuda_stream, _raise_on

    R = origins.shape[0]
    _require(tile_rays > 0 and R % tile_rays == 0,
             f"R = {R} must be a multiple of tile_rays = {tile_rays}")
    tiles = R // tile_rays
    L2 = sc_min.shape[0]
    _require(L2 > 0 and cl_min.shape[0] % L2 == 0
             and 1 <= cl_min.shape[0] // L2 <= 32,
             "cl_min must hold 1 to 32 clusters a supercluster")
    sc = cl_min.shape[0] // L2
    sc_min, sc_max = (_f32_rows(n, x, L2, dev) for n, x in
                      (("sc_min", sc_min), ("sc_max", sc_max)))
    cl_min, cl_max = (_f32_rows(n, x, L2 * sc, dev) for n, x in
                      (("cl_min", cl_min), ("cl_max", cl_max)))
    o = _f32_rows("origins", origins, R, dev)
    d = (None if mode in ("shaft", "shaft_capped")
         else _f32_rows("dirs", dirs, R, dev))
    ap = None if apex is None else _f32_rows("apex", apex, tiles, dev)
    rr = None
    if mode == "shaft_exact":
        _require(r2.device == dev and r2.dtype == torch.float32
                 and tuple(r2.shape) == (R,),
                 f"r2 must be a float32 [{R}] on {dev}")
        rr = r2.contiguous()
    a = None
    if active is not None:
        _require(active.device == dev and active.dtype == torch.bool
                 and tuple(active.shape) == (R,),
                 f"active must be a bool [{R}] on {dev}")
        a = active.contiguous()

    width = L2 if per_tile_cap is None else max(0, min(per_tile_cap, L2))
    words = -(-L2 // 256) * 8  # the kernel's bitsets: 8 words a 256
    bits = 4 * words * (2 if mode == "shaft_exact" else 1)
    _require(bits <= _SMEM_BYTES,
             f"{L2} superclusters exceed a block's shared memory")
    i32 = dict(dtype=torch.int32, device=dev)
    if not tiles:
        none = torch.empty((0,), **i32)
        return none, none.clone(), torch.zeros((1,), **i32)
    gkeys = None  # the sort keys, in shared memory where they fit
    if mode != "rays" and bits + 8 * L2 > _SMEM_BYTES:
        gkeys = torch.empty((tiles, L2), dtype=torch.int64, device=dev)
    rows = torch.empty((tiles, width), **i32)
    bounds = torch.empty((tiles, 12), dtype=torch.float32, device=dev)
    counts = torch.empty((tiles,), **i32)
    tile_start = torch.empty((tiles + 1,), **i32)
    sync = torch.empty((2,), **i32)
    s = float(torch.tensor(apex_slack, dtype=torch.float32))

    def ptr(x):
        return None if x is None else x.data_ptr()

    lib, _ = cuda_lib.load()
    with torch.cuda.device(dev):
        err = lib.crt_stream_bin(
            o.data_ptr(), ptr(d), ptr(rr), ptr(a), ptr(ap), sc_min.data_ptr(),
            sc_max.data_ptr(), _MODE_CODE[mode], L2, tiles, tile_rays, width,
            -1 if per_tile_cap is None else width, s, ptr(gkeys),
            rows.data_ptr(), bounds.data_ptr(), counts.data_ptr(),
            tile_start.data_ptr(), sync.data_ptr(), _cuda_stream(dev))
    _raise_on(err, "stream_bin")
    tracing.count("crt.launches.stream_bin." + mode)
    if mode == "shaft_exact":
        tracing.count("crt.binning.pairs.hull", sync[1:])
    tracing.count("crt.host_reads.stream_pairs")
    P = int(tile_start[-1])
    pair_sc = torch.empty((P,), **i32)
    pair_bits = torch.empty((P,), **i32)
    if P:
        with torch.cuda.device(dev):
            err = lib.crt_stream_pack(
                rows.data_ptr(), bounds.data_ptr(), counts.data_ptr(),
                tile_start.data_ptr(), ptr(ap), cl_min.data_ptr(),
                cl_max.data_ptr(), int(mode != "rays"), sc, tiles, width, s,
                pair_sc.data_ptr(), pair_bits.data_ptr(), _cuda_stream(dev))
        _raise_on(err, "stream_bin")
    tracing.count("crt.binning.pairs.supercluster", P)
    return pair_sc, pair_bits, tile_start

"""Phase A: per-tile frustums binned against cluster boxes.

Counterpart of the binning half of ``crt_tpu/ops/pallas_trace.py``
(``_frustum_box_mask``, ``_apex_cone_mask``, ``_apex_wedge_mask``,
``bin_rays`` with its ``apex`` mode, ``bin_apex_shared``).  Rays come in tiles of 1024
consecutive lanes (32x32 pixel blocks, so tiles are spatially coherent).
Each tile gets a conservative frustum; every frustum is tested against
every cluster box; the clusters a tile may hit are compacted to the front
of its list in cluster-index (Morton) order.  Conservative tests only ever
add clusters, so the kernels that walk the lists stay exact.

The walk order is the stable sort of ``~mask``: exact-t ties across
clusters go to the first cluster walked, so the order is part of the
result.

``bin_rays`` and ``bin_apex_shared`` launch one CUDA kernel a call for
CUDA tensors (``csrc/cluster_bin.cu``, or raise) and take their plain
PyTorch versions, ``bin_rays_plain`` and ``bin_apex_shared_plain``, only
for CPU tensors.  The kernel keeps the plain versions' float32 operations
in their order, so on the card the lists and counts are theirs bit for
bit.  ``utils/trace.py``'s registry counts each launch as
``crt.launches.cluster_bin.<rays | apex | shared | shared_uncapped |
shared_glass>``.  The streaming backend's Phase A has a kernel of its own
(``stream_binning.bin_stream``, ``csrc/stream_bin.cu``); its plain version
calls ``_frustum_box_mask``, ``apex_shaft_mask`` and ``tile_bounds``
directly, over per-row boxes.  Both kernels take these tests from
``csrc/bin_common.cuh``.
"""

from __future__ import annotations

import torch

from crt_tpu_torch.ops.cluster_tables import TILE_RAYS, ClusterTables
from crt_tpu_torch.ops.vecmath import sqrt
from crt_tpu_torch.utils import trace as tracing

_INF = 3.4e38  # the finite "infinity" the JAX binning uses


def _sum3(x: torch.Tensor) -> torch.Tensor:
    """Sum over a trailing axis of 3, left to right."""
    return x[..., 0] + x[..., 1] + x[..., 2]


def _per_row(boxes: torch.Tensor) -> torch.Tensor:
    """Boxes as [rows, L, 3]: shared [L, 3] boxes get a broadcast row axis,
    per-row boxes ([rows, L, 3], the streaming member test) pass as is."""
    return boxes if boxes.dim() == 3 else boxes[None]


def _compact(mask: torch.Tensor):
    """[tiles, L] bool -> (cluster_list [tiles, L] i32, counts [tiles] i32):
    admitted clusters first, each group in cluster-index order."""
    key = (~mask).to(torch.int32)
    order = torch.argsort(key, dim=1, stable=True).to(torch.int32)
    counts = mask.sum(dim=1).to(torch.int32)
    return order.contiguous(), counts


def _counted(lists):
    """``_compact``'s lists, their (tile, cluster) pairs counted."""
    tracing.count("crt.binning.pairs.cluster", lists[1])
    return lists


def _frustum_box_mask(o_lo, o_hi, d_lo, d_hi, bmin, bmax, t_cap=None,
                      t_lo_clamp: bool = True):
    """Conservative interval slab test: [tiles] frustums vs [L] boxes
    (or each against its own [tiles, L] boxes).

    True where ANY ray with origin in [o_lo, o_hi] and direction in
    [d_lo, d_hi] (componentwise) could hit box [bmin, bmax] at t >= 0 (or,
    with ``t_lo_clamp=False``, anywhere on the full line below ``t_cap``,
    by four-corner interval division).  ``t_cap`` (scalar, in the
    interval's own direction scale) also requires the earliest possible
    entry at t <= t_cap.
    """
    o_lo = o_lo[:, None, :]
    o_hi = o_hi[:, None, :]
    d_lo = d_lo[:, None, :]
    d_hi = d_hi[:, None, :]
    bmin = _per_row(bmin)
    bmax = _per_row(bmax)
    one = torch.ones((), dtype=d_lo.dtype, device=d_lo.device)
    inf = torch.full((), _INF, dtype=d_lo.dtype, device=d_lo.device)

    pos = d_lo > 0.0
    neg = d_hi < 0.0
    if t_lo_clamp:
        ent_pos = (bmin - o_hi) / torch.where(pos, d_hi, one)
        ext_pos = (bmax - o_lo) / torch.where(pos, d_lo, one)
        ent_neg = (bmax - o_lo) / torch.where(neg, d_lo, one)
        ext_neg = (bmin - o_hi) / torch.where(neg, d_hi, one)
        t_ent = torch.where(pos, ent_pos, torch.where(neg, ent_neg, -inf))
        t_ext = torch.where(pos, ext_pos, torch.where(neg, ext_neg, inf))
        t_ent = torch.clamp(t_ent, min=0.0)
    else:
        definite = pos | neg
        safe_lo = torch.where(definite, d_lo, one)
        safe_hi = torch.where(definite, d_hi, one)
        n_lo = bmin - o_hi
        n_hi = bmax - o_lo
        c1 = n_lo / safe_lo
        c2 = n_lo / safe_hi
        c3 = n_hi / safe_lo
        c4 = n_hi / safe_hi
        tlo = torch.minimum(torch.minimum(c1, c2), torch.minimum(c3, c4))
        thi = torch.maximum(torch.maximum(c1, c2), torch.maximum(c3, c4))
        t_ent = torch.where(definite, tlo, -inf)
        t_ext = torch.where(definite, thi, inf)

    t_ent_max = t_ent.amax(dim=-1)
    ok = t_ent_max <= t_ext.amin(dim=-1)
    if t_cap is not None:
        ok = ok & (t_ent_max <= t_cap)
    return ok


def _apex_cone_mask(apex, w_lo, w_hi, cl_min, cl_max, slack):
    """Bounding-cone refinement of the apex shadow shaft -> [tiles, L] bool.

    Shaft subset of the cone over the direction box's bounding ball, and
    cluster box subset of its ball: a sphere-vs-cone test that only drops
    clusters no segment [origin, light] can reach.
    """
    tiny = 1e-12
    c_w = 0.5 * (w_lo + w_hi)  # [tiles, 3]
    r_w = 0.5 * sqrt(_sum3((w_hi - w_lo) ** 2) + tiny)
    len_w = sqrt(_sum3(c_w ** 2) + tiny)
    sin_a = torch.clamp(r_w / len_w, 0.0, 1.0)
    cos_a = sqrt(torch.clamp(1.0 - sin_a * sin_a, min=0.0))
    axis = c_w / len_w[..., None]

    cl_min, cl_max = _per_row(cl_min), _per_row(cl_max)
    bc = 0.5 * (cl_min + cl_max) - apex[:, None, :]  # [tiles, L, 3]
    r_b = 0.5 * sqrt(_sum3((cl_max - cl_min) ** 2)) + 2.0 * slack
    vproj = _sum3(bc * axis[:, None, :])  # [tiles, L]
    d_ax = sqrt(torch.clamp(_sum3(bc * bc) - vproj * vproj, min=0.0))
    e = cos_a[:, None] * d_ax - sin_a[:, None] * vproj
    ok = e <= r_b
    # degenerate shaft (apex inside the inflated origin box): pass all
    return ok | (len_w <= r_w * 1.0001)[:, None]


def _apex_wedge_mask(apex, w_lo, w_hi, cl_min, cl_max, slack):
    """Projected 2-D wedge refinement of the apex shaft -> [tiles, L] bool.

    For each axis pair with the direction box sign-definite in the
    denominator axis, every shaft direction's ratio w_i / w_j lies in the
    box's ratio interval; a cluster whose (apex-relative, inflated) ratio
    interval is disjoint cannot be reached.
    """
    b_lo = _per_row(cl_min) - 2.0 * slack - apex[:, None, :]
    b_hi = _per_row(cl_max) + 2.0 * slack - apex[:, None, :]
    ok = torch.ones(b_lo.shape[:2], dtype=torch.bool, device=apex.device)
    one = torch.ones((), dtype=w_lo.dtype, device=w_lo.device)
    for i, j in ((0, 1), (0, 2), (1, 2)):
        for num, den in ((i, j), (j, i)):
            d_lo, d_hi = w_lo[:, den], w_hi[:, den]  # [tiles]
            n_lo, n_hi = w_lo[:, num], w_hi[:, num]
            pos = d_lo > 0.0
            neg = d_hi < 0.0
            definite = pos | neg
            safe_lo = torch.where(definite, d_lo, one)
            safe_hi = torch.where(definite, d_hi, one)
            r = torch.stack([n_lo / safe_lo, n_lo / safe_hi,
                             n_hi / safe_lo, n_hi / safe_hi], dim=-1)
            w_rlo, w_rhi = r.amin(dim=-1), r.amax(dim=-1)  # [tiles]
            c_nlo, c_nhi = b_lo[..., num], b_hi[..., num]  # [tiles, L]
            c_dlo, c_dhi = b_lo[..., den], b_hi[..., den]
            c_def = torch.where(pos[:, None], c_dlo > 0.0, c_dhi < 0.0)
            cs_lo = torch.where(c_def, c_dlo, one)
            cs_hi = torch.where(c_def, c_dhi, one)
            cr = torch.stack([c_nlo / cs_lo, c_nlo / cs_hi,
                              c_nhi / cs_lo, c_nhi / cs_hi], dim=-1)
            c_rlo, c_rhi = cr.amin(dim=-1), cr.amax(dim=-1)
            overlap = (c_rhi >= w_rlo[:, None]) & (c_rlo <= w_rhi[:, None])
            # cull only where both the direction box and the cluster are
            # sign-definite in the denominator axis
            ok = ok & (overlap | ~(definite[:, None] & c_def))
    return ok


def apex_shaft_mask(apex, o_lo, o_hi, slack, bmin, bmax):
    """Light-side shaft test of [tiles] origin boxes against [L] boxes ->
    [tiles, L] bool.  Every shadow ray of a tile ends at its light point
    ``apex`` ([tiles, 3]), so its reachable set is the shaft hull(origin
    box, apex): tested from the light (origin = apex, direction box =
    slack-inflated origin box - apex, t in [0, 1 + 1e-4]) against boxes
    inflated by 2 * slack, then refined by the bounding cone and the 2-D
    wedges."""
    s = float(torch.tensor(slack, dtype=torch.float32))
    w_lo = (o_lo - s) - apex
    w_hi = (o_hi + s) - apex
    cap = float(torch.tensor(1.0 + 1e-4, dtype=torch.float32))
    mask = _frustum_box_mask(apex, apex, w_lo, w_hi, bmin - 2.0 * s,
                             bmax + 2.0 * s, t_cap=cap)
    mask = mask & _apex_cone_mask(apex, w_lo, w_hi, bmin, bmax, s)
    return mask & _apex_wedge_mask(apex, w_lo, w_hi, bmin, bmax, s)


def tile_bounds(origins, dirs, tile_rays: int, active=None):
    """Per-tile (active-masked) interval bounds of a wavefront ->
    (o_lo, o_hi, d_lo, d_hi [tiles, 3], tile_any [tiles] bool or None)."""
    tiles = origins.shape[0] // tile_rays
    o = origins.reshape(tiles, tile_rays, 3)
    d = dirs.reshape(tiles, tile_rays, 3)
    if active is None:
        return (o.amin(dim=1), o.amax(dim=1), d.amin(dim=1), d.amax(dim=1),
                None)
    a = active.reshape(tiles, tile_rays, 1)
    big = torch.full((), _INF, dtype=o.dtype, device=o.device)
    return (torch.where(a, o, big).amin(dim=1),
            torch.where(a, o, -big).amax(dim=1),
            torch.where(a, d, big).amin(dim=1),
            torch.where(a, d, -big).amax(dim=1),
            a[..., 0].any(dim=1))


def bin_rays_plain(tables: ClusterTables, origins, dirs,
                   tile_rays: int = TILE_RAYS, active=None, apex=None,
                   apex_slack: float = 0.0):
    """Plain version of ``bin_rays``.  origins/dirs: [R, 3], R % tile_rays
    == 0.

    ``active`` ([R] bool or None) restricts the frustum to lanes whose
    result is consumed; a tile with no active lane gets an empty list.
    Inactive lanes still get results from whatever clusters the active
    lanes pull in.

    ``apex`` ([tiles, 3] or None) is the point-light shadow mode: each
    tile's list is its light-side shaft's (``apex_shaft_mask`` with
    ``apex_slack``); the directions are not read.

    Returns (cluster_list [tiles, L] i32, counts [tiles] i32).
    """
    o_lo, o_hi, d_lo, d_hi, tile_any = tile_bounds(origins, dirs, tile_rays,
                                                   active)
    if apex is not None:
        mask = apex_shaft_mask(apex, o_lo, o_hi, apex_slack, tables.cl_min,
                               tables.cl_max)
    else:
        mask = _frustum_box_mask(o_lo, o_hi, d_lo, d_hi, tables.cl_min,
                                 tables.cl_max)
    if tile_any is not None:
        mask = mask & tile_any[:, None]
    return _counted(_compact(mask))


def bin_apex_shared_plain(tables: ClusterTables, shadow_o, light_positions,
                          active, tile_rays: int = TILE_RAYS,
                          origin_slack: float = 0.0, boxes=None,
                          capped: bool = True, glass_boxes=None):
    """Plain version of ``bin_apex_shared``: light-side shaft binning of a
    point-light shadow wavefront.

    Every shadow ray of a tile runs from its biased origin to one light
    point P, so its reachable set is the shaft hull(origin box, P).  It is
    tested from the light side (origin = P, direction box = inflated origin
    box - P, t in [0, 1 + 1e-4]) and refined by the bounding cone and the
    2-D wedges.  Origin boxes are reduced once over the R pixel lanes
    (union-of-lights active mask) and shared by every light.

    ``boxes`` ((cl_min, cl_max)) overrides the cluster boxes, e.g. with the
    refractive-member-only boxes of ``glass_subset`` (clusters without a
    member carry +-3.4e38 boxes and are never admitted).  ``capped=False``
    drops the beyond-the-light cap: the shaft becomes the unbounded cone
    from the light through the origin box, tested by the slab alone with
    the lower clamp dropped.  ``glass_boxes`` adds, to the capped lists, the
    clusters whose glass members the full ray can reach (the one-pass march
    router walks the union).

    shadow_o: [R, 3] biased per-pixel origins; active: [Ll, R] bool.
    Returns (cluster_list [Ll*tpl, L], counts [Ll*tpl]), light-major.
    """
    Ll = light_positions.shape[0]
    R = shadow_o.shape[0]
    tpl = R // tile_rays
    big = torch.full((), _INF, dtype=shadow_o.dtype, device=shadow_o.device)
    cl_min, cl_max = boxes if boxes is not None else (tables.cl_min,
                                                      tables.cl_max)

    o = shadow_o.reshape(tpl, tile_rays, 3)
    a_any = active.any(dim=0).reshape(tpl, tile_rays, 1)
    o_lo = torch.where(a_any, o, big).amin(dim=1)  # [tpl, 3]
    o_hi = torch.where(a_any, o, -big).amax(dim=1)
    tile_any = active.reshape(Ll, tpl, tile_rays).any(dim=2).reshape(-1)

    s = float(torch.tensor(origin_slack, dtype=torch.float32))
    lp = light_positions[:, None, :]  # [Ll, 1, 3]
    w_lo = ((o_lo - s)[None] - lp).reshape(-1, 3)  # [Ll*tpl, 3]
    w_hi = ((o_hi + s)[None] - lp).reshape(-1, 3)
    apex = lp.expand(Ll, tpl, 3).reshape(-1, 3)
    cap = float(torch.tensor(1.0 + 1e-4, dtype=torch.float32))
    mask = _frustum_box_mask(
        apex, apex, w_lo, w_hi, cl_min - 2.0 * s, cl_max + 2.0 * s,
        t_cap=cap, t_lo_clamp=capped,
    )
    if capped:  # cone and wedge assume the t >= 0 side of the light
        mask = mask & _apex_cone_mask(apex, w_lo, w_hi, cl_min, cl_max, s)
        mask = mask & _apex_wedge_mask(apex, w_lo, w_hi, cl_min, cl_max, s)
    if glass_boxes is not None:
        # the added clusters lie beyond the cap, so they can add glass
        # flags but no s <= 1 blockers
        glo, ghi = glass_boxes
        mask = mask | _frustum_box_mask(
            apex, apex, w_lo, w_hi, glo - 2.0 * s, ghi + 2.0 * s,
            t_cap=cap, t_lo_clamp=False,
        )
    mask = mask & tile_any[:, None]
    return _counted(_compact(mask))


# ---------------------------------------------------------------------------
# The kernel's wrappers
# ---------------------------------------------------------------------------

# ``crt_cluster_bin``'s modes: frustum, ``apex=`` shaft, shared origin box
_RAYS, _APEX, _SHARED = 0, 1, 2
_SMEM_BYTES = 227 * 1024  # dynamic shared memory a block may take


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def _f32_rows(name, x, rows, device):
    """``x`` as a contiguous float32 [rows, 3] on ``device`` (no copy when
    it is one already)."""
    _require(x.device == device and x.dtype == torch.float32
             and tuple(x.shape) == (rows, 3),
             f"{name} must be a float32 [{rows}, 3] on {device}")
    return x.contiguous()


def _launch(mode: int, tables: ClusterTables, o, d, active, apex, boxes,
            glass_boxes, tiles: int, tile_rays: int, lights: int,
            capped: bool, slack: float):
    """One launch of ``crt_cluster_bin`` -> (cluster_list [lights * tiles,
    L] i32, counts [lights * tiles] i32), the pairs counted.  The launch
    counts as ``crt.launches.cluster_bin.<rays | apex | shared |
    shared_uncapped | shared_glass>``."""
    from crt_tpu_torch.ops import cuda_lib
    from crt_tpu_torch.ops.cluster_trace import _cuda_stream, _raise_on

    dev = o.device
    L = tables.cl_min.shape[0]
    bmin, bmax = (_f32_rows(n, x, L, dev)
                  for n, x in zip(("box min", "box max"), boxes))
    gmin = gmax = None
    if glass_boxes is not None:
        gmin, gmax = (_f32_rows(n, x, L, dev) for n, x in
                      zip(("glass box min", "glass box max"), glass_boxes))
    masks = 0 if active is None else active.shape[0]
    words = -(-L // 256) * 8  # the kernel's bitset: 8 words a 256 clusters
    _require(4 * (words + masks) <= _SMEM_BYTES,
             f"{L} clusters and {masks} masks exceed a block's shared memory")
    s = float(torch.tensor(slack, dtype=torch.float32))

    lib, _ = cuda_lib.load()
    rows = lights * tiles
    cluster_list = torch.empty((rows, L), dtype=torch.int32, device=dev)
    counts = torch.empty((rows,), dtype=torch.int32, device=dev)
    if rows:
        with torch.cuda.device(dev):
            err = lib.crt_cluster_bin(
                o.data_ptr(), d.data_ptr() if d is not None else None,
                active.data_ptr() if active is not None else None,
                apex.data_ptr() if apex is not None else None,
                bmin.data_ptr(), bmax.data_ptr(),
                gmin.data_ptr() if gmin is not None else None,
                gmax.data_ptr() if gmax is not None else None,
                mode, L, tiles, tile_rays, lights,
                masks, int(capped), s,
                cluster_list.data_ptr(), counts.data_ptr(), _cuda_stream(dev),
            )
        _raise_on(err, "cluster_bin")
        name = ("rays", "apex", "shared")[mode]
        if glass_boxes is not None:
            name += "_glass"
        elif not capped:
            name += "_uncapped"
        tracing.count("crt.launches.cluster_bin." + name)
    return _counted((cluster_list, counts))


def _check_lanes(origins, tile_rays: int) -> int:
    """Tiles of a wavefront of ``origins`` [R, 3] (R % tile_rays == 0)."""
    R = origins.shape[0]
    _require(tile_rays > 0 and R % tile_rays == 0,
             f"R = {R} must be a multiple of tile_rays = {tile_rays}")
    return R // tile_rays


def _bool_mask(active, shape, device):
    _require(active.device == device and active.dtype == torch.bool
             and tuple(active.shape) == shape,
             f"active must be a bool {list(shape)} on {device}")
    return active.contiguous()


@tracing.spanned("crt.binning")
def bin_rays(tables: ClusterTables, origins, dirs, tile_rays: int = TILE_RAYS,
             active=None, apex=None, apex_slack: float = 0.0):
    """Generic frustum binning.  origins/dirs: [R, 3], R % tile_rays == 0.

    ``active`` ([R] bool or None) restricts the frustum to lanes whose
    result is consumed; a tile with no active lane gets an empty list.
    ``apex`` ([tiles, 3] or None) is the point-light shadow mode (the
    directions are not read).  See ``bin_rays_plain``.

    Returns (cluster_list [tiles, L] i32, counts [tiles] i32).
    """
    dev = origins.device
    if dev.type == "cpu":
        return bin_rays_plain(tables, origins, dirs, tile_rays, active, apex,
                              apex_slack)
    if dev.type != "cuda":
        raise NotImplementedError(f"bin_rays has no kernel for {dev}")
    tiles = _check_lanes(origins, tile_rays)
    R = origins.shape[0]
    o = _f32_rows("origins", origins, R, dev)
    d = None if apex is not None else _f32_rows("dirs", dirs, R, dev)
    a = None if active is None else _bool_mask(active, (R,), dev)[None]
    ap = None if apex is None else _f32_rows("apex", apex, tiles, dev)
    return _launch(_RAYS if apex is None else _APEX, tables, o, d, a, ap,
                   (tables.cl_min, tables.cl_max), None, tiles, tile_rays, 1,
                   True, apex_slack)


@tracing.spanned("crt.binning")
def bin_apex_shared(tables: ClusterTables, shadow_o, light_positions, active,
                    tile_rays: int = TILE_RAYS, origin_slack: float = 0.0,
                    boxes=None, capped: bool = True, glass_boxes=None):
    """Light-side shaft binning of a point-light shadow wavefront, shared
    origin boxes for every light (see ``bin_apex_shared_plain``).

    shadow_o: [R, 3] biased per-pixel origins; active: [Ll, R] bool.
    Returns (cluster_list [Ll*tpl, L], counts [Ll*tpl]), light-major.
    """
    dev = shadow_o.device
    if dev.type == "cpu":
        return bin_apex_shared_plain(tables, shadow_o, light_positions,
                                     active, tile_rays, origin_slack, boxes,
                                     capped, glass_boxes)
    if dev.type != "cuda":
        raise NotImplementedError(f"bin_apex_shared has no kernel for {dev}")
    tpl = _check_lanes(shadow_o, tile_rays)
    R = shadow_o.shape[0]
    Ll = light_positions.shape[0]
    o = _f32_rows("shadow_o", shadow_o, R, dev)
    lp = _f32_rows("light_positions", light_positions, Ll, dev)
    a = _bool_mask(active, (Ll, R), dev)
    return _launch(_SHARED, tables, o, None, a, lp,
                   boxes if boxes is not None
                   else (tables.cl_min, tables.cl_max),
                   glass_boxes, tpl, tile_rays, Ll, capped, origin_slack)

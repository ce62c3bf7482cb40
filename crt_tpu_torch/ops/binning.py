"""Phase A: per-tile frustums binned against cluster boxes, in plain torch.

Counterpart of the binning half of ``crt_tpu/ops/pallas_trace.py``
(``_frustum_box_mask``, ``_apex_cone_mask``, ``_apex_wedge_mask``,
``bin_rays``, ``bin_apex_shared``).  Rays come in tiles of 1024
consecutive lanes (32x32 pixel blocks, so tiles are spatially coherent).
Each tile gets a conservative frustum; every frustum is tested against
every cluster box; the clusters a tile may hit are compacted to the front
of its list in cluster-index (Morton) order.  Conservative tests only ever
add clusters, so the kernels that walk the lists stay exact.

The walk order is the stable sort of ``~mask``: exact-t ties across
clusters go to the first cluster walked, so the order is part of the
result.
"""

from __future__ import annotations

import torch

from crt_tpu_torch.ops.cluster_tables import TILE_RAYS, ClusterTables
from crt_tpu_torch.ops.vecmath import sqrt

_INF = 3.4e38  # the finite "infinity" the JAX binning uses


def _sum3(x: torch.Tensor) -> torch.Tensor:
    """Sum over a trailing axis of 3, left to right."""
    return x[..., 0] + x[..., 1] + x[..., 2]


def _compact(mask: torch.Tensor):
    """[tiles, L] bool -> (cluster_list [tiles, L] i32, counts [tiles] i32):
    admitted clusters first, each group in cluster-index order."""
    key = (~mask).to(torch.int32)
    order = torch.argsort(key, dim=1, stable=True).to(torch.int32)
    counts = mask.sum(dim=1).to(torch.int32)
    return order.contiguous(), counts


def _frustum_box_mask(o_lo, o_hi, d_lo, d_hi, bmin, bmax, t_cap=None,
                      t_lo_clamp: bool = True):
    """Conservative interval slab test: [tiles] frustums vs [L] boxes.

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
    bmin = bmin[None]  # [1, L, 3], shared by every tile
    bmax = bmax[None]
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

    bc = 0.5 * (cl_min + cl_max)[None, :, :] - apex[:, None, :]  # [t, L, 3]
    r_b = (
        0.5 * sqrt(_sum3((cl_max - cl_min) ** 2))[None, :]
        + 2.0 * slack
    )
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
    ok = torch.ones((apex.shape[0], cl_min.shape[0]), dtype=torch.bool,
                    device=apex.device)
    b_lo = cl_min[None, :, :] - 2.0 * slack - apex[:, None, :]
    b_hi = cl_max[None, :, :] + 2.0 * slack - apex[:, None, :]
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


def bin_rays(tables: ClusterTables, origins, dirs, tile_rays: int = TILE_RAYS,
             active=None):
    """Generic frustum binning.  origins/dirs: [R, 3], R % tile_rays == 0.

    ``active`` ([R] bool or None) restricts the frustum to lanes whose
    result is consumed; a tile with no active lane gets an empty list.
    Inactive lanes still get results from whatever clusters the active
    lanes pull in.

    Returns (cluster_list [tiles, L] i32, counts [tiles] i32).
    """
    tiles = origins.shape[0] // tile_rays
    o = origins.reshape(tiles, tile_rays, 3)
    d = dirs.reshape(tiles, tile_rays, 3)
    if active is None:
        o_lo, o_hi = o.amin(dim=1), o.amax(dim=1)
        d_lo, d_hi = d.amin(dim=1), d.amax(dim=1)
        tile_any = None
    else:
        a = active.reshape(tiles, tile_rays, 1)
        big = torch.full((), _INF, dtype=o.dtype, device=o.device)
        o_lo = torch.where(a, o, big).amin(dim=1)
        o_hi = torch.where(a, o, -big).amax(dim=1)
        d_lo = torch.where(a, d, big).amin(dim=1)
        d_hi = torch.where(a, d, -big).amax(dim=1)
        tile_any = a[..., 0].any(dim=1)

    mask = _frustum_box_mask(o_lo, o_hi, d_lo, d_hi, tables.cl_min,
                             tables.cl_max)
    if tile_any is not None:
        mask = mask & tile_any[:, None]
    return _compact(mask)


def bin_apex_shared(tables: ClusterTables, shadow_o, light_positions, active,
                    tile_rays: int = TILE_RAYS, origin_slack: float = 0.0):
    """Light-side shaft binning of a point-light shadow wavefront.

    Every shadow ray of a tile runs from its biased origin to one light
    point P, so its reachable set is the shaft hull(origin box, P).  It is
    tested from the light side (origin = P, direction box = inflated origin
    box - P, t in [0, 1 + 1e-4]) and refined by the bounding cone and the
    2-D wedges.  Origin boxes are reduced once over the R pixel lanes
    (union-of-lights active mask) and shared by every light.

    shadow_o: [R, 3] biased per-pixel origins; active: [Ll, R] bool.
    Returns (cluster_list [Ll*tpl, L], counts [Ll*tpl]), light-major.
    """
    Ll = light_positions.shape[0]
    R = shadow_o.shape[0]
    tpl = R // tile_rays
    big = torch.full((), _INF, dtype=shadow_o.dtype, device=shadow_o.device)

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
        apex, apex, w_lo, w_hi,
        tables.cl_min - 2.0 * s, tables.cl_max + 2.0 * s, t_cap=cap,
    )
    mask = mask & _apex_cone_mask(apex, w_lo, w_hi, tables.cl_min,
                                  tables.cl_max, s)
    mask = mask & _apex_wedge_mask(apex, w_lo, w_hi, tables.cl_min,
                                   tables.cl_max, s)
    mask = mask & tile_any[:, None]
    return _compact(mask)

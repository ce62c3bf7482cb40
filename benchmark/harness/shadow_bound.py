"""The yardstick of the opaque shadow pass: the least time a frame's
point-light shadow rays need, counted by a frozen copy of the port's
cluster partition and light-side shaft binning, over hit points and
blockers from a plain float32 trace of the benchmark's own.

The rule is ``chip_smoke.walk_bound``'s, at ``harness/roofline.py``'s
peaks:

  - bytes: the triangle tables once, the shadow origin and hit point of
    every lane of each origin tile that some light's list is not empty
    for, the lights, the list counts and the listed entries, and the
    occlusion bits written for every lane of every light's tiles;
  - operations: at ``FLOPS_PER_MEMBER`` each, an active lane that nothing
    blocks tests every real member of every cluster on its tile's list,
    and a blocked lane one member, its blocker.

Frozen copies, so the count stays the same whatever later implements the
pass: the partition is ``roofline.py``'s (Morton order of the centroids,
16 to a cluster); the binning is ``bin_apex_shared`` of
``ops/binning.py`` as of its capped mode (each 32 x 32-pixel tile's
origin box over the lanes active for any light, inflated by the origin
slack, tested from the light against the cluster boxes inflated by twice
the slack for t in [0, 1 + 1e-4], then refined by the bounding cone and
the 2-D wedges).  The trace is the benchmark reference's test
(``reference.render``: the plane and the three edges, in float32): the
camera rays' closest hit over the tile's camera frustum lists (the
frustum of ``roofline.py``), a lane is active for a light where the face
normal faces it, its shadow ray leaves from the point moved by the bias
along that normal, and it is blocked where a member of its tile's shaft
list is hit within the light's distance.
"""

from __future__ import annotations

import math

import torch

from harness.roofline import (
    CLUSTER_SIZE,
    FLOPS_PER_MEMBER,
    RAY_BYTES,
    SLOT_BYTES,
    TILE,
    _frustum_box_mask,
    _part1by2,
    bound_ms,
)

# The port's shadow bias (``RenderSettings.shadow_bias``) and the binning's
# origin slack, twice the bias, when the copy was made.
SHADOW_BIAS = 1e-2
ORIGIN_SLACK = 2.0 * SHADOW_BIAS
SHAFT_CAP = 1.0 + 1e-4
_INF = 3.4e38
# Lanes x triangles of one block of the plain trace.
_PAIR_BLOCK = 1 << 22


def partition(vertices, tri_vidx):
    """Morton clusters of 16 -> (member triangle ids [L, 16], the real
    ones [L, 16] bool, box lo [L, 3], box hi [L, 3]); the boxes are
    ``roofline.cluster_boxes``'."""
    pts = vertices[tri_vidx.long()]  # [T, 3, 3]
    cen = (pts[:, 0] + pts[:, 1] + pts[:, 2]) / 3.0
    lo, hi = cen.amin(dim=0), cen.amax(dim=0)
    scale = torch.where(hi > lo, 1023.0 / (hi - lo), torch.zeros_like(hi))
    q = torch.clamp((cen - lo) * scale, 0, 1023).to(torch.int64)
    code = _part1by2(q[:, 0]) | (_part1by2(q[:, 1]) << 1) \
        | (_part1by2(q[:, 2]) << 2)
    order = torch.argsort(code, stable=True)
    T = order.shape[0]
    L = -(-T // CLUSTER_SIZE)
    pad = L * CLUSTER_SIZE - T
    ids = torch.cat([order, order[-1:].expand(pad)]) if pad else order
    real = torch.arange(L * CLUSTER_SIZE, device=ids.device) < T
    cpts = pts[ids].reshape(L, CLUSTER_SIZE * 3, 3)
    return (ids.reshape(L, CLUSTER_SIZE), real.reshape(L, CLUSTER_SIZE),
            cpts.amin(dim=1), cpts.amax(dim=1))


def _sum3(x):
    return x[..., 0] + x[..., 1] + x[..., 2]


def _sqrt(x):
    """The correctly rounded float32 square root, as the port takes it."""
    return torch.sqrt(x.double()).to(x.dtype)


def _capped_slab(apex, w_lo, w_hi, bmin, bmax):
    """Slab test from the light: origin ``apex`` [n, 3], direction box
    [w_lo, w_hi] [n, 3], against [L] boxes, t in [0, SHAFT_CAP] ->
    [n, L] bool."""
    a = apex[:, None, :]
    d_lo, d_hi = w_lo[:, None, :], w_hi[:, None, :]
    one = torch.ones((), dtype=d_lo.dtype, device=d_lo.device)
    inf = torch.full((), _INF, dtype=d_lo.dtype, device=d_lo.device)
    pos = d_lo > 0.0
    neg = d_hi < 0.0
    ent_pos = (bmin[None] - a) / torch.where(pos, d_hi, one)
    ext_pos = (bmax[None] - a) / torch.where(pos, d_lo, one)
    ent_neg = (bmax[None] - a) / torch.where(neg, d_lo, one)
    ext_neg = (bmin[None] - a) / torch.where(neg, d_hi, one)
    t_ent = torch.where(pos, ent_pos, torch.where(neg, ent_neg, -inf))
    t_ext = torch.where(pos, ext_pos, torch.where(neg, ext_neg, inf))
    t_ent = torch.clamp(t_ent, min=0.0).amax(dim=-1)
    cap = float(torch.tensor(SHAFT_CAP, dtype=torch.float32))
    return (t_ent <= t_ext.amin(dim=-1)) & (t_ent <= cap)


def _cone(apex, w_lo, w_hi, cl_min, cl_max, slack):
    """Bounding-cone refinement of the shaft -> [n, L] bool."""
    tiny = 1e-12
    c_w = 0.5 * (w_lo + w_hi)
    r_w = 0.5 * _sqrt(_sum3((w_hi - w_lo) ** 2) + tiny)
    len_w = _sqrt(_sum3(c_w ** 2) + tiny)
    sin_a = torch.clamp(r_w / len_w, 0.0, 1.0)
    cos_a = _sqrt(torch.clamp(1.0 - sin_a * sin_a, min=0.0))
    axis = c_w / len_w[..., None]
    bc = 0.5 * (cl_min + cl_max)[None] - apex[:, None, :]
    r_b = 0.5 * _sqrt(_sum3((cl_max - cl_min) ** 2))[None] + 2.0 * slack
    vproj = _sum3(bc * axis[:, None, :])
    d_ax = _sqrt(torch.clamp(_sum3(bc * bc) - vproj * vproj, min=0.0))
    ok = cos_a[:, None] * d_ax - sin_a[:, None] * vproj <= r_b
    return ok | (len_w <= r_w * 1.0001)[:, None]


def _wedges(apex, w_lo, w_hi, cl_min, cl_max, slack):
    """2-D wedge refinement of the shaft, one axis pair at a time ->
    [n, L] bool."""
    b_lo = cl_min[None] - 2.0 * slack - apex[:, None, :]
    b_hi = cl_max[None] + 2.0 * slack - apex[:, None, :]
    ok = torch.ones(b_lo.shape[:2], dtype=torch.bool, device=apex.device)
    one = torch.ones((), dtype=w_lo.dtype, device=w_lo.device)
    for i, j in ((0, 1), (0, 2), (1, 2)):
        for num, den in ((i, j), (j, i)):
            d_lo, d_hi = w_lo[:, den], w_hi[:, den]
            n_lo, n_hi = w_lo[:, num], w_hi[:, num]
            pos = d_lo > 0.0
            neg = d_hi < 0.0
            definite = pos | neg
            s_lo = torch.where(definite, d_lo, one)
            s_hi = torch.where(definite, d_hi, one)
            r = torch.stack([n_lo / s_lo, n_lo / s_hi, n_hi / s_lo,
                             n_hi / s_hi], dim=-1)
            w_rlo, w_rhi = r.amin(dim=-1), r.amax(dim=-1)
            c_nlo, c_nhi = b_lo[..., num], b_hi[..., num]
            c_dlo, c_dhi = b_lo[..., den], b_hi[..., den]
            c_def = torch.where(pos[:, None], c_dlo > 0.0, c_dhi < 0.0)
            cs_lo = torch.where(c_def, c_dlo, one)
            cs_hi = torch.where(c_def, c_dhi, one)
            cr = torch.stack([c_nlo / cs_lo, c_nlo / cs_hi, c_nhi / cs_lo,
                              c_nhi / cs_hi], dim=-1)
            c_rlo, c_rhi = cr.amin(dim=-1), cr.amax(dim=-1)
            overlap = (c_rhi >= w_rlo[:, None]) & (c_rlo <= w_rhi[:, None])
            ok = ok & (overlap | ~(definite[:, None] & c_def))
    return ok


def shaft_mask(o_lo, o_hi, light, slack, cl_min, cl_max):
    """The shafts of [n] origin boxes to their lights ([n, 3] each)
    against [L] cluster boxes -> [n, L] bool."""
    s = float(torch.tensor(slack, dtype=torch.float32))
    w_lo = (o_lo - s) - light
    w_hi = (o_hi + s) - light
    mask = _capped_slab(light, w_lo, w_hi, cl_min - 2.0 * s,
                        cl_max + 2.0 * s)
    mask = mask & _cone(light, w_lo, w_hi, cl_min, cl_max, s)
    return mask & _wedges(light, w_lo, w_hi, cl_min, cl_max, s)


class _Geometry:
    """The reference's per-triangle test: plane, three edge normals and
    constants, and back-face culling, in float32 on the device."""

    def __init__(self, ref):
        self.n, self.nv0 = ref.g_n, ref.g_nv0
        self.m, self.c = ref.g_m, ref.g_c
        self.backface = ref.t_backface

    def hits(self, o, d, tri, t_max=None):
        """t [N, K] of lanes (o, d [N, 3]) against triangles ``tri`` [K]
        (inf where missed, or beyond ``t_max`` [N] when given)."""
        n = self.n[tri]
        nd = _sum3(d[:, None] * n[None])
        opd = self.nv0[tri][None] - _sum3(o[:, None] * n[None])
        not_par = nd.abs() >= 1e-6
        ok = not_par & ((opd < 0) | ~self.backface[tri][None])
        t = opd / torch.where(not_par, nd, torch.ones_like(nd))
        ok &= t >= 0
        for m, c in zip(self.m, self.c):
            mk = m[tri][None]
            ok &= _sum3(o[:, None] * mk) + t * _sum3(d[:, None] * mk) \
                >= c[tri][None]
        if t_max is not None:
            ok &= t * t <= t_max[:, None]
        return torch.where(ok, t, torch.full_like(t, math.inf))

    def closest(self, o, d, tri):
        """(t [N], triangle [N], -1 on a miss) over triangles ``tri``."""
        best_t = torch.full((o.shape[0],), math.inf, device=o.device)
        best_i = torch.full((o.shape[0],), -1, dtype=torch.int64,
                            device=o.device)
        step = max(1, _PAIR_BLOCK // max(o.shape[0], 1))
        for s in range(0, tri.shape[0], step):
            ct, ci = self.hits(o, d, tri[s:s + step]).min(dim=1)
            better = ct < best_t
            best_t = torch.where(better, ct, best_t)
            best_i = torch.where(better, tri[s:s + step][ci], best_i)
        return best_t, torch.where(torch.isfinite(best_t), best_i, -1)

    def blocked(self, o, d, r2, tri):
        """[N] bool: some triangle of ``tri`` is hit at t with t^2 <= r2."""
        out = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
        step = max(1, _PAIR_BLOCK // max(o.shape[0], 1))
        for s in range(0, tri.shape[0], step):
            out |= torch.isfinite(self.hits(o, d, tri[s:s + step], r2)
                                  ).any(dim=1)
        return out


def _tiles(height: int, width: int, device):
    """Pixel coordinates of 32 x 32-pixel tiles -> (px, py [tiles, TILE^2]
    int64, real [tiles, TILE^2] bool), the edge tiles' outside lanes
    repeating the last row or column."""
    ty, tx = -(-height // TILE), -(-width // TILE)
    y = torch.arange(ty * TILE, device=device)
    x = torch.arange(tx * TILE, device=device)
    py, px = torch.meshgrid(y, x, indexing="ij")

    def tiled(a):
        return a.reshape(ty, TILE, tx, TILE).movedim(1, 2).reshape(
            ty * tx, TILE * TILE)

    real = tiled((py < height) & (px < width))
    return (tiled(px.clamp(max=width - 1)), tiled(py.clamp(max=height - 1)),
            real)


def shadow_hit_bound(ref, cam_rotation, tile_block: int = 64) -> dict:
    """Least time of the opaque shadow pass of one frame of the
    reference renderer ``ref`` (a float32 ``reference.render.Renderer``
    on the card) with the camera matrix ``cam_rotation``.

    Returns the bound (``bound_ms``, ``bound_by``), ``member_tests``,
    ``bytes``, and the pass's ``active`` and ``blocked`` lanes and listed
    ``pairs``."""
    from reference.render import camera_rays

    s = ref.s
    dev = ref.dev
    W, H = s.width, s.height
    verts = ref.params["vertices"].detach().float()
    ids, real_m, lo, hi = partition(verts, ref.tri)
    members = real_m.sum(dim=1)
    geo = _Geometry(ref)
    px, py, real = _tiles(H, W, dev)
    n_tiles = px.shape[0]
    o, d = camera_rays(px.reshape(-1), py.reshape(-1), W, H,
                       s.tan_half_fov, ref.params["cam_position"].float(),
                       cam_rotation)
    o = o.reshape(n_tiles, TILE * TILE, 3)
    d = d.reshape(n_tiles, TILE * TILE, 3)
    lights = ref.light_pos.float()
    Ll = lights.shape[0]

    # the camera rays' closest hits over their tiles' frustum lists
    point = torch.zeros_like(o)
    normal = torch.zeros_like(o)
    hit = torch.zeros(real.shape, dtype=torch.bool, device=dev)
    for b in range(0, n_tiles, tile_block):
        sl = slice(b, b + tile_block)
        mask = _frustum_box_mask(o[sl].amin(1), o[sl].amax(1), d[sl].amin(1),
                                 d[sl].amax(1), lo, hi)
        for j in range(mask.shape[0]):
            k = b + j
            tri = ids[mask[j]][real_m[mask[j]]]
            t, tid = geo.closest(o[k], d[k], tri)
            h = (tid >= 0) & real[k]
            hit[k] = h
            point[k] = torch.where(h[:, None], o[k] + d[k] * t[:, None], 0.0)
            normal[k] = geo.n[tid.clamp(min=0)]

    # each light's active lanes, and the origin box over any light's
    shadow_o = point + normal * SHADOW_BIAS
    lv = lights[:, None, None, :] - point[None]  # [Ll, tiles, lanes, 3]
    r2 = _sum3(lv * lv)
    ld = lv / torch.sqrt(r2)[..., None]
    active = hit[None] & (_sum3(ld * normal[None]) > 0.0)
    any_l = active.any(dim=0)[..., None]
    big = torch.full((), _INF, device=dev)
    o_lo = torch.where(any_l, shadow_o, big).amin(dim=1)  # [tiles, 3]
    o_hi = torch.where(any_l, shadow_o, -big).amax(dim=1)

    tests = pairs = blocked_n = 0
    needed = torch.zeros(n_tiles, dtype=torch.bool, device=dev)
    for li in range(Ll):
        lp = lights[li].expand(n_tiles, 3)
        for b in range(0, n_tiles, tile_block):
            sl = slice(b, b + tile_block)
            mask = shaft_mask(o_lo[sl], o_hi[sl], lp[sl], ORIGIN_SLACK, lo,
                              hi) & active[li, sl].any(dim=1)[:, None]
            for j in torch.nonzero(mask.any(dim=1))[:, 0].tolist():
                k = b + j
                lane = torch.nonzero(active[li, k])[:, 0]
                tri = ids[mask[j]][real_m[mask[j]]]
                blk = geo.blocked(shadow_o[k, lane], ld[li, k, lane],
                                  r2[li, k, lane], tri)
                nb = int(blk.sum())
                tests += (lane.numel() - nb) * int(members[mask[j]].sum()) \
                    + nb
                blocked_n += nb
                pairs += int(mask[j].sum())
                needed[k] = True
    lanes = TILE * TILE
    num_bytes = (ids.numel() * SLOT_BYTES
                 + int(needed.sum()) * lanes * RAY_BYTES
                 + Ll * 12 + Ll * n_tiles * 4 + 4 * pairs
                 + Ll * n_tiles * lanes)
    return {**bound_ms(num_bytes, tests * FLOPS_PER_MEMBER),
            "member_tests": tests, "bytes": num_bytes,
            "active": int(active.sum()), "blocked": blocked_n,
            "pairs": pairs}

"""The yardstick of the trace kernels: the card's peaks, the least time of
a closest-hit query, and the member tests it needs, counted by a frozen
copy of the port's cluster partition and tile binning.

The peaks and the arithmetic are those of ``chip_smoke.py`` when the
benchmark was defined; the partition (triangles in 30-bit Morton order of
their centroids, 16 to a cluster, each cluster's box over its members) and
the binning (each 32 x 32-pixel tile's interval frustum slab-tested
against every cluster box, t >= 0) are those of ``ops/cluster_tables.py``
and ``ops/binning.py``.  They are copied, so the count stays the same
whatever later implements the trace.
"""

from __future__ import annotations

import torch

# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory rate
# and dense fp32 rate outside the tensor cores.
H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12
# The member test: two 3-dots and a subtract for the plane, a divide, and
# per edge two 3-dots, a subtract, a multiply, an add.
FLOPS_PER_MEMBER = 5 + 5 + 1 + 1 + 3 * 13
CLUSTER_SIZE = 16
TILE = 32  # tile side in pixels; a tile is 1024 rays
# Bytes of one ray read (origin, direction: 6 float32), of one answer
# written (distance float32, triangle id int32), and of one cluster slot of
# the triangle table read (normal 3, n.v0 1, edge normals 9, edge
# constants 3, cull flag 1, as float32, and the int32 triangle id).
RAY_BYTES = 24
ANSWER_BYTES = 8
SLOT_BYTES = 18 * 4 + 4
_INF = 3.4e38


def bound_ms(num_bytes: float, flops: float) -> dict:
    """The least time the card could take: every input byte read once and
    every output byte written once at the memory rate, or the arithmetic
    at the peak fp32 rate, whichever is larger."""
    by = num_bytes / H100_BYTES_PER_S * 1e3
    op = flops / H100_FP32_FLOPS * 1e3
    return {"bound_ms": max(by, op),
            "bound_by": "bytes" if by >= op else "operations"}


def _part1by2(x):
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def cluster_boxes(vertices, tri_vidx):
    """Morton clusters of 16 -> (box lo [L, 3], box hi [L, 3], real
    members [L])."""
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
    cpts = pts[ids].reshape(L, CLUSTER_SIZE * 3, 3)
    members = torch.full((L,), CLUSTER_SIZE, dtype=torch.int64,
                         device=vertices.device)
    if pad:
        members[-1] = CLUSTER_SIZE - pad
    return cpts.amin(dim=1), cpts.amax(dim=1), members


def _frustum_box_mask(o_lo, o_hi, d_lo, d_hi, bmin, bmax):
    """Interval slab test of [tiles] frustums against [L] boxes, t >= 0."""
    o_lo, o_hi = o_lo[:, None, :], o_hi[:, None, :]
    d_lo, d_hi = d_lo[:, None, :], d_hi[:, None, :]
    bmin, bmax = bmin[None], bmax[None]
    one = torch.ones((), dtype=d_lo.dtype, device=d_lo.device)
    inf = torch.full((), _INF, dtype=d_lo.dtype, device=d_lo.device)
    pos = d_lo > 0.0
    neg = d_hi < 0.0
    ent_pos = (bmin - o_hi) / torch.where(pos, d_hi, one)
    ext_pos = (bmax - o_lo) / torch.where(pos, d_lo, one)
    ent_neg = (bmax - o_lo) / torch.where(neg, d_lo, one)
    ext_neg = (bmin - o_hi) / torch.where(neg, d_hi, one)
    t_ent = torch.where(pos, ent_pos, torch.where(neg, ent_neg, -inf))
    t_ext = torch.where(pos, ext_pos, torch.where(neg, ext_neg, inf))
    t_ent = torch.clamp(t_ent, min=0.0)
    return t_ent.amax(dim=-1) <= t_ext.amin(dim=-1)


def primary_hit_bound(vertices, tri_vidx, origins, dirs, width: int,
                      height: int, tile_block: int = 64) -> dict:
    """Least time of the closest hit of a frame's camera rays
    (``origins``, ``dirs``: [height, width, 3] float32 on the device).

    Bytes: each ray read once, each answer written once, and the table
    slots of every cluster some tile's list holds, once.  Operations: for
    every tile, its rays times the real members of the clusters on its
    list, at FLOPS_PER_MEMBER each."""
    lo, hi, members = cluster_boxes(vertices, tri_vidx)
    ty, tx = -(-height // TILE), -(-width // TILE)

    def tiles(x):
        # edge rows and columns repeated up to whole tiles: the same bounds
        x = x[torch.arange(ty * TILE, device=x.device).clamp(max=height - 1)]
        x = x[:, torch.arange(tx * TILE, device=x.device).clamp(max=width - 1)]
        x = x.reshape(ty, TILE, tx, TILE, 3).movedim(1, 2).reshape(-1, TILE * TILE, 3)
        return x.amin(dim=1), x.amax(dim=1)

    o_lo, o_hi = tiles(origins)
    d_lo, d_hi = tiles(dirs)
    ry = torch.clamp(height - torch.arange(ty) * TILE, max=TILE)
    rx = torch.clamp(width - torch.arange(tx) * TILE, max=TILE)
    rays = (ry[:, None] * rx[None]).reshape(-1).to(lo.device)
    tests = 0
    touched = torch.zeros(lo.shape[0], dtype=torch.bool, device=lo.device)
    for s in range(0, o_lo.shape[0], tile_block):
        sl = slice(s, s + tile_block)
        m = _frustum_box_mask(o_lo[sl], o_hi[sl], d_lo[sl], d_hi[sl], lo, hi)
        tests += int(((m * members[None]).sum(dim=1) * rays[sl]).sum())
        touched |= m.any(dim=0)
    n = width * height
    num_bytes = (n * (RAY_BYTES + ANSWER_BYTES)
                 + int(touched.sum()) * CLUSTER_SIZE * SLOT_BYTES)
    return {**bound_ms(num_bytes, tests * FLOPS_PER_MEMBER),
            "member_tests": tests, "bytes": num_bytes}

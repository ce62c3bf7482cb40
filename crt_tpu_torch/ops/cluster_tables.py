"""Morton-ordered triangle clusters: the tables the cluster kernels walk.

Counterpart of the table half of ``crt_tpu/ops/pallas_trace.py``
(``ClusterTables``, ``morton_order``, ``build_cluster_tables``,
``emit_rows_table``, ``_glass_subset``).  Triangles are sorted by the
30-bit Morton code of their centroid and grouped into consecutive clusters
of 16; every triangle is in exactly one cluster.  Each slot holds the plane
+ three half-space test constants; pad slots can never be hit (zero normal,
c = 1).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from crt_tpu_torch.ops import vecmath
from crt_tpu_torch.ops.shade import build_packed
from crt_tpu_torch.scene.types import MATERIAL_REFRACTIVE
from crt_tpu_torch.utils import trace as tracing

TILE_RAYS = 1024  # rays per binned tile (32x32 pixels)
CLUSTER_SIZE = 16  # triangles per cluster


class ClusterTables(NamedTuple):
    """Cluster-major padded triangle constants (built once per scene)."""

    n: torch.Tensor  # [L, 16, 3] face normals (0 for pad)
    nv0: torch.Tensor  # [L, 16] n . v0
    m: torch.Tensor  # [L, 16, 9] edge normals (n x e_i), flattened
    c: torch.Tensor  # [L, 16, 3] m_i . v_i (pad rows get c=1 -> always fail)
    nobf: torch.Tensor  # [L, 16] 1.0 if NOT backface-culled
    tri_id: torch.Tensor  # [L, 16] i32 original triangle id (-1 pad)
    cl_min: torch.Tensor  # [L, 3] cluster AABB lower
    cl_max: torch.Tensor  # [L, 3] cluster AABB upper
    rank: torch.Tensor  # [T] i32 triangle id -> slot index (Morton rank)


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits of x over 30 bits (Morton interleave helper)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def morton_order(centroids: torch.Tensor) -> torch.Tensor:
    """Stable sort order of points by 30-bit Morton code over their box."""
    lo = centroids.amin(dim=0)
    hi = centroids.amax(dim=0)
    scale = torch.where(hi > lo, 1023.0 / (hi - lo), torch.zeros_like(hi))
    q = torch.clamp((centroids - lo) * scale, 0, 1023).to(torch.int64)
    code = (
        _part1by2(q[:, 0])
        | (_part1by2(q[:, 1]) << 1)
        | (_part1by2(q[:, 2]) << 2)
    )
    return torch.argsort(code, stable=True).to(torch.int32)


def _centroids(vertices, tri_vidx) -> torch.Tensor:
    pts = vertices[tri_vidx.long()]  # [T, 3, 3]
    return (pts[:, 0] + pts[:, 1] + pts[:, 2]) / 3.0


def rank_of_order(order: torch.Tensor) -> torch.Tensor:
    """Inverse of the Morton permutation: [T] i32 triangle id -> its rank,
    which is its slot index in the tables and the segment sum's id space."""
    rank = torch.empty_like(order)
    rank[order.long()] = torch.arange(order.shape[0], dtype=order.dtype,
                                      device=order.device)
    return rank


@tracing.spanned("crt.tables.rank")
def triangle_rank(scene) -> torch.Tensor:
    """``build_cluster_tables(scene).rank`` without the tables, for a
    backend that walks none."""
    return rank_of_order(morton_order(
        _centroids(scene.vertices.detach(), scene.tri_vidx)))


@tracing.spanned("crt.tables.cluster")
def build_cluster_tables(scene, clusters: slice | None = None
                         ) -> ClusterTables:
    """Morton-cluster the scene's triangles and precompute test constants.

    ``clusters`` builds those clusters only (a rank's shard of a
    partitioned scene, ``parallel/scene_sharded.py``): the Morton order is
    the whole scene's, and ``rank`` maps each triangle of the shard to its
    slot in it and every other triangle to -1."""
    vertices = scene.vertices.detach()
    tvi = scene.tri_vidx.long()
    backface = scene.mat_backface[scene.tri_material.long()]
    T = tvi.shape[0]
    L = -(-T // CLUSTER_SIZE)
    dev = vertices.device

    order = morton_order(_centroids(vertices, tvi))
    rank = rank_of_order(order)
    pad = L * CLUSTER_SIZE - T
    if pad:
        order = torch.cat(
            [order, torch.full((pad,), -1, dtype=torch.int32, device=dev)]
        )
    cl = order.reshape(L, CLUSTER_SIZE)  # [L, 16] tri ids, -1 pad
    if clusters is not None:
        cl = cl[clusters]
        slot = rank - clusters.indices(L)[0] * CLUSTER_SIZE
        rank = torch.where((slot >= 0) & (slot < cl.numel()), slot,
                           torch.full_like(slot, -1))
    padm = cl < 0
    ids = torch.clamp(cl, min=0).long()

    v0 = vertices[tvi[ids, 0]]
    v1 = vertices[tvi[ids, 1]]
    v2 = vertices[tvi[ids, 2]]  # [L, 16, 3]
    n = vecmath.safe_normalize(vecmath.cross(v1 - v0, v2 - v0))
    e0, e1, e2 = v1 - v0, v2 - v1, v0 - v2
    m0, m1, m2 = vecmath.cross(n, e0), vecmath.cross(n, e1), vecmath.cross(n, e2)
    c = torch.stack(
        [vecmath.dot(m0, v0), vecmath.dot(m1, v1), vecmath.dot(m2, v2)], dim=-1
    )
    m = torch.cat([m0, m1, m2], dim=-1)  # [L, 16, 9]

    padf = padm[..., None].to(torch.float32)
    n = n * (1.0 - padf)
    c = torch.where(padm[..., None], torch.ones_like(c), c)
    nobf = torch.where(padm, torch.zeros_like(padf[..., 0]),
                       1.0 - backface[ids].to(torch.float32))

    # Cluster AABBs over member points; pad members collapse to the first
    # real member so they never widen the box.
    safe_ids = torch.where(padm, ids[:, :1].expand_as(ids), ids)
    cpts = vertices[tvi[safe_ids]]  # [L, 16, 3, 3]
    cl_min = cpts.amin(dim=(1, 2))
    cl_max = cpts.amax(dim=(1, 2))

    nv0 = vecmath.dot(n, v0)
    return ClusterTables(
        n=n.contiguous(),
        nv0=torch.where(padm, torch.zeros_like(nv0), nv0).contiguous(),
        m=(m * (1.0 - padf)).contiguous(),
        c=c.contiguous(),
        nobf=nobf.contiguous(),
        tri_id=cl.to(torch.int32).contiguous(),
        cl_min=cl_min,
        cl_max=cl_max,
        rank=rank,
    )


@tracing.spanned("crt.tables.glass")
def glass_subset(scene, tables: ClusterTables):
    """The refractive members of the tables -> (member mask [L, S] f32,
    gmin [L, 3], gmax [L, 3]): 1.0 on slots that hold a refractive
    triangle, and each cluster's box over those members alone.  A cluster
    with no glass carries the box (+3.4e38, -3.4e38), which no binning
    test admits."""
    inf = 3.4e38
    ids = torch.clamp(tables.tri_id, min=0).long()
    padm = tables.tri_id < 0
    is_glass = (scene.mat_type[scene.tri_material.long()]
                == MATERIAL_REFRACTIVE)[ids] & ~padm  # [L, S]
    pts = scene.vertices.detach()[scene.tri_vidx.long()[ids]]  # [L, S, 3, 3]
    g = is_glass[..., None, None]
    gmin = torch.where(g, pts, pts.new_full((), inf)).amin(dim=(1, 2))
    gmax = torch.where(g, pts, pts.new_full((), -inf)).amax(dim=(1, 2))
    return is_glass.to(torch.float32).contiguous(), gmin, gmax


@tracing.spanned("crt.tables.rows")
def emit_rows_table(scene, tables: ClusterTables) -> torch.Tensor:
    """Per-slot packed attribute rows for the row-emitting closest-hit
    kernel -> [L, S, K+1] f32: the shader's packed rows (build_packed
    order) for each cluster member, plus a final SLOT-INDEX row (== the
    triangle's Morton rank, the segment-sum id space)."""
    packed = build_packed(scene).detach()  # [K, T]
    L, S = tables.tri_id.shape
    ids = torch.clamp(tables.tri_id, min=0).long()
    rows = packed.T[ids]  # [L, S, K]
    slot = torch.arange(L * S, dtype=torch.float32,
                        device=packed.device).reshape(L, S)[..., None]
    return torch.cat([rows, slot], dim=-1).contiguous()

"""All-pairs ray-triangle closest hit: the ``bruteforce`` backend.

Counterpart of ``crt_tpu/ops/intersect.py``.  For triangle j, with face
normal ``n_j`` and in-plane edge normals ``m_ij = n_j x e_ij``:

    t      = (n_j . v0_j - n_j . o) / (n_j . d)
    test_i = (m_ij . o - m_ij . v_ij) + t * (m_ij . d)

so a chunk of rays against every triangle is two [Rc, 3] x [3, 4T] matrix
products plus an elementwise chain:

    valid = |n.d| >= 1e-6 AND (front face OR no backface culling)
            AND t >= 0 AND test_0, test_1, test_2 >= 0

It is independent of the cluster kernels (no binning, no per-cluster walk,
dot products by matmul) and serves as their card-side oracle.  The matrix
product is the only one in the render path; it runs in full fp32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from crt_tpu_torch.ops import vecmath

PARALLEL_EPS = 1e-6


class TriangleData(NamedTuple):
    """Precomputed per-triangle constants for the batched test."""

    table: torch.Tensor  # [3, 4T] stacked columns: [n | m0 | m1 | m2]
    n_dot_v0: torch.Tensor  # [T]
    c: torch.Tensor  # [T, 3] m_i . v_i
    backface: torch.Tensor  # [T] bool
    num: int  # T


def build_triangle_data(vertices, tri_vidx, tri_backface) -> TriangleData:
    idx = tri_vidx.long()
    v0, v1, v2 = vertices[idx[:, 0]], vertices[idx[:, 1]], vertices[idx[:, 2]]
    n = vecmath.safe_normalize(vecmath.cross(v1 - v0, v2 - v0))
    e0, e1, e2 = v1 - v0, v2 - v1, v0 - v2
    m0, m1, m2 = vecmath.cross(n, e0), vecmath.cross(n, e1), vecmath.cross(n, e2)
    c = torch.stack(
        [vecmath.dot(m0, v0), vecmath.dot(m1, v1), vecmath.dot(m2, v2)], dim=-1
    )
    table = torch.cat([n, m0, m1, m2], dim=0).T.contiguous()  # [3, 4T]
    return TriangleData(
        table=table,
        n_dot_v0=vecmath.dot(n, v0),
        c=c,
        backface=tri_backface.to(torch.bool),
        num=int(tri_vidx.shape[0]),
    )


class Hit(NamedTuple):
    t: torch.Tensor  # [R] f32 distance, +inf on miss
    tri: torch.Tensor  # [R] i32 triangle id, -1 on miss

    @property
    def valid(self) -> torch.Tensor:
        return self.tri >= 0


def _fp32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.is_cuda:
        # TF32 would keep ~10 mantissa bits; the render path is fp32 only.
        torch.backends.cuda.matmul.allow_tf32 = False
        if torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("TF32 matmul could not be disabled")
    return a @ b


def _intersect_chunk(tri: TriangleData, origins, dirs) -> Hit:
    """All-pairs closest hit for one ray chunk: [Rc, 3] x T -> Hit[Rc]."""
    T = tri.num
    dots_d = _fp32_matmul(dirs, tri.table)  # [Rc, 4T]
    dots_o = _fp32_matmul(origins, tri.table)

    nd = dots_d[:, :T]
    opd = tri.n_dot_v0[None, :] - dots_o[:, :T]
    not_parallel = nd.abs() >= PARALLEL_EPS
    face_ok = (opd < 0.0) | ~tri.backface[None, :]
    t = opd / torch.where(not_parallel, nd, torch.ones_like(nd))
    valid = not_parallel & face_ok & (t >= 0.0)
    for i in range(3):
        md = dots_d[:, (i + 1) * T:(i + 2) * T]
        mo = dots_o[:, (i + 1) * T:(i + 2) * T]
        valid = valid & ((mo - tri.c[None, :, i]) + t * md >= 0.0)

    dist = torch.where(valid, t, torch.full_like(t, float("inf")))
    best, idx = dist.min(dim=1)  # first index among equal minima
    idx = torch.where(torch.isfinite(best), idx, torch.full_like(idx, -1))
    return Hit(t=best, tri=idx.to(torch.int32))


def closest_hit_bruteforce(tri: TriangleData, origins, dirs,
                           ray_chunk: int = 8192) -> Hit:
    """Closest hit over every triangle, chunked over rays to bound memory.

    Works for any leading batch shape; returns Hit with that batch shape.
    """
    batch_shape = origins.shape[:-1]
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    ts, tris = [], []
    for s in range(0, o.shape[0], ray_chunk):
        h = _intersect_chunk(tri, o[s:s + ray_chunk], d[s:s + ray_chunk])
        ts.append(h.t)
        tris.append(h.tri)
    return Hit(t=torch.cat(ts).reshape(batch_shape),
               tri=torch.cat(tris).reshape(batch_shape))

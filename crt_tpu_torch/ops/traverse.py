"""Batched KD-tree traversal: the ``tree`` backend.

Counterpart of ``crt_tpu/ops/traverse.py``.  The reference walks the tree
per ray with a ``std::stack`` (crt_intersection.cpp:109-136): pop a node,
test its AABB, intersect the ray with the node's padded leaf row or push
its two children (child0 first, so child1 is walked first).  The closest
hit keeps the first triangle among equal t in a leaf and the first leaf
walked across leaves.  The depth is bounded by
MAX_ACCELERATION_TREE_DEPTH = 39, so ``STACK_SIZE`` node ids hold a walk.

On the card a walk is one launch of ``csrc/tree_walk.cu``: one thread a
ray, each with its own stack, in the reference's order; ``active=False``
lanes walk nothing, and no value is read back to the host.  crt_tpu has no
Pallas kernel here: it runs the walk in one ``lax.while_loop`` over every
lane until no stack holds a node, testing every lane against a leaf row
each iteration.

On the CPU, and as the kernel's bit-for-bit reference on any device,
``closest_hit_tree_plain`` walks a wavefront in lock step in plain torch:
every ray carries a fixed stack of ``STACK_SIZE`` node ids and each
iteration pops one node per ray.  The body is a no-op on a lane whose stack
is empty, and a leaf test changes nothing on a lane that is not at a leaf
whose box it hits, so it changes no bit of crt_tpu's loop by doing less:

- it walks only the active lanes (one host read to list them);
- each iteration runs the leaf test on the lanes at a hit leaf only (one
  host read to list them; 13-17 % of the lanes an iteration on the opaque
  test scene and a 65,536-triangle soup), in pieces whose gathered leaf
  rows ([17, rays, leaf_size] f32, a contiguous plane a constant) stay
  within ``GATHER_BYTES``;
- it reads the loop condition once every ``CHECK_EVERY`` iterations (one
  host read), and then drops the finished lanes from the wavefront when
  they are at least half of it.

The hit is a constant (the walk runs under ``no_grad`` on detached
vertices); the renderer recomputes what the shading needs from the ids.
"""

from __future__ import annotations

import torch

from crt_tpu_torch.ops import vecmath
from crt_tpu_torch.ops.cluster_tables import triangle_rank
from crt_tpu_torch.ops.cluster_trace import _cuda_stream, _raise_on, _require
from crt_tpu_torch.ops.intersect import PARALLEL_EPS, Hit
from crt_tpu_torch.ops.tracer import Tracer
from crt_tpu_torch.utils import trace as tracing

STACK_SIZE = 48
# Loop iterations between two reads of the loop condition.
CHECK_EVERY = 4
# Bytes of the gathered leaf rows ([17, rays, leaf_size] f32) one leaf test
# may take.
GATHER_BYTES = 1 << 30


def build_triangle_gather(vertices, tri_vidx, tri_backface) -> torch.Tensor:
    """Per-triangle constants as gather planes, [17, T + 1] f32: n (3),
    n . v0, the edge normals m_i = n x e_i (row by row, 9), c_i = m_i . v_i
    (3), and 1 where the triangle culls no back face.  Column T, which a
    leaf row's pad id -1 reads, has n = 0, so it is never a hit."""
    idx = tri_vidx.long()
    v0, v1, v2 = vertices[idx[:, 0]], vertices[idx[:, 1]], vertices[idx[:, 2]]
    n = vecmath.safe_normalize(vecmath.cross(v1 - v0, v2 - v0))
    e0, e1, e2 = v1 - v0, v2 - v1, v0 - v2
    m0, m1, m2 = vecmath.cross(n, e0), vecmath.cross(n, e1), vecmath.cross(n, e2)
    c = torch.stack(
        [vecmath.dot(m0, v0), vecmath.dot(m1, v1), vecmath.dot(m2, v2)], dim=-1
    )
    planes = torch.cat([n, vecmath.dot(n, v0)[:, None], m0, m1, m2, c,
                        (~tri_backface.to(torch.bool))[:, None].to(n.dtype)],
                       dim=1)
    return torch.cat([planes, planes.new_zeros(1, 17)]).T.contiguous()


def _inverse(d):
    """1 / d for the slab test, a zero component of either sign taken as
    +1e-30 (crt_tpu's ``where(d >= 0, 1e-30, -1e-30)`` sends -0.0 to
    +1e-30)."""
    tiny = torch.where(d >= 0, torch.full_like(d, 1e-30),
                       torch.full_like(d, -1e-30))
    return torch.ones_like(d) / torch.where(d.abs() > 1e-30, d, tiny)


def _ray_aabb(o, inv, bmin, bmax):
    """Slab test: does the ray segment [0, inf) hit the closed box?
    Inclusive on boundaries; ``inv`` is ``_inverse(d)``."""
    t1 = (bmin - o) * inv
    t2 = (bmax - o) * inv
    tnear = torch.minimum(t1, t2).amax(dim=-1)
    tfar = torch.maximum(t1, t2).amin(dim=-1)
    return tfar >= torch.clamp(tnear, min=0.0)


def _leaf_intersect(tri, leaf_tri_ids, o, d, best_t, best_tri):
    """Intersect each ray with its [L]-padded leaf row.

    tri: ``build_triangle_gather``'s planes; leaf_tri_ids: [R, L] triangle
    ids (-1 pad).  The plane + three
    half-space test (crt_intersection.cpp:47-93) on gathered constants,
    each a contiguous [R, L] plane; every dot product is summed left to
    right, as crt_tpu's ``dot`` and ``einsum("rlij,rj->rli")`` round.
    """
    g = tri[:, leaf_tri_ids]  # [17, R, L]; -1 takes the pad column
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]  # [R, 1]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    nd = (g[0] * dx + g[1] * dy) + g[2] * dz
    opd = g[3] - ((g[0] * ox + g[1] * oy) + g[2] * oz)
    not_parallel = nd.abs() >= PARALLEL_EPS
    face_ok = (opd < 0.0) | (g[16] > 0.0)
    t = opd / torch.where(not_parallel, nd, 1.0)

    # the three edges at once: m_i . o - c_i + t * (m_i . d), [3, R, L]
    mx, my, mz = g[4:13:3], g[5:13:3], g[6:13:3]
    md = (mx * dx + my * dy) + mz * dz
    mo = (mx * ox + my * oy) + mz * oz
    inside = (((mo - g[13:16]) + t * md) >= 0.0).all(dim=0)

    valid = not_parallel & face_ok & (t >= 0.0) & inside
    t = torch.where(valid, t, float("inf"))

    lt, li = t.min(dim=1)  # the first slot among equal minima
    ltri = leaf_tri_ids.gather(1, li[:, None])[:, 0]
    better = lt < best_t
    return torch.where(better, lt, best_t), torch.where(better, ltri, best_tri)


def _walk(nodes_f, nodes_i, leaf_tris, tri, o, d, most):
    """Walk the rays [W, 3] from the root to the end of every stack ->
    (t [W], tri [W], loop iterations, host reads).  ``most``: rays a leaf
    test takes at once.  Counts ``crt.tree.leaf_lanes``: the lanes tested
    at a hit leaf, from the lists the walk reads anyway."""
    W = o.shape[0]
    dev = o.device
    out_t = torch.full((W,), float("inf"), device=dev)
    out_tri = torch.full((W,), -1, dtype=torch.int32, device=dev)
    lane = torch.arange(W, device=dev)
    # one slot past the stack takes the writes of the pushes not made
    stack = torch.zeros((W, STACK_SIZE + 1), dtype=torch.int32, device=dev)
    sp = torch.ones((W,), dtype=torch.int64, device=dev)  # root pushed
    best_t, best_tri = out_t.clone(), out_tri.clone()
    inv = _inverse(d)
    iterations = reads = leaf_lanes = 0
    while True:
        for _ in range(CHECK_EVERY):
            # pop; a lane with an empty stack reads slot 0 and tests nothing
            active = sp > 0
            node = stack.gather(1, (sp - 1).clamp(min=0)[:, None])[:, 0]
            sp = sp - active.long()

            box = nodes_f[node]  # [w, 6]: min | max
            hit_box = active & _ray_aabb(o, inv, box[:, 0:3], box[:, 3:6])
            ni = nodes_i[node]  # [w, 3]: child0 | child1 | leaf id
            is_leaf = ni[:, 2] >= 0

            # internal: push child0 then child1 (the reference's pop order)
            push = (hit_box & ~is_leaf)[:, None] & (ni[:, :2] >= 0)  # [w, 2]
            sp1 = sp + push[:, 0]
            pos = torch.where(push, torch.stack([sp, sp1], 1), STACK_SIZE)
            stack.scatter_(1, pos, ni[:, :2])
            sp = sp1 + push[:, 1]

            # leaf: intersect the padded row, on the lanes at a hit leaf
            at_leaf = (hit_box & is_leaf).nonzero()[:, 0]
            reads += 1
            leaf_lanes += at_leaf.numel()
            for s in range(0, at_leaf.numel(), most):
                i = at_leaf[s:s + most]
                best_t[i], best_tri[i] = _leaf_intersect(
                    tri, leaf_tris[ni[i, 2]], o[i], d[i], best_t[i],
                    best_tri[i])
            iterations += 1
        keep = (sp > 0).nonzero()[:, 0]
        reads += 1
        if keep.numel() == 0:
            break
        if 2 * keep.numel() <= lane.numel():
            # drop the finished lanes, keeping their results
            out_t[lane], out_tri[lane] = best_t, best_tri
            lane, o, d, inv, stack, sp = (lane[keep], o[keep], d[keep],
                                          inv[keep], stack[keep], sp[keep])
            best_t, best_tri = best_t[keep], best_tri[keep]
    out_t[lane], out_tri[lane] = best_t, best_tri
    tracing.count("crt.tree.leaf_lanes", leaf_lanes)
    return out_t, out_tri, iterations, reads


def closest_hit_tree(accel, tri, origins, dirs, active=None) -> Hit:
    """KD traversal -> Hit for any leading batch shape.

    ``active=False`` lanes are not walked: they miss (t = inf, tri = -1),
    as crt_tpu's lanes that start with an empty stack do.  The rays are
    flattened (and copied where they are not contiguous) for ``walk``.
    """
    batch_shape = origins.shape[:-1]
    with torch.no_grad():
        o = origins.detach().reshape(-1, 3).contiguous()
        d = dirs.detach().reshape(-1, 3).contiguous()
        act = None if active is None else active.reshape(-1).contiguous()
        t, hit_tri = walk(accel, tri, o, d, act)
    return Hit(t=t.reshape(batch_shape), tri=hit_tri.reshape(batch_shape))


def _check_walk(accel, tri, o, d, active):
    dev = o.device
    R = o.shape[0] if o.dim() == 2 else -1
    for name, x in (("origins", o), ("dirs", d)):
        _require(x.device == dev and x.dtype == torch.float32
                 and x.is_contiguous() and x.dim() == 2
                 and tuple(x.shape) == (R, 3),
                 f"{name} must be a contiguous float32 [R, 3] on {dev}")
    if active is not None:
        _require(active.device == dev and active.dtype == torch.bool
                 and active.is_contiguous() and tuple(active.shape) == (R,),
                 f"active must be a contiguous bool [{R}] on {dev}")
    N = accel.node_min.shape[0]
    for name, dtype, shape in (("node_min", torch.float32, (N, 3)),
                               ("node_max", torch.float32, (N, 3)),
                               ("node_children", torch.int32, (N, 2)),
                               ("node_leaf_id", torch.int32, (N,))):
        x = getattr(accel, name)
        _require(x.device == dev and x.dtype == dtype and x.is_contiguous()
                 and tuple(x.shape) == shape,
                 f"accel.{name} must be a contiguous {dtype} {list(shape)}"
                 f" on {dev}")
    leaves = accel.leaf_tris
    _require(leaves.device == dev and leaves.dtype == torch.int32
             and leaves.is_contiguous() and leaves.dim() == 2
             and leaves.shape[1] >= 1,
             f"accel.leaf_tris must be a contiguous int32 [leaves, "
             f"leaf_size] on {dev}")
    _require(tri.device == dev and tri.dtype == torch.float32
             and tri.is_contiguous() and tri.dim() == 2
             and tri.shape[0] == 17 and tri.shape[1] >= 1,
             f"tri must be build_triangle_gather's contiguous float32 "
             f"[17, T + 1] on {dev}")


def walk(accel, tri, o, d, active=None):
    """The walk of rays ``o``, ``d`` [R, 3] f32 (``active`` [R] bool or
    None) through ``accel`` over ``tri``'s planes -> (t [R] f32, tri [R]
    i32).

    On the card one launch of ``csrc/tree_walk.cu`` under the span
    ``crt.tree.walk``, counted as ``crt.tree.walks`` and
    ``crt.launches.tree_walk``, with ``crt.host_reads.tree_walk`` 0: no
    host read.  While tracing is on the kernel adds its hit leaves to a
    one-word buffer, counted as ``crt.tree.leaf_lanes``.  It has no
    lock-step loop, so it counts no ``crt.tree.iterations``.  On the CPU
    ``closest_hit_tree_plain``, with its counts.  The tables are read from
    ``accel`` as passed, each call.
    """
    _check_walk(accel, tri, o, d, active)
    dev = o.device
    if dev.type == "cpu":
        return closest_hit_tree_plain(accel, tri, o, d, active)
    if dev.type != "cuda":
        raise NotImplementedError(f"the KD walk has no kernel for {dev}")

    from crt_tpu_torch.ops import cuda_lib

    lib, _ = cuda_lib.load()
    R = o.shape[0]
    t = torch.empty((R,), dtype=torch.float32, device=dev)
    hit_tri = torch.empty((R,), dtype=torch.int32, device=dev)
    if R:
        stats = (torch.zeros((1,), dtype=torch.int64, device=dev)
                 if tracing.enabled() else None)
        with tracing.span("crt.tree.walk"), torch.cuda.device(dev):
            err = lib.crt_tree_walk(
                o.data_ptr(), d.data_ptr(),
                active.data_ptr() if active is not None else None,
                accel.node_min.data_ptr(), accel.node_max.data_ptr(),
                accel.node_children.data_ptr(),
                accel.node_leaf_id.data_ptr(), accel.leaf_tris.data_ptr(),
                tri.data_ptr(), R, accel.node_min.shape[0],
                accel.leaf_tris.shape[1], tri.shape[1],
                t.data_ptr(), hit_tri.data_ptr(), _cuda_stream(dev),
                stats.data_ptr() if stats is not None else None,
            )
        _raise_on(err, "tree_walk")
        tracing.count("crt.tree.walks")
        tracing.count("crt.launches.tree_walk")
        tracing.count("crt.host_reads.tree_walk", 0)
        if stats is not None:
            tracing.count("crt.tree.leaf_lanes", stats)
    return t, hit_tri


def closest_hit_tree_plain(accel, tri, o, d, active=None):
    """The lock-step walk in plain torch of rays ``o``, ``d`` [R, 3]
    (``active`` [R] bool or None) -> (t [R], tri [R]): the CPU path and
    the kernel's reference, on any device.

    The walk runs under the span ``crt.tree.walk``.  Counted in
    ``utils/trace.py``'s registry: ``crt.tree.walks``,
    ``crt.tree.iterations``, ``crt.tree.leaf_lanes`` (the lanes tested at
    a hit leaf) and the walk's host reads, ``crt.host_reads.tree_walk``.
    """
    with torch.no_grad():
        R = o.shape[0]
        t = torch.full((R,), float("inf"), device=o.device)
        hit_tri = torch.full((R,), -1, dtype=torch.int32, device=o.device)
        iterations = reads = 0
        lanes = None
        if active is not None:
            lanes = active.nonzero()[:, 0]
            reads += 1
        if lanes is None or lanes.numel():
            nodes_f = torch.cat([accel.node_min, accel.node_max], dim=1)
            nodes_i = torch.cat([accel.node_children,
                                 accel.node_leaf_id[:, None]], dim=1)
            most = max(1, GATHER_BYTES // (17 * 4 * accel.leaf_size))
            wo, wd = (o, d) if lanes is None else (o[lanes], d[lanes])
            with tracing.span("crt.tree.walk"):
                wt, wtri, iterations, rd = _walk(nodes_f, nodes_i,
                                                 accel.leaf_tris, tri, wo,
                                                 wd, most)
            reads += rd
            if lanes is None:
                t, hit_tri = wt, wtri
            else:
                t[lanes], hit_tri[lanes] = wt, wtri
        tracing.count("crt.tree.walks")
        tracing.count("crt.tree.iterations", iterations)
        tracing.count("crt.host_reads.tree_walk", reads)
    return t, hit_tri


class TreeTracer(Tracer):
    """The tree backend: the KD walk over the tree built at load.  Moving
    the vertices afterwards does not rebuild it (as in crt_tpu)."""

    def __init__(self, scene):
        if scene.accel is None:
            raise ValueError("scene has no acceleration tree")
        with tracing.span("crt.tables.triangles"):
            self.tri = build_triangle_gather(
                scene.vertices.detach(), scene.tri_vidx,
                scene.mat_backface[scene.tri_material.long()],
            )
        self.accel = scene.accel
        # the Morton rank keeps the segment sum's id bands narrow
        self.rank = triangle_rank(scene)

    def __call__(self, origins, dirs, active=None) -> Hit:
        return closest_hit_tree(self.accel, self.tri, origins, dirs, active)

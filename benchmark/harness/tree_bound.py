"""The yardstick of the KD walk: the least time a frame's camera rays need
to find their closest hits through the scene's KD tree, counted over a
frozen copy of the tree's builder rule and the hits of the plain
reference.

The rule is ``shadow_bound.py``'s, at ``harness/roofline.py``'s peaks:

  - bytes: the nodes (box, children, leaf id), the leaf rows and the
    triangle planes once each, every ray's origin and direction read and
    its answer (t, id) written;
  - operations: the box tests of the nodes whose box a ray enters at a t
    no later than its hit's (every node whose box it meets, for a miss),
    at ``FLOPS_PER_BOX`` each, and the member tests of the real triangles
    of the leaves among them, at ``FLOPS_PER_MEMBER`` each.  That is what
    an exact walk that visits no box past its answer needs.

A ray's hit t is the float32 reference's closest hit over every triangle
(``reference.render.Renderer.closest``).  The builder is a frozen copy,
so the count stays the same whatever later implements the walk: the
reference's midpoint split (crt_acceleration_tree.cpp:31-106) as
``scene/accel.py`` had it, in NumPy: the root box over the triangles'
boxes, the axis depth mod 3, triangles routed to each half by inclusive
box overlap (straddlers to both), child0 built and numbered (its whole
subtree) before child1, a leaf at ``MAX_LEAF`` triangles or fewer or past
depth ``MAX_DEPTH``, every leaf row padded with -1 to max(``MAX_LEAF``,
the longest leaf).
"""

from __future__ import annotations

import numpy as np
import torch

from harness.roofline import ANSWER_BYTES, FLOPS_PER_MEMBER, RAY_BYTES, bound_ms

MAX_DEPTH = 39  # MAX_ACCELERATION_TREE_DEPTH
MAX_LEAF = 16  # MAX_BOX_TRIANGLE_COUNT
# The box test with each ray's inverse direction at hand: per axis two
# subtracts, two multiplies, a min and a max (18); two max and two min
# over the axes, the clamp of the entry at 0 and the compare (6).
FLOPS_PER_BOX = 24
# Bytes of one node (box: 6 float32; two children and a leaf id: 3 int32),
# one leaf slot (an int32 triangle id) and one triangle's planes (the
# normal 3, n.v0 1, the edge normals 9 and constants 3, the cull flag 1,
# as float32).
NODE_BYTES = 9 * 4
LEAF_SLOT_BYTES = 4
PLANE_BYTES = 17 * 4


def build_tree(vertices, tri_vidx) -> dict:
    """The midpoint-split tree of triangles ``tri_vidx`` [T, 3] over
    ``vertices`` [V, 3] (float32 values) -> NumPy arrays ``node_min``,
    ``node_max`` [N, 3] float32, ``node_children`` [N, 2] int32 (-1 where
    absent), ``node_leaf_id`` [N] int32 (-1 on an inner node),
    ``leaf_tris`` [leaves, leaf_size] int32 (-1 pads), ordered by node."""
    pts = np.asarray(vertices, np.float32)[np.asarray(tri_vidx, np.int64)]
    tmin, tmax = pts.min(axis=1), pts.max(axis=1)
    lo, hi, kids, leaves = [tmin.min(axis=0)], [tmax.max(axis=0)], [[-1, -1]], {}

    def branch(node, tris, depth):
        if depth > MAX_DEPTH or len(tris) <= MAX_LEAF:
            leaves[node] = tris
            return
        axis = depth % 3
        mid = (lo[node][axis] + hi[node][axis]) * np.float32(0.5)
        halves = []
        for k in range(2):
            blo, bhi = lo[node].copy(), hi[node].copy()
            if k == 0:
                bhi[axis] = mid
            else:
                blo[axis] = mid
            inside = (np.all(tmin[tris] <= bhi, axis=1)
                      & np.all(tmax[tris] >= blo, axis=1))
            halves.append((blo, bhi, tris[inside]))
        for k, (blo, bhi, sub) in enumerate(halves):
            if len(sub):
                child = len(lo)
                lo.append(blo)
                hi.append(bhi)
                kids.append([-1, -1])
                kids[node][k] = child
                branch(child, sub, depth + 1)

    branch(0, np.arange(len(pts), dtype=np.int32), 0)
    size = max([MAX_LEAF] + [len(v) for v in leaves.values()])
    leaf_id = np.full(len(lo), -1, np.int32)
    rows = np.full((max(len(leaves), 1), size), -1, np.int32)
    for i, node in enumerate(sorted(leaves)):
        leaf_id[node] = i
        rows[i, :len(leaves[node])] = leaves[node]
    return {"node_min": np.stack(lo).astype(np.float32),
            "node_max": np.stack(hi).astype(np.float32),
            "node_children": np.asarray(kids, np.int32),
            "node_leaf_id": leaf_id, "leaf_tris": rows}


def _inverse(d):
    """1 / d, a component under 1e-30 in size taken as 1e-30 with its
    sign (-0.0 as +)."""
    tiny = torch.where(d >= 0, torch.full_like(d, 1e-30),
                       torch.full_like(d, -1e-30))
    return torch.ones_like(d) / torch.where(d.abs() > 1e-30, d, tiny)


def _slab(o, inv, bmin, bmax):
    """(entry clamped at 0, exit) of rays against their boxes."""
    t1 = (bmin - o) * inv
    t2 = (bmax - o) * inv
    near = torch.clamp(torch.minimum(t1, t2).amax(dim=-1), min=0.0)
    return near, torch.maximum(t1, t2).amin(dim=-1)


def entered(tree, o, d, t_hit):
    """-> (box tests, member tests) an exact walk needs: the nodes whose
    box each ray enters at t <= its hit's ``t_hit`` [R] (inf on a miss),
    and the real triangles of the leaves among them."""
    members = (tree["leaf_tris"] >= 0).sum(dim=1)
    inv = _inverse(d)
    boxes = tests = 0
    for n in range(tree["node_min"].shape[0]):
        near, far = _slab(o, inv, tree["node_min"][n], tree["node_max"][n])
        k = int(((far >= near) & (near <= t_hit)).sum())
        boxes += k
        leaf = int(tree["node_leaf_id"][n])
        if leaf >= 0:
            tests += k * int(members[leaf])
    return boxes, tests


def primary_walk_bound(ref, cam_rotation) -> dict:
    """Least time of the KD walk of one frame's camera rays, for the
    reference renderer ``ref`` (a float32 ``reference.render.Renderer``
    on the card) with the camera matrix ``cam_rotation``.

    Returns the bound (``bound_ms``, ``bound_by``), its ``box_tests``,
    ``member_tests`` and ``bytes``, and the frame's ``rays`` and
    ``hits``."""
    from reference.render import camera_rays

    s, dev = ref.s, ref.dev
    W, H = s.width, s.height
    tree = {k: torch.from_numpy(v).to(dev) for k, v in build_tree(
        s.params["vertices"].astype(np.float32), s.tri).items()}
    py, px = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    o, d = camera_rays(px.reshape(-1), py.reshape(-1), W, H, s.tan_half_fov,
                       ref.params["cam_position"].float(), cam_rotation)
    t_hit, tri = ref.closest(o, d)
    boxes, tests = entered(tree, o, d, t_hit)
    R = o.shape[0]
    num_bytes = (tree["node_min"].shape[0] * NODE_BYTES
                 + tree["leaf_tris"].numel() * LEAF_SLOT_BYTES
                 + ref.tri.shape[0] * PLANE_BYTES
                 + R * (RAY_BYTES + ANSWER_BYTES))
    flops = boxes * FLOPS_PER_BOX + tests * FLOPS_PER_MEMBER
    return {**bound_ms(num_bytes, flops), "box_tests": boxes,
            "member_tests": tests, "bytes": num_bytes, "rays": R,
            "hits": int((tri >= 0).sum())}

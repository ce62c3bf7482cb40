"""Host-side KD/AABB tree build: a copy of ``crt_tpu/scene/accel.py``.

The reference builder's semantics (crt_acceleration_tree.cpp:31-106):

  - root AABB = union of all triangle AABBs
  - midpoint split, axis alternating with depth (depth % 3)
  - triangles routed to children by inclusive AABB overlap, duplicated
    into both children when they straddle the split plane
  - child0 is created (and recursed into) before child1, which sets the
    node numbering
  - leaf when <= MAX_BOX_TRIANGLE_COUNT (16) triangles or
    depth > MAX_ACCELERATION_TREE_DEPTH (39)

flattened into an ``AccelTree`` of tensors.  The native builder
(``scene/native_accel.py``) runs the recursion in C++; this NumPy version
is its fallback and gives the same arrays.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from crt_tpu_torch.scene.types import (
    MAX_ACCELERATION_TREE_DEPTH,
    MAX_BOX_TRIANGLE_COUNT,
    AccelTree,
    resolve_device,
)

# Which builder made the last tree: "native" or "numpy".
last_builder = ""


def triangle_aabbs(vertices: np.ndarray, tri_vidx: np.ndarray):
    """Per-triangle AABBs -> (min [T,3], max [T,3])."""
    pts = vertices[tri_vidx]  # [T, 3, 3]
    return pts.min(axis=1), pts.max(axis=1)


def _build_host(tmin: np.ndarray, tmax: np.ndarray, max_depth: int,
                max_leaf: int):
    """The recursive build over triangle AABBs.

    Returns (node_min, node_max, node_children, leaf_lists) where leaf_lists
    maps node id -> triangle ids (original order, straddle duplicates
    included).
    """
    T = len(tmin)
    node_min: list[np.ndarray] = [tmin.min(axis=0)]
    node_max: list[np.ndarray] = [tmax.max(axis=0)]
    node_children: list[list[int]] = [[-1, -1]]
    leaf_lists: dict[int, np.ndarray] = {}

    def build_branch(parent: int, tris: np.ndarray, depth: int):
        """build_branch (crt_acceleration_tree.cpp:31-85), node numbering
        included: child0's whole subtree is emitted before child1."""
        if depth > max_depth or len(tris) <= max_leaf:
            leaf_lists[parent] = tris
            return

        axis = depth % 3
        bmin = node_min[parent]
        bmax = node_max[parent]
        mid = (bmin[axis] + bmax[axis]) * np.float32(0.5)

        c0_min, c0_max = bmin.copy(), bmax.copy()
        c0_max[axis] = mid
        c1_min, c1_max = bmin.copy(), bmax.copy()
        c1_min[axis] = mid

        lo = tmin[tris]
        hi = tmax[tris]
        # AABB::intersects: inclusive overlap (crt_aabb.h:37-45)
        in0 = np.all(lo <= c0_max, axis=1) & np.all(hi >= c0_min, axis=1)
        in1 = np.all(lo <= c1_max, axis=1) & np.all(hi >= c1_min, axis=1)
        t0 = tris[in0]
        t1 = tris[in1]

        for k, (cmin, cmax, sub) in enumerate(((c0_min, c0_max, t0),
                                               (c1_min, c1_max, t1))):
            if len(sub) > 0:
                idx = len(node_min)
                node_min.append(cmin)
                node_max.append(cmax)
                node_children.append([-1, -1])
                node_children[parent][k] = idx
                build_branch(idx, sub, depth + 1)

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, max_depth + 100))
    try:
        build_branch(0, np.arange(T, dtype=np.int32), 0)
    finally:
        sys.setrecursionlimit(old_limit)

    return node_min, node_max, node_children, leaf_lists


def build_accel_tree(
    vertices: np.ndarray,
    tri_vidx: np.ndarray,
    max_depth: int = MAX_ACCELERATION_TREE_DEPTH,
    max_leaf: int = MAX_BOX_TRIANGLE_COUNT,
    use_native: bool = True,
    device=None,
) -> AccelTree:
    """Build and flatten the acceleration tree of a triangle soup, its
    tensors on ``device`` (None: the card).  ``use_native`` takes the C++
    builder, and the NumPy one where the library will not build;
    ``last_builder`` says which ran."""
    global last_builder
    device = resolve_device(device)
    vertices = np.asarray(vertices, np.float32)
    tri_vidx = np.asarray(tri_vidx, np.int32)
    tmin, tmax = triangle_aabbs(vertices, tri_vidx)

    built = None
    if use_native:
        from crt_tpu_torch.scene import native_accel

        try:
            built = native_accel.build_host(tmin, tmax, max_depth, max_leaf)
            last_builder = "native"
        except (OSError, RuntimeError, ValueError, subprocess.SubprocessError):
            built = None
    if built is None:
        built = _build_host(tmin, tmax, max_depth, max_leaf)
        last_builder = "numpy"
    node_min, node_max, node_children, leaf_lists = built

    N = len(node_min)
    # leaves deeper than max_depth may hold more than max_leaf triangles:
    # every row is padded to the longest
    leaf_size = max(max_leaf,
                    max((len(v) for v in leaf_lists.values()), default=0))

    node_leaf_id = np.full(N, -1, np.int32)
    num_leaves = len(leaf_lists)
    leaf_tris = np.full((max(num_leaves, 1), leaf_size), -1, np.int32)
    leaf_node = np.zeros(max(num_leaves, 1), np.int32)
    for li, (nid, tris) in enumerate(sorted(leaf_lists.items())):
        node_leaf_id[nid] = li
        leaf_tris[li, :len(tris)] = tris
        leaf_node[li] = nid

    def t(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(device)

    return AccelTree(
        node_min=t(np.stack(node_min), np.float32),
        node_max=t(np.stack(node_max), np.float32),
        node_children=t(node_children, np.int32),
        node_leaf_id=t(node_leaf_id, np.int32),
        leaf_tris=t(leaf_tris, np.int32),
        leaf_node=t(leaf_node, np.int32),
        leaf_size=int(leaf_size),
        num_nodes=N,
        num_leaves=num_leaves,
    )

"""Scene-partitioned rendering: each rank holds 1/N of the scene.

Counterpart of ``crt_tpu/parallel/scene_sharded.py``.  The row-sharded
path (``sharded.py``) replicates the scene; this one covers scenes whose
per-triangle state should not be replicated.  On a 2-D ("rays", "scene")
mesh, the ranks of one "scene" group each hold one shard of:

  - the cluster tables (the Morton clusters of the whole scene's order,
    each rank building only its own block of clusters);
  - the packed shading table ([K, T], ``shade.build_packed``), split over
    the triangle axis, each rank building only its own block.

Every trace walks the rank's cluster shard (the cluster backend's closest
hit, or the streaming backend's closest hit and two-phase shadow pass)
and the partial answers are combined across the scene group by
all-reduces: the smallest t, then the smallest triangle id among the
lanes at that t; the streaming shadow bits are OR-ed (as int32: gloo
reduces no bool), phase 1's before the compaction, so every shard walks
the same survivors in phase 2.  Shading then needs the winning
triangle's packed rows: each rank reads the rows of the hits it owns and
one all-reduce sum assembles the [K, R] block on every rank of the group
(``make_partitioned_rows_fn``).  The "rays" axis splits the pixel rows as
``sharded.py`` does.  A refractive scene marches its shadow rays at full
width, reading the march's constants through the same exchange (as
crt_tpu does).

Gradients (``scene_sharded_value_and_grad``): the row exchange is a
differentiable sum whose backward sums the cotangents over the scene
group.  Every rank of a scene group computes the same loss from the same
exchanged rows, so each backpropagates ``loss / n_scene``; the parameter
gradients are then all-reduced once over the whole mesh, which gives the
single-device gradient.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from crt_tpu_torch.ops import stream_binning as sb
from crt_tpu_torch.ops.cluster_tables import (
    CLUSTER_SIZE,
    ClusterTables,
    build_cluster_tables,
)
from crt_tpu_torch.ops.cluster_trace import ClusterTracer
from crt_tpu_torch.ops.intersect import Hit
from crt_tpu_torch.ops.segsum import packed_gather
from crt_tpu_torch.ops.shade import build_packed
from crt_tpu_torch.ops.stream_trace import StreamTracer
from crt_tpu_torch.ops.tracer import Tracer
from crt_tpu_torch.parallel.sharded import (
    OneDeviceMesh,
    _grads,
    _leaves,
    _rows_loss,
    all_reduce,
    all_reduce_sum,
    assemble_rows,
    default_trainable_params,
    make_mesh,
    mesh_axis,
    reduce_loss_and_grads,
)
from crt_tpu_torch.renderer import (
    _CLUSTER_BACKENDS,
    _STREAM_BACKENDS,
    _render_flat,
    auto_backend,
)
from crt_tpu_torch.scene.types import RenderSettings, Scene

_BIG_ID = 2**30
_INF = 3.4e38


def _combine_hits_across(group, hit: Hit) -> Hit:
    """Min-combine partial closest hits over ``group``: the smallest t,
    then the smallest triangle id among the lanes at that t (ids are the
    scene's own, so they agree across shards); -1 stays a miss."""
    if group is None:
        return hit
    best_t = all_reduce(hit.t.clone(), dist.ReduceOp.MIN, group)
    cand = torch.where((hit.t <= best_t) & (hit.tri >= 0), hit.tri,
                       torch.full_like(hit.tri, _BIG_ID))
    best_tri = all_reduce(cand, dist.ReduceOp.MIN, group)
    best_tri = torch.where(best_tri >= _BIG_ID, torch.full_like(best_tri, -1),
                           best_tri)
    return Hit(t=best_t, tri=best_tri)


def _any_across(group, bits: torch.Tensor) -> torch.Tensor:
    """OR of boolean masks over ``group`` (an int32 MAX: gloo reduces no
    bool)."""
    if group is None:
        return bits
    return all_reduce(bits.to(torch.int32), dist.ReduceOp.MAX, group) > 0


def _pad_clusters(tables: ClusterTables, count: int) -> ClusterTables:
    """The cluster axis padded to ``count`` clusters with never-hit ones:
    degenerate test constants (c = 1, n = 0), inverted boxes (the binning
    admits none), tri_id -1.  ``rank`` is unchanged: padding moves no
    slot."""
    pad = count - tables.n.shape[0]
    if pad <= 0:
        return tables

    def grow(x, fill):
        return torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])

    return tables._replace(
        n=grow(tables.n, 0.0), nv0=grow(tables.nv0, 0.0),
        m=grow(tables.m, 0.0), c=grow(tables.c, 1.0),
        nobf=grow(tables.nobf, 0.0), tri_id=grow(tables.tri_id, -1),
        cl_min=grow(tables.cl_min, _INF), cl_max=grow(tables.cl_max, -_INF))


def pad_tables_for_shards(tables: ClusterTables, n: int) -> ClusterTables:
    """The whole scene's tables with the cluster axis padded to a multiple
    of ``n`` shards (see ``_pad_clusters``)."""
    L = tables.n.shape[0]
    return _pad_clusters(tables, -(-L // n) * n)


def build_partitioned_tables(scene: Scene, mesh, scene_axis: str = "scene"):
    """This rank's shard of the scene -> (tables, packed, shard_tris).

    ``tables``: its block of ``ceil(L / n)`` clusters of the whole scene's
    Morton order (the last shard padded with never-hit clusters), built
    alone: no rank builds or holds the whole tables.  ``packed``: its
    [K, shard_tris] block of the packed shading table (``_packed_shard``).
    ``shard_tris`` = ceil(T / n), the triangles of each packed block.
    """
    _, n, k = mesh_axis(mesh, scene_axis)
    with torch.no_grad():
        packed = _packed_shard(scene, n, k)
        return _tables_shard(scene, n, k), packed, packed.shape[1]


def _tables_shard(scene: Scene, n: int, k: int) -> ClusterTables:
    """Block ``k`` of ``n`` of the scene's cluster tables (see
    ``build_partitioned_tables``), built without gradient."""
    L = -(-scene.num_triangles // CLUSTER_SIZE)
    per = -(-L // n)
    with torch.no_grad():
        return _pad_clusters(build_cluster_tables(
            scene, clusters=slice(k * per, (k + 1) * per)), per)


def _packed_shard(scene: Scene, n: int, k: int) -> torch.Tensor:
    """Block ``k`` of ``n`` of the packed shading table -> [K, ceil(T / n)]:
    the columns of triangles ``k * ceil(T / n)`` on, built from those
    triangles alone and zero-padded past the last one.  It differentiates
    into the scene's tensors as the whole table does."""
    T = scene.num_triangles
    per = -(-T // n)
    lo, hi = min(k * per, T), min((k + 1) * per, T)
    part = build_packed(scene.replace(tri_vidx=scene.tri_vidx[lo:hi],
                                      tri_material=scene.tri_material[lo:hi]))
    return torch.cat([part, part.new_zeros((part.shape[0], per - (hi - lo)))],
                     dim=1)


def _resolve_shard_backend(local_tables: ClusterTables, backend: str) -> str:
    """The shard's backend: "auto" is the port's own rule on the shard
    (``renderer.auto_backend`` of the shard's clusters)."""
    if backend == "auto":
        return auto_backend(local_tables.n.shape[0], local_tables.n.is_cuda)
    if backend in _CLUSTER_BACKENDS:
        return "cluster"
    if backend in _STREAM_BACKENDS:
        return "stream"
    raise ValueError(f"unknown shard backend: {backend!r}")


class _PartitionedClusterTracer(Tracer):
    """The cluster backend's closest hit over a rank's table shard,
    combined over ``scene_group``; shading takes it for the shadow rays
    too (the base ``shadow``)."""

    def __init__(self, local_tables: ClusterTables, scene_group):
        self.local = ClusterTracer(local_tables)
        self.scene_group = scene_group

    def __call__(self, origins, dirs, active=None):
        return _combine_hits_across(self.scene_group,
                                    self.local(origins, dirs, active))


def make_partitioned_trace_fn(local_tables: ClusterTables, scene_group,
                              backend: str = "auto",
                              stream_tile_rays: int | None = None,
                              sc_clusters: int | None = None,
                              stream_shadow_k: int = 2,
                              read_rows=None) -> Tracer:
    """A tracer over a rank's cluster-table shard, its hits combined over
    ``scene_group`` (the process group of the mesh's scene axis; None for
    one rank).  "cluster" ("pallas"): the cluster backend's closest hit,
    which shading also takes for the shadow rays; "stream"
    ("pallas_stream"): the streaming backend, closest hit and two-phase
    shadow pass, each launch's answer combined (the shadow pass's phase 1
    before its compaction); "auto": ``_resolve_shard_backend``.  The
    tables' triangle ids are the scene's own, so no id is translated.
    ``read_rows`` (``make_partitioned_rows_fn``) is the tracer's packed-row
    read."""
    backend = _resolve_shard_backend(local_tables, backend)
    if backend == "stream":
        tracer = StreamTracer(
            local_tables, stream_tile_rays, sc_clusters or sb.SC_CLUSTERS,
            stream_shadow_k,
            combine_hits=lambda hit: _combine_hits_across(scene_group, hit),
            combine_bits=lambda bits: _any_across(scene_group, bits))
    else:
        tracer = _PartitionedClusterTracer(local_tables, scene_group)
    tracer.read_rows = read_rows
    return tracer


def make_partitioned_rows_fn(local_packed: torch.Tensor, shard_tris: int,
                             scene_group, shard: int):
    """The packed-row read of shading (a tracer's ``read_rows``) over a
    packed-table shard: the rank reads the rows of the hits whose triangle
    it owns (through ``segsum.packed_gather``, so a backward is the
    segment sum), zeros elsewhere, and one differentiable all-reduce sum
    assembles the whole [K, R] block on every rank of ``scene_group``."""

    def read_rows(tri):
        local = tri - shard * shard_tris
        mine = (local >= 0) & (local < shard_tris)
        ids = torch.where(mine, local, torch.full_like(local, -1))
        if local_packed.requires_grad and torch.is_grad_enabled():
            rows = packed_gather(local_packed, ids)
        else:
            rows = local_packed[:, ids.clamp(min=0).long()]
        rows = torch.where(mine[None], rows, torch.zeros((), device=rows.device))
        return all_reduce_sum(rows, scene_group)

    return read_rows


def _slim(scene: Scene) -> Scene:
    """The scene without its geometry (and tree): what shading reads of a
    partitioned scene besides the exchanged rows."""
    dev = scene.device
    empty = torch.zeros((0, 3), dtype=torch.float32, device=dev)
    return scene.replace(vertices=empty, vertex_normals=empty,
                         vertex_uvs=empty,
                         tri_vidx=torch.zeros((0, 3), dtype=torch.int32,
                                              device=dev),
                         accel=None)


def _default_mesh(mesh, rays_axis, scene_axis):
    if mesh is not None:
        return mesh
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return OneDeviceMesh((rays_axis, scene_axis))
    world = dist.get_world_size()
    return make_mesh((2, world // 2), (rays_axis, scene_axis))


def _partitioned_rows(scene, settings, mesh, rays_axis, scene_axis,
                      local_backend, stream_tile_rays, sc_clusters,
                      packed_local=None, tables=None):
    """This rank's row block of the partitioned render -> (rows, its first
    row, the rays group)."""
    rays_group, n_ray, i = mesh_axis(mesh, rays_axis)
    scene_group, _, k = mesh_axis(mesh, scene_axis)
    if tables is None:
        tables, packed_local, shard_tris = build_partitioned_tables(
            scene, mesh, scene_axis)
    else:
        shard_tris = packed_local.shape[1]
    tracer = make_partitioned_trace_fn(
        tables, scene_group, local_backend, stream_tile_rays=stream_tile_rays,
        sc_clusters=sc_clusters, stream_shadow_k=settings.stream_shadow_k,
        read_rows=make_partitioned_rows_fn(packed_local, shard_tris,
                                           scene_group, k))
    rows_per = -(-scene.height // n_ray)
    rows = _render_flat(_slim(scene), settings, row_offset=i * rows_per,
                        num_rows=rows_per, trace_fn=tracer)
    return rows, i * rows_per, rays_group


def render_image_scene_sharded(scene: Scene,
                               settings: RenderSettings | None = None,
                               mesh=None, rays_axis: str = "rays",
                               scene_axis: str = "scene",
                               local_backend: str = "auto",
                               stream_tile_rays: int | None = None,
                               sc_clusters: int | None = None
                               ) -> torch.Tensor:
    """Forward render on a 2-D (``rays_axis``, ``scene_axis``) mesh with
    the scene's per-triangle state partitioned over ``scene_axis`` -> the
    [height, width, 3] frame on every rank.

    The pixel rows are split over ``rays_axis``; the cluster tables and
    the packed table over ``scene_axis`` (module docstring).  Shading
    reads no geometry but the exchanged rows.  The image matches the
    single-device render up to the order of f32 sums (and the tie rule
    across shards).  Default mesh: 2 x (world / 2), as crt_tpu's."""
    settings = settings or RenderSettings()
    mesh = _default_mesh(mesh, rays_axis, scene_axis)
    with torch.no_grad():
        rows, start, rays_group = _partitioned_rows(
            scene, settings, mesh, rays_axis, scene_axis, local_backend,
            stream_tile_rays, sc_clusters)
        return assemble_rows(rows, start, scene.height, rays_group)


def scene_sharded_value_and_grad(scene: Scene, target: torch.Tensor,
                                 params: dict | None = None,
                                 settings: RenderSettings | None = None,
                                 mesh=None, rays_axis: str = "rays",
                                 scene_axis: str = "scene",
                                 local_backend: str = "auto",
                                 stream_tile_rays: int | None = None,
                                 sc_clusters: int | None = None):
    """The L2 loss and scene-parameter gradients of the partitioned render
    -> (loss, grads), the same on every rank and equal to the
    single-device ones.

    The parameters (default: ``default_trainable_params``) are replicated;
    the rank's block of the packed table is built from them each step, so
    the backward of the row exchange routes each hit row's cotangent to
    its owner and on into the parameters (the packed read's backward is
    the segment sum).  The cluster-table shards are built once
    from the scene, without gradient: hit ids are constants."""
    settings = settings or RenderSettings()
    mesh = _default_mesh(mesh, rays_axis, scene_axis)
    _, n_scene, k = mesh_axis(mesh, scene_axis)
    params = params if params is not None else default_trainable_params(scene)
    tables = _tables_shard(scene, n_scene, k)
    leaves = _leaves(params, scene.device)
    target = torch.as_tensor(target, device=scene.device)

    s = scene.replace(**leaves)
    packed_local = _packed_shard(s, n_scene, k)
    rows, start, _ = _partitioned_rows(
        s, settings, mesh, rays_axis, scene_axis, local_backend,
        stream_tile_rays, sc_clusters, packed_local=packed_local,
        tables=tables)
    loss = _rows_loss(rows, target, start, scene.height, scene.width)
    (loss / n_scene).backward()
    world = dist.group.WORLD if dist.is_initialized() \
        and dist.get_world_size() > 1 else None
    loss = reduce_loss_and_grads(loss / n_scene, leaves, world)
    return loss, _grads(leaves)

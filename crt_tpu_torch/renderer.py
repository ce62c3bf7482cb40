"""Top-level rendering entry points.

Counterpart of ``crt_tpu/renderer.py``.  ``render_image(scene, settings)``
renders a [height, width, 3] linear-color image on the device that holds
the scene's tensors: the pixel wavefront in 32x32 tile order, the closest
hit through the cluster backend or, for large scenes, the streaming
backend (their CUDA kernels on a CUDA scene, their plain versions on a CPU
scene) or the all-pairs backend, and the Whitted shading: the unrolled
recursion for linear trees, the iterative bank wavefront
(``ops/shade_iter.py``) for branching ones (live refraction at depth >= 2,
and diffuse GI).  The image is differentiable with respect to the scene's
float tensors; the backward of the packed-row read is the segment-sum
kernel (``ops/segsum.py``).  Without ``remat_shading``, a frame of the
iterative wavefront that builds a graph in several chunks shades each
chunk under a checkpoint, so its backward holds one chunk's graph at a
time.  ``render_aov`` renders an auxiliary pass (bary, normal, depth,
tri_id, albedo) from the primary hits on any backend.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from crt_tpu_torch.ops import camera as camera_ops
from crt_tpu_torch.ops import intersect as intersect_ops
from crt_tpu_torch.ops.cluster_tables import CLUSTER_SIZE, triangle_rank
from crt_tpu_torch.ops.shade import hit_attributes, shade_wavefront
from crt_tpu_torch.ops.shade_iter import pool_width, shade_wavefront_iter
from crt_tpu_torch.ops.texture import sample_textures
from crt_tpu_torch.ops.tracer import Tracer
from crt_tpu_torch.scene.types import RenderSettings, Scene, resolve_device
from crt_tpu_torch.utils import trace as tracing

# Wavefront pixel-tile shape: consecutive runs of TILE_H * TILE_W rays are
# one spatially coherent 32x32 block, the binning tile of the cluster trace.
TILE_H = 32
TILE_W = 32

# The auxiliary passes of render_aov, as crt_tpu names them.
AOVS = ("bary", "normal", "depth", "tri_id", "albedo")

_CLUSTER_BACKENDS = ("cluster", "pallas")
_STREAM_BACKENDS = ("stream", "pallas_stream")

# Cluster count above which ``backend="auto"`` takes the streaming backend
# on the card.  The cluster backend tests every tile against every cluster,
# so its Phase A grows with the scene; the streaming backend pays for its
# two-level lists and its two-phase shadow resolve whatever the size.
# Timed on make_big_scene at 1080p (``render_image``, depth 3, one light;
# medians of 6 frames, the two backends in turn) on an NVIDIA H100 80GB
# HBM3 (700 W), with each backend's Phase A one kernel, cluster against
# streaming: at 1,024 clusters (16,384 triangles) 10.993 against 12.302 ms;
# at 4,096 clusters (65,536 triangles) 17.783 against 20.059 ms; at 16,384
# clusters 112.563 against 51.049 ms.  So the two tie between 4,096 and
# 16,384 clusters, above this threshold, which was set where they tied
# before either Phase A was a kernel.  The benchmark's
# ``tri65k.frames`` cell renders 4,096 clusters through ``auto``: a move of
# the threshold shows there.
AUTO_STREAM_MIN_CLUSTERS = 4096

# Pool lanes (the widest level's banks x pixels) the iterative wavefront
# shades per chunk when ``chunk_pixels`` is not set and the frame casts
# shadow rays; four times as many when it casts none.  Sized for an 80 GB
# card from the peaks that chip_smoke.py reads on an NVIDIA H100 80GB HBM3
# (700 W): a 1080p frame at 8 banks (16.7 M lanes) peaks at 7.0 GiB
# forward and 45.8 GiB forward+backward, and fewer, wider chunks are
# faster.  So 2^24 lanes keep such a frame in one chunk and leave room for
# its backward; twice as many would not.  (``remat_shading`` cuts the
# backward's peak to about a third.)  A 1080p GI frame (K = 4, depth 3:
# at most 16 banks at once, 2 chunks) peaks at 11.9 GiB forward and 48.7
# GiB through its ``remat_shading`` gradient (measure/gi_chunks.py).
ITER_POOL_LANES = 1 << 24


def use_iterative_wavefront(scene: Scene, settings: RenderSettings) -> bool:
    """Shading-strategy policy: the iterative bank wavefront for branching
    trees (live refraction at depth >= 2, diffuse GI), the unrolled
    recursion for linear ones (diffuse and constant: one level; mirrors: a
    chain).  ``settings.wavefront`` "iter" / "recursive" overrides."""
    if settings.wavefront == "iter":
        return True
    if settings.wavefront == "recursive":
        return False
    branching = (scene.has_refractive and scene.refractions_on
                 and settings.max_ray_depth >= 2)
    return branching or scene.gi_on


def auto_backend(clusters: int, on_card: bool) -> str:
    """The backend ``backend="auto"`` takes for a scene (or a shard) of
    ``clusters`` clusters: the streaming one on the card above
    ``AUTO_STREAM_MIN_CLUSTERS``, the cluster one otherwise."""
    return ("stream" if on_card and clusters > AUTO_STREAM_MIN_CLUSTERS
            else "cluster")


class EmptyTracer(Tracer):
    """The backend of a scene without triangles: every ray misses."""

    def __call__(self, origins, dirs, active=None) -> intersect_ops.Hit:
        shape = origins.shape[:-1]
        return intersect_ops.Hit(
            t=torch.full(shape, float("inf"), device=origins.device),
            tri=torch.full(shape, -1, dtype=torch.int32,
                           device=origins.device),
        )


class BruteforceTracer(Tracer):
    """The all-pairs backend (``ops/intersect.py``)."""

    def __init__(self, scene: Scene):
        with tracing.span("crt.tables.triangles"):
            self.tri = intersect_ops.build_triangle_data(
                scene.vertices.detach(), scene.tri_vidx,
                scene.mat_backface[scene.tri_material.long()],
            )
        # the Morton rank keeps the segment sum's id bands narrow
        self.rank = triangle_rank(scene)

    def __call__(self, origins, dirs, active=None) -> intersect_ops.Hit:
        del active  # dense all-pairs compute; masking cannot skip work
        return intersect_ops.closest_hit_bruteforce(
            self.tri, origins.detach(), dirs.detach())


def make_trace_fn(scene: Scene, settings: RenderSettings) -> Tracer:
    """Build the intersection backend, a ``Tracer`` (``ops/tracer.py``).

    "cluster" and "pallas" (the crt_tpu name) are the binned cluster trace;
    "stream" and "pallas_stream" the two-level streaming trace for large
    scenes; "bruteforce" is the all-pairs backend; "tree" walks the scene's
    KD tree (``ops/traverse.py``).  "auto" is ``auto_backend``'s choice.
    """
    if scene.num_triangles == 0:
        return EmptyTracer()

    backend = settings.backend
    if backend == "auto":
        backend = auto_backend(-(-scene.num_triangles // CLUSTER_SIZE),
                               scene.device.type == "cuda")
    if backend in _CLUSTER_BACKENDS:
        from crt_tpu_torch.ops.cluster_trace import make_cluster_trace_fn

        return make_cluster_trace_fn(
            scene, compact_masked=settings.compact_bounces)
    if backend == "bruteforce":
        return BruteforceTracer(scene)
    if backend == "tree":
        from crt_tpu_torch.ops.traverse import TreeTracer

        return TreeTracer(scene)
    if backend in _STREAM_BACKENDS:
        from crt_tpu_torch.ops.stream_trace import make_stream_trace_fn

        return make_stream_trace_fn(scene,
                                    shadow_k=settings.stream_shadow_k)
    raise ValueError(f"unknown intersection backend: {backend!r}")


def make_tiler(h: int, w: int, row_offset: int = 0, device=None):
    """Pixel-tile reordering helpers for an h x w region.

    Returns (raster_x [R], raster_y [R], untile(colors [R, 3]) -> [h, w, 3])
    with rays ordered in TILE_H x TILE_W blocks, the rasters on ``device``
    (None: the card; RuntimeError where there is none).  ``row_offset``
    shifts raster_y for a row block of a sharded frame, so the rays and
    the GI streams' seeds are the whole frame's.
    """
    device = resolve_device(device)
    hp = -(-h // TILE_H) * TILE_H
    wp = -(-w // TILE_W) * TILE_W
    raster_y, raster_x = torch.meshgrid(
        torch.arange(hp, dtype=torch.float32, device=device) + row_offset,
        torch.arange(wp, dtype=torch.float32, device=device),
        indexing="ij",
    )

    def tile(x):
        trailing = x.shape[2:]
        x = x.reshape(hp // TILE_H, TILE_H, wp // TILE_W, TILE_W, *trailing)
        return x.movedim(1, 2).reshape(hp * wp, *trailing)

    def untile(x):
        trailing = x.shape[1:]
        x = x.reshape(hp // TILE_H, wp // TILE_W, TILE_H, TILE_W, *trailing)
        return x.movedim(2, 1).reshape(hp, wp, *trailing)[:h, :w]

    return tile(raster_x), tile(raster_y), untile


@tracing.spanned("crt.frame")
def _render_flat(scene: Scene, settings: RenderSettings, gi_salt=None, *,
                 row_offset: int = 0, num_rows: int | None = None,
                 trace_fn: Tracer | None = None) -> torch.Tensor:
    """The frame, or the ``num_rows`` rows from ``row_offset`` on (the row
    block of a sharded frame) -> [rows, width, 3].  ``trace_fn`` replaces
    the scene's backend (the scene-partitioned path,
    ``parallel/scene_sharded.py``, and tests)."""
    h, w = scene.height, scene.width
    rows = h if num_rows is None else num_rows
    rxf, ryf, untile = make_tiler(rows, w, row_offset=row_offset,
                                  device=scene.device)
    origins, dirs = camera_ops.generate_rays(
        scene.cam_position, scene.cam_rotation, scene.cam_tan_half_fov,
        w, h, rxf, ryf,
    )
    origins = origins.contiguous()
    # the raster as uint32 values: the seeds of the GI streams
    rx, ry = rxf.to(torch.int64), ryf.to(torch.int64)
    if trace_fn is None:
        trace_fn = make_trace_fn(scene, settings)
    use_iter = use_iterative_wavefront(scene, settings)
    shade_fn = shade_wavefront_iter if use_iter else shade_wavefront

    R = origins.shape[0]
    tile_sz = TILE_H * TILE_W
    chunk = settings.chunk_pixels
    if use_iter and not chunk:
        # the pool multiplies every per-bounce buffer by the banks it holds
        shadow_traces = scene.num_lights > 0 and not settings.no_shadows
        budget = ITER_POOL_LANES if shadow_traces else 4 * ITER_POOL_LANES
        chunk = max(tile_sz, budget // pool_width(scene, settings))
    # Without remat_shading, the graph of a frame in several chunks is held
    # one chunk at a time: each chunk is shaded under a checkpoint and
    # shaded again in the backward.  The 1080p GI frame's graph is ~55 KB
    # a pixel: held whole it ran out of an 80 GB card (a 78.1 GiB peak),
    # a chunk at a time it peaks at 53.8 GiB in 2.3-2.4 s (measure/
    # gi_grad.py on an NVIDIA H100 80GB HBM3, 700 W).
    remat_chunks = (use_iter and not settings.remat_shading
                    and torch.is_grad_enabled()
                    and any(t.requires_grad for t in scene.tensors().values()))

    def shade(o, d, a, x, y):
        return shade_fn(scene, settings, trace_fn, o, d, a, raster_x=x,
                        raster_y=y, gi_salt=gi_salt)

    if chunk and chunk < R:
        chunk = max(tile_sz, (chunk // tile_sz) * tile_sz)
        pad = (-R) % chunk
        act = torch.ones(R, dtype=torch.bool, device=origins.device)
        if pad:
            # Dead-ray padding: masked lanes are dropped from the binning.
            origins = torch.cat([origins, origins[:pad]])
            dirs = torch.cat([dirs, dirs[:pad]])
            rx, ry = torch.cat([rx, rx[:pad]]), torch.cat([ry, ry[:pad]])
            act = torch.cat([act, act.new_zeros(pad)])
        parts = []
        for s in range(0, R + pad, chunk):
            args = (origins[s:s + chunk], dirs[s:s + chunk],
                    act[s:s + chunk], rx[s:s + chunk], ry[s:s + chunk])
            parts.append(checkpoint(shade, *args, use_reentrant=False)
                         if remat_chunks else shade(*args))
        color = torch.cat(parts)[:R]
    else:
        color = shade(origins, dirs, None, rx, ry)
    return untile(color)


def _graph_if_needed(scene: Scene, fn, *args) -> torch.Tensor:
    """``fn(*args)`` with an autograd graph only when a scene tensor
    requires grad."""
    if any(t.requires_grad for t in scene.tensors().values()):
        return fn(*args)
    with torch.no_grad():
        return fn(*args)


def render_image_hwc(scene: Scene, settings: RenderSettings | None = None,
                     gi_salt=None) -> torch.Tensor:
    """Render to a [height, width, 3] float32 linear-color image on the
    scene's device, or the AOV ``settings.aov`` names (``render_aov``).
    The image differentiates with respect to every scene tensor that
    requires grad (hit ids, occlusion masks and GI samples are constants);
    a scene with none renders without an autograd graph.  ``gi_salt`` (an
    int or an integer scalar tensor) forks the per-pixel GI streams: pass k
    of a progressive accumulation renders with salt k, and salt 0 is the
    plain render bit for bit (``progressive.py``)."""
    settings = settings or RenderSettings()
    if settings.aov:
        return render_aov(scene, settings, aov=settings.aov)
    return _graph_if_needed(scene, _render_flat, scene, settings, gi_salt)


def render_image(scene: Scene, settings: RenderSettings | None = None,
                 gi_salt=None) -> torch.Tensor:
    """Alias of render_image_hwc — the ``crt::render_image`` equivalent."""
    return render_image_hwc(scene, settings, gi_salt)


def aov_values(scene: Scene, origins: torch.Tensor, dirs: torch.Tensor,
               hit, aov: str, rank=None) -> torch.Tensor:
    """The AOV ``aov`` of rays [R, 3] whose closest hits are ``hit`` ->
    [R, 3]; a miss takes the background colour.  ``rank`` is the tracer's
    triangle id -> Morton rank map, where it has one."""
    if aov not in AOVS:
        raise ValueError(f"unknown aov {aov!r}")
    attrs = hit_attributes(scene, origins, dirs, hit, rank=rank,
                           force_all=True)
    if aov == "bary":
        # the 09-01 course visualization: (bary_u, bary_v, 0)
        out = torch.stack([attrs.bary_u, attrs.bary_v,
                           torch.zeros_like(attrs.bary_u)], -1)
    elif aov == "normal":
        out = attrs.normal * 0.5 + 0.5
    elif aov == "depth":
        out = attrs.t[..., None].expand(-1, 3)
    elif aov == "tri_id":
        # the original triangle id, a constant
        tid = hit.tri.detach().to(torch.float32)
        out = torch.stack([tid % 256.0 / 255.0,
                           (tid // 256.0) % 256.0 / 255.0,
                           torch.zeros_like(tid)], -1)
    else:
        out = sample_textures(scene, attrs.albedo_tex, attrs.uv,
                              attrs.bary_u, attrs.bary_v,
                              live=attrs.valid)
    return torch.where(attrs.valid[..., None], out, scene.background_color)


@tracing.spanned("crt.frame")
def _render_aov_flat(scene: Scene, settings: RenderSettings,
                     aov: str) -> torch.Tensor:
    h, w = scene.height, scene.width
    # the beauty pass's pixel-tile ray order: the binning's tiles
    rxf, ryf, untile = make_tiler(h, w, device=scene.device)
    origins, dirs = camera_ops.generate_rays(
        scene.cam_position, scene.cam_rotation, scene.cam_tan_half_fov,
        w, h, rxf, ryf,
    )
    origins = origins.contiguous()
    trace_fn = make_trace_fn(scene, settings)
    with tracing.span("crt.trace.primary"):
        hit = trace_fn(origins, dirs, None)
    return untile(aov_values(scene, origins, dirs, hit, aov,
                             rank=trace_fn.rank))


def render_aov(scene: Scene, settings: RenderSettings | None = None,
               aov: str = "") -> torch.Tensor:
    """Render an auxiliary output from the primary hits -> [height, width,
    3] float32 on the scene's device; miss pixels take the background.

    ``aov`` (default ``settings.aov``, then "bary"): "bary" (the 09-01
    course visualization), "normal" (the shading normal * 0.5 + 0.5),
    "depth" (the hit distance), "tri_id" (the original triangle id, its
    low and high bytes / 255) or "albedo" (the sampled texture); another
    name raises ValueError.  Any backend, whatever ``settings.wavefront``
    says: only primary rays are traced.  The image differentiates with
    respect to the scene tensors that require grad, as render_image's."""
    settings = settings or RenderSettings()
    aov = aov or settings.aov or "bary"
    return _graph_if_needed(scene, _render_aov_flat, scene, settings, aov)

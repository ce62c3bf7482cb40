"""Top-level rendering entry points.

Counterpart of ``crt_tpu/renderer.py``.  ``render_image(scene, settings)``
renders a [height, width, 3] linear-color image on the device that holds
the scene's tensors: the pixel wavefront in 32x32 tile order, the closest
hit through the cluster backend (its CUDA kernels on a CUDA scene, their
plain versions on a CPU scene) or the all-pairs backend, and the unrolled
Whitted shading.  The image is differentiable with respect to the scene's
float tensors; the backward of the packed-row read is the segment-sum
kernel (``ops/segsum.py``).
"""

from __future__ import annotations

import torch

from crt_tpu_torch.ops import camera as camera_ops
from crt_tpu_torch.ops import intersect as intersect_ops
from crt_tpu_torch.ops.shade import check_supported, shade_wavefront
from crt_tpu_torch.scene.types import RenderSettings, Scene

# Wavefront pixel-tile shape: consecutive runs of TILE_H * TILE_W rays are
# one spatially coherent 32x32 block, the binning tile of the cluster trace.
TILE_H = 32
TILE_W = 32

_CLUSTER_BACKENDS = ("auto", "cluster", "pallas")


def make_trace_fn(scene: Scene, settings: RenderSettings):
    """Build the intersection backend ``trace_fn(origins, dirs, active)``.

    "auto", "cluster" and "pallas" (the crt_tpu name) are the binned
    cluster trace; "bruteforce" is the all-pairs backend.
    """
    if scene.num_triangles == 0:
        def empty_trace(origins, dirs, active=None):
            shape = origins.shape[:-1]
            return intersect_ops.Hit(
                t=torch.full(shape, float("inf"), device=origins.device),
                tri=torch.full(shape, -1, dtype=torch.int32,
                               device=origins.device),
            )

        return empty_trace

    backend = settings.backend
    if backend in _CLUSTER_BACKENDS:
        from crt_tpu_torch.ops.cluster_trace import make_cluster_trace_fn

        return make_cluster_trace_fn(scene)
    if backend == "bruteforce":
        tri = intersect_ops.build_triangle_data(
            scene.vertices.detach(), scene.tri_vidx,
            scene.mat_backface[scene.tri_material.long()],
        )

        def trace(origins, dirs, active=None):
            del active  # dense all-pairs compute; masking cannot skip work
            return intersect_ops.closest_hit_bruteforce(
                tri, origins.detach(), dirs.detach())

        # the Morton rank keeps the segment sum's id bands narrow
        from crt_tpu_torch.ops.cluster_tables import triangle_rank

        trace.rank = triangle_rank(scene)
        return trace
    if backend == "tree":
        raise NotImplementedError(
            "the tree backend is not ported yet (ROADMAP A12)")
    if backend == "pallas_stream":
        raise NotImplementedError(
            "the streaming backend is not ported yet (ROADMAP A11)")
    raise ValueError(f"unknown intersection backend: {backend!r}")


def make_tiler(h: int, w: int, device="cpu"):
    """Pixel-tile reordering helpers for an h x w region.

    Returns (raster_x [R], raster_y [R], untile(colors [R, 3]) -> [h, w, 3])
    with rays ordered in TILE_H x TILE_W blocks.
    """
    hp = -(-h // TILE_H) * TILE_H
    wp = -(-w // TILE_W) * TILE_W
    raster_y, raster_x = torch.meshgrid(
        torch.arange(hp, dtype=torch.float32, device=device),
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


def _render_flat(scene: Scene, settings: RenderSettings) -> torch.Tensor:
    h, w = scene.height, scene.width
    rxf, ryf, untile = make_tiler(h, w, device=scene.device)
    origins, dirs = camera_ops.generate_rays(
        scene.cam_position, scene.cam_rotation, scene.cam_tan_half_fov,
        w, h, rxf, ryf,
    )
    origins = origins.contiguous()
    trace_fn = make_trace_fn(scene, settings)

    R = origins.shape[0]
    tile_sz = TILE_H * TILE_W
    chunk = settings.chunk_pixels
    if chunk and chunk < R:
        chunk = max(tile_sz, (chunk // tile_sz) * tile_sz)
        pad = (-R) % chunk
        act = torch.ones(R, dtype=torch.bool, device=origins.device)
        if pad:
            # Dead-ray padding: masked lanes are dropped from the binning.
            origins = torch.cat([origins, origins[:pad]])
            dirs = torch.cat([dirs, dirs[:pad]])
            act = torch.cat([act, act.new_zeros(pad)])
        color = torch.cat([
            shade_wavefront(scene, settings, trace_fn, origins[s:s + chunk],
                            dirs[s:s + chunk], act[s:s + chunk])
            for s in range(0, R + pad, chunk)
        ])[:R]
    else:
        color = shade_wavefront(scene, settings, trace_fn, origins, dirs)
    return untile(color)


def render_image_hwc(scene: Scene,
                     settings: RenderSettings | None = None) -> torch.Tensor:
    """Render to a [height, width, 3] float32 linear-color image on the
    scene's device.  The image differentiates with respect to every scene
    tensor that requires grad (hit ids and occlusion masks are constants);
    a scene with none renders without an autograd graph."""
    settings = settings or RenderSettings()
    check_supported(scene, settings)
    if any(t.requires_grad for t in scene.tensors().values()):
        return _render_flat(scene, settings)
    with torch.no_grad():
        return _render_flat(scene, settings)


def render_image(scene: Scene,
                 settings: RenderSettings | None = None) -> torch.Tensor:
    """Alias of render_image_hwc — the ``crt::render_image`` equivalent."""
    return render_image_hwc(scene, settings)

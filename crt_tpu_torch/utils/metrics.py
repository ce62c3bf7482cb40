"""Observability: ray accounting, throughput, binning statistics.

Counterpart of ``crt_tpu/utils/metrics.py``.  The reference publishes one
wall-clock number per render (main.cpp:37-43).  Here a counting tracer
around the backend sees every trace call's batch, so a render
reports exact trace and ray counts and Mrays/s; ``profile_render`` runs it
under ``torch.profiler`` and writes a Chrome trace; ``binning_stats``
reports the cluster binning of the primary wavefront.
"""

from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass

import torch

from crt_tpu_torch.ops import camera as camera_ops
from crt_tpu_torch.ops.shade import shade_wavefront
from crt_tpu_torch.ops.tracer import Tracer
from crt_tpu_torch.renderer import make_tiler, make_trace_fn
from crt_tpu_torch.scene.types import RenderSettings, Scene


@dataclass
class RenderStats:
    width: int = 0
    height: int = 0
    num_traces: int = 0
    rays_traced: int = 0
    primary_rays: int = 0
    wall_seconds: float = 0.0

    @property
    def mrays_per_second(self) -> float:
        if self.wall_seconds <= 0:
            return 0.0
        return self.rays_traced / self.wall_seconds / 1e6

    @property
    def primary_mrays_per_second(self) -> float:
        if self.wall_seconds <= 0:
            return 0.0
        return self.primary_rays / self.wall_seconds / 1e6

    def as_dict(self) -> dict:
        return {
            "resolution": f"{self.width}x{self.height}",
            "num_traces": self.num_traces,
            "rays_traced": self.rays_traced,
            "primary_rays": self.primary_rays,
            "wall_seconds": self.wall_seconds,
            "mrays_per_second": round(self.mrays_per_second, 2),
            "primary_mrays_per_second": round(self.primary_mrays_per_second, 2),
        }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _CountingTracer(Tracer):
    """``base``'s closest hit, counted into ``stats``.  It keeps the base
    class's shadow pass (a closest hit and a compare), no rows and no
    rank, so every trace of the frame passes through the count."""

    def __init__(self, base: Tracer, stats: RenderStats):
        self.base, self.stats = base, stats

    def __call__(self, origins, dirs, active=None):
        self.stats.num_traces += 1
        self.stats.rays_traced += origins[..., 0].numel()
        return self.base(origins, dirs, active)


def render_with_stats(scene: Scene, settings: RenderSettings | None = None):
    """Render one frame on the scene's device -> (image, RenderStats).

    The frame is the unrolled recursion through a counting tracer around
    the backend (``_CountingTracer``: every pass, shadows too, is a
    closest hit, as in the reference); its traces and rays are those of
    this call, and the time is the host clock around it, ending in a device
    synchronize.  The first call in a process also pays the kernels'
    build: call it twice for a steady-state time.
    """
    settings = settings or RenderSettings()
    stats = RenderStats(width=scene.width, height=scene.height)
    dev = scene.device
    counting = _CountingTracer(make_trace_fn(scene, settings), stats)

    h, w = scene.height, scene.width
    _sync(dev)
    start = time.perf_counter()
    with torch.no_grad():
        rx, ry, untile = make_tiler(h, w, device=dev)
        origins, dirs = camera_ops.generate_rays(
            scene.cam_position, scene.cam_rotation, scene.cam_tan_half_fov,
            w, h, rx, ry)
        color = shade_wavefront(
            scene, settings, counting, origins.contiguous(), dirs,
            raster_x=rx.to(torch.int64), raster_y=ry.to(torch.int64))
        img = untile(color)
    _sync(dev)
    stats.wall_seconds = time.perf_counter() - start
    stats.primary_rays = h * w
    return img, stats


def profile_render(scene, settings=None, logdir: str | None = None):
    """Render once under ``torch.profiler`` (the card's kernels too, on a
    CUDA scene) -> (image, stats, logdir); the Chrome trace is
    ``logdir/trace.json`` (default: ``crt_tpu_torch_profile`` in the
    temporary directory)."""
    settings = settings or RenderSettings()
    logdir = logdir or os.path.join(tempfile.gettempdir(),
                                    "crt_tpu_torch_profile")
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if scene.device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        img, stats = render_with_stats(scene, settings)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    return img, stats, logdir


def binning_stats(scene, settings=None) -> dict:
    """Cluster-binning statistics of the primary wavefront (the cluster
    backend's Phase A), in the renderer's pixel-tile ray order."""
    from crt_tpu_torch.ops.binning import bin_rays
    from crt_tpu_torch.ops.cluster_tables import (
        TILE_RAYS,
        build_cluster_tables,
    )

    with torch.no_grad():
        tables = build_cluster_tables(scene)
        h, w = scene.height, scene.width
        rx, ry, _ = make_tiler(h, w, device=scene.device)
        origins, dirs = camera_ops.generate_rays(
            scene.cam_position, scene.cam_rotation, scene.cam_tan_half_fov,
            w, h, rx, ry)
        o = origins.reshape(-1, 3)
        d = dirs.reshape(-1, 3)
        R = (o.shape[0] // TILE_RAYS) * TILE_RAYS
        _, counts = bin_rays(tables, o[:R], d[:R], TILE_RAYS)
    counts = counts.cpu().numpy()
    L = int(tables.n.shape[0])
    return {
        "clusters": L,
        "tiles": int(counts.size),
        "mean_clusters_per_tile": float(counts.mean()),
        "max_clusters_per_tile": int(counts.max()),
        "triangles_tested_per_ray": float(counts.mean()) * tables.n.shape[1],
        "cull_ratio": 1.0 - float(counts.mean()) / max(L, 1),
    }

"""Single-pixel ray flight recorder: the reference's DebugLog.

Counterpart of ``crt_tpu/utils/debug.py``.  The reference collects the rays
of one hard-coded pixel and flushes them as ``bpy.ops.crt.debug_ray_add``
lines for replay in Blender (crt_debug.cpp:11-39).  Here any pixel can be
traced: the wavefront is one ray, shaded by the unrolled recursion through
a recording tracer around the backend, which logs every traced ray
(primary, shadow, reflection, refraction, GI) with its hit distance.  It
keeps the base tracer's shadow pass, a closest hit, so every pass (shadows
too) is recorded, on any backend.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from crt_tpu_torch.ops import camera as camera_ops
from crt_tpu_torch.ops.shade import shade_wavefront
from crt_tpu_torch.ops.tracer import Tracer
from crt_tpu_torch.renderer import make_trace_fn
from crt_tpu_torch.scene.types import RenderSettings


@dataclass
class RayLogEntry:
    origin: np.ndarray
    direction: np.ndarray
    length: float  # hit distance, inf on a miss
    order: int  # trace order (0 = primary)


@dataclass
class DebugRayLog:
    raster_x: int
    raster_y: int
    color: np.ndarray = None
    entries: List[RayLogEntry] = field(default_factory=list)

    def to_blender_script(self) -> str:
        """Replay lines in the reference's format (crt_debug.cpp:29-38)."""
        lines = []
        for e in self.entries:
            length = float(e.length) if np.isfinite(e.length) else 1.0
            lines.append(
                "bpy.ops.crt.debug_ray_add("
                f"origin=({e.origin[0]}, {e.origin[1]}, {e.origin[2]}), "
                f"direction=({e.direction[0]}, {e.direction[1]}, "
                f"{e.direction[2]}), "
                f"length={length}, "
                f"depth={e.order}, "
                f"raster_coords=({self.raster_x}, {self.raster_y}), "
                "axis_forward='-Z', axis_up='Y')"
            )
        return "\n".join(lines) + "\n"


class _RecordingTracer(Tracer):
    """``base``'s closest hit, every ray logged into ``log`` with the
    order of its trace call.  It keeps the base class's shadow pass, so
    shadow rays are logged too."""

    def __init__(self, base: Tracer, log: DebugRayLog):
        self.base, self.log, self.calls = base, log, 0

    def __call__(self, origins, dirs, active=None):
        hit = self.base(origins, dirs, active)
        o = origins.detach().reshape(-1, 3).cpu().numpy()
        d = dirs.detach().reshape(-1, 3).cpu().numpy()
        t = hit.t.reshape(-1).cpu().numpy()
        for k in range(len(o)):
            self.log.entries.append(RayLogEntry(o[k], d[k], float(t[k]),
                                                self.calls))
        self.calls += 1
        return hit


def trace_pixel(scene, raster_x: int, raster_y: int,
                settings: RenderSettings | None = None) -> DebugRayLog:
    """Shade one pixel on the scene's device, recording every ray the
    wavefront traces for it."""
    settings = settings or RenderSettings()
    log = DebugRayLog(raster_x=raster_x, raster_y=raster_y)
    recording = _RecordingTracer(make_trace_fn(scene, settings), log)

    dev = scene.device
    rx = torch.tensor([float(raster_x)], device=dev)
    ry = torch.tensor([float(raster_y)], device=dev)
    origins, dirs = camera_ops.generate_rays(
        scene.cam_position, scene.cam_rotation, scene.cam_tan_half_fov,
        scene.width, scene.height, rx, ry)
    with torch.no_grad():
        color = shade_wavefront(
            scene, settings, recording, origins.reshape(-1, 3),
            dirs.reshape(-1, 3), raster_x=rx.to(torch.int64),
            raster_y=ry.to(torch.int64))
    log.color = color.cpu().numpy()[0]
    return log

"""Vectorized pinhole camera ray generation.

Counterpart of ``crt_tpu/ops/camera.py``, op for op: pixel centers at +0.5,
y flipped, aspect ratio on x only, tan(fov/2) on both axes, direction
(sx, sy, -1) rotated with the row-vector convention, then normalized.
"""

from __future__ import annotations

import torch

from crt_tpu_torch.ops import vecmath


def generate_rays(
    cam_position: torch.Tensor,  # [3]
    cam_rotation: torch.Tensor,  # [3, 3] row-major
    tan_half_fov: torch.Tensor,  # [] tan(fov/2)
    width: int,
    height: int,
    raster_x: torch.Tensor | None = None,  # optional [...] pixel x coords
    raster_y: torch.Tensor | None = None,  # optional [...] pixel y coords
):
    """Return (origins [..., 3], directions [..., 3]) for the given pixels.

    With no explicit coords, generates the full [height, width] grid.
    """
    device = cam_position.device
    if raster_x is None:
        raster_y, raster_x = torch.meshgrid(
            torch.arange(height, dtype=torch.float32, device=device),
            torch.arange(width, dtype=torch.float32, device=device),
            indexing="ij",
        )
    raster_x = raster_x.to(torch.float32)
    raster_y = raster_y.to(torch.float32)

    ndc_x = (raster_x + 0.5) / width
    ndc_y = (raster_y + 0.5) / height
    screen_x = 2.0 * ndc_x - 1.0
    screen_y = 1.0 - 2.0 * ndc_y
    screen_x = screen_x * (float(width) / float(height))
    screen_x = screen_x * tan_half_fov
    screen_y = screen_y * tan_half_fov

    local = torch.stack(
        [screen_x, screen_y, -torch.ones_like(screen_x)], dim=-1
    )  # [..., 3]
    world = vecmath.rotate_rows(local, cam_rotation)
    directions = vecmath.normalize(world)
    origins = cam_position.expand(directions.shape)
    return origins, directions

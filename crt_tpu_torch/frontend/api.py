"""Python API mirroring the reference CPython module ``_crt``.

Counterpart of ``crt_tpu/frontend/api.py``: the same names and contracts,
so a caller such as a Blender add-on can swap backends with an import
change.

  - ``render_scene_from_dict(scene_dict, asset_root, settings)`` returns a
    flat list of (r, g, b, 1.0) tuples with the rows flipped vertically
    (Blender's convention);
  - ``render_scene_from_dict_array`` is the array variant: float32
    [H, W, 4] RGBA, V-flipped, as a numpy array;
  - ``RendererSettings`` is the positional 6-tuple of ``_crt``, and the
    ``DEFAULT_*`` constants are its defaults.

Both render functions build the scene on ``device`` (None: the card; it
raises where there is none, ``"cpu"`` asks for the CPU).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

from crt_tpu_torch.renderer import render_image_hwc
from crt_tpu_torch.scene.json_loader import scene_from_dict
from crt_tpu_torch.scene.types import (
    DEFAULT_DIFFUSE_REFLECTION_BIAS,
    DEFAULT_DIFFUSE_REFLECTION_RAY_COUNT,
    DEFAULT_MAX_RAY_DEPTH,
    DEFAULT_REFLECTION_BIAS,
    DEFAULT_REFRACTION_BIAS,
    DEFAULT_SCENE_BUCKET_SIZE,
    DEFAULT_SHADOW_BIAS,
)
from crt_tpu_torch.scene.types import RenderSettings as _RenderSettings

__all__ = [
    "DEFAULT_DIFFUSE_REFLECTION_BIAS",
    "DEFAULT_DIFFUSE_REFLECTION_RAY_COUNT",
    "DEFAULT_MAX_RAY_DEPTH",
    "DEFAULT_REFLECTION_BIAS",
    "DEFAULT_REFRACTION_BIAS",
    "DEFAULT_SCENE_BUCKET_SIZE",
    "DEFAULT_SHADOW_BIAS",
    "RendererSettings",
    "render_scene_from_dict",
    "render_scene_from_dict_array",
]


class RendererSettings(NamedTuple):
    """The positional 6-tuple of ``_crt.RendererSettings``."""

    max_ray_depth: int = DEFAULT_MAX_RAY_DEPTH
    diffuse_reflection_ray_count: int = DEFAULT_DIFFUSE_REFLECTION_RAY_COUNT
    shadow_bias: float = DEFAULT_SHADOW_BIAS
    reflection_bias: float = DEFAULT_REFLECTION_BIAS
    diffuse_reflection_bias: float = DEFAULT_DIFFUSE_REFLECTION_BIAS
    refraction_bias: float = DEFAULT_REFRACTION_BIAS


def _to_settings(rs) -> _RenderSettings:
    """A ``RenderSettings`` as it is, or any 6-sequence in
    ``RendererSettings``' order."""
    if isinstance(rs, _RenderSettings):
        return rs
    vals = tuple(rs)
    return _RenderSettings(
        max_ray_depth=int(vals[0]),
        diffuse_reflection_ray_count=int(vals[1]),
        shadow_bias=float(vals[2]),
        reflection_bias=float(vals[3]),
        diffuse_reflection_bias=float(vals[4]),
        refraction_bias=float(vals[5]),
    )


def render_scene_from_dict_array(
    scene_dict: dict,
    asset_root: str = "/",
    renderer_settings: RendererSettings | Sequence | None = None,
    device=None,
) -> np.ndarray:
    """Render a scene dict -> float32 [H, W, 4] RGBA, rows flipped
    vertically (the Blender Combined-pass convention)."""
    settings = _to_settings(renderer_settings or RendererSettings())
    scene = scene_from_dict(scene_dict, asset_root=asset_root, strict=True,
                            device=device)
    img = render_image_hwc(scene, settings).cpu().numpy().astype(np.float32)
    rgba = np.concatenate([img, np.ones_like(img[..., :1])], axis=-1)
    return rgba[::-1]  # V-flip


def render_scene_from_dict(
    scene_dict: dict,
    asset_root: str = "/",
    renderer_settings: RendererSettings | Sequence | None = None,
    device=None,
) -> list:
    """The ``_crt`` contract: a flat list of (r, g, b, 1.0) tuples,
    V-flipped."""
    rgba = render_scene_from_dict_array(scene_dict, asset_root,
                                        renderer_settings, device=device)
    return [tuple(px) for px in rgba.reshape(-1, 4).tolist()]

"""crt_tpu_torch — the PyTorch / CUDA port of crt_tpu.

A second package beside ``crt_tpu`` (the JAX reference, which stays as it
is).  It imports torch and numpy, never JAX and never ``crt_tpu``.  It
renders the Whitted image and differentiates it: ``.crtscene`` loading,
raygen in 32x32 pixel tiles, the binned cluster trace through two
hand-written CUDA kernels (closest hit with emitted rows, w-form shadow
occlusion), diffuse / reflective / constant shading with point-light
shadows, gradients with respect to the scene's float tensors (the backward
of the packed-row read is a third CUDA kernel, the segment sum), and
``fit_scene``, the inverse-rendering loop.  Scenes are built on the card
unless the caller passes ``device="cpu"``.  What is not ported yet raises
``NotImplementedError`` naming its ROADMAP item.
"""

from crt_tpu_torch.optim import fit_scene
from crt_tpu_torch.renderer import render_image, render_image_hwc
from crt_tpu_torch.scene.json_loader import (
    load_scene,
    scene_from_dict,
    scene_from_json,
)
from crt_tpu_torch.scene.types import RenderSettings, Scene

__all__ = [
    "RenderSettings",
    "Scene",
    "fit_scene",
    "load_scene",
    "scene_from_dict",
    "scene_from_json",
    "render_image",
    "render_image_hwc",
]

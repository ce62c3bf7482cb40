"""crt_tpu_torch — the PyTorch / CUDA port of crt_tpu.

A second package beside ``crt_tpu`` (the JAX reference, which stays as it
is).  It imports torch and numpy, never JAX and never ``crt_tpu``.  It
renders the Whitted image and differentiates it: ``.crtscene`` loading,
raygen in 32x32 pixel tiles, the binned cluster trace through
hand-written CUDA kernels (closest hit with emitted rows, the same over
the live tiles only, w-form shadow occlusion with its glass-router modes),
all four texture types (bitmaps through the stb_image-exact JPEG
decoder), diffuse / reflective / refractive / constant shading with point-light
shadows that bend through glass, diffuse GI on per-pixel PCG32 streams
(and its progressive accumulation, ``render_progressive``), the iterative
bank wavefront for branching trees, gradients with respect to the scene's
float tensors (the backward of the packed-row read is another CUDA kernel,
the segment sum), the AOV passes (``render_aov``: bary, normal, depth,
tri_id, albedo), the ``_crt``-style API (``frontend/api.py``), the KD-tree
backend (``backend="tree"``, the tree built at load by ``scene/accel.py``
and its native builder), the utilities (``utils/``: camera rig, one-pixel
ray log, render statistics and profile, numerical checks, golden
comparison, the early-era images), ``fit_scene``, the inverse-rendering
loop, the Blender add-on (``frontend/blender``) and the parallel paths
(``parallel``: rows sharded over ``torch.distributed`` ranks, the scene
partitioned over them, the multi-process runtime; ``fit_scene(mesh=)``).
Scenes are built on the card unless the caller passes ``device="cpu"``.
"""

from crt_tpu_torch.optim import fit_scene
from crt_tpu_torch.progressive import render_progressive
from crt_tpu_torch.renderer import render_aov, render_image, render_image_hwc
from crt_tpu_torch.scene.json_loader import (
    load_scene,
    scene_from_dict,
    scene_from_json,
)
from crt_tpu_torch.scene.types import AccelTree, RenderSettings, Scene

__all__ = [
    "AccelTree",
    "RenderSettings",
    "Scene",
    "fit_scene",
    "load_scene",
    "scene_from_dict",
    "scene_from_json",
    "render_aov",
    "render_image",
    "render_image_hwc",
    "render_progressive",
]

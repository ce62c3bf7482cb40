"""CRT Torch Blender RenderEngine.

Counterpart of ``crt_tpu/frontend/blender/engine.py`` (a functional mirror
of the reference engine, bl_crt_engine.py:12-65): build a scene dict from
the depsgraph, render it through the port's
``frontend/api.render_scene_from_dict_array`` on ``DEVICE``, write the
V-flipped RGBA rows into the Combined pass, and register the engine into
the standard property panels.  The engine's idname is ``CRT_TORCH``, its
own beside crt_tpu's ``CRT_TPU``.
"""

from __future__ import annotations

try:
    import bpy
except ImportError:  # pragma: no cover - outside Blender
    bpy = None

ENGINE_ID = "CRT_TORCH"

# The device the engine renders on: None is the card (frontend/api.py).
DEVICE = None


class CRTTorchRenderEngine(bpy.types.RenderEngine if bpy else object):
    bl_idname = ENGINE_ID
    bl_label = "CRT Torch"
    bl_use_preview = False

    def render(self, depsgraph):
        from crt_tpu_torch.frontend import api
        from crt_tpu_torch.frontend.blender.scene_bridge import (
            build_scene_dict,
        )

        scene = depsgraph.scene
        scale = scene.render.resolution_percentage / 100.0
        width = int(scene.render.resolution_x * scale)
        height = int(scene.render.resolution_y * scale)

        scene_dict = build_scene_dict(depsgraph)

        crt = getattr(scene, "crt", None)
        if crt is not None:
            settings = api.RendererSettings(
                max_ray_depth=crt.max_ray_depth,
                diffuse_reflection_ray_count=crt.diffuse_reflection_ray_count,
                shadow_bias=crt.shadow_bias,
                reflection_bias=crt.reflection_bias,
                diffuse_reflection_bias=crt.diffuse_reflection_bias,
                refraction_bias=crt.refraction_bias,
            )
        else:
            settings = api.RendererSettings()

        rgba = api.render_scene_from_dict_array(scene_dict, "/", settings,
                                                device=DEVICE)

        result = self.begin_result(0, 0, width, height)
        layer = result.layers[0].passes["Combined"]
        layer.rect = rgba.reshape(-1, 4)
        self.end_result(result)


_COMPATIBLE_PANELS = (
    "RENDER_PT_output",
    "RENDER_PT_format",
    "RENDER_PT_dimensions",
    "DATA_PT_lens",
    "DATA_PT_camera",
    "MATERIAL_PT_preview",
)


def register():
    bpy.utils.register_class(CRTTorchRenderEngine)
    for panel in bpy.types.Panel.__subclasses__():
        if getattr(panel, "bl_idname", None) in _COMPATIBLE_PANELS or (
            hasattr(panel, "COMPAT_ENGINES")
            and "BLENDER_RENDER" in getattr(panel, "COMPAT_ENGINES", ())
        ):
            panel.COMPAT_ENGINES.add(CRTTorchRenderEngine.bl_idname)


def unregister():
    bpy.utils.unregister_class(CRTTorchRenderEngine)
    for panel in bpy.types.Panel.__subclasses__():
        if hasattr(panel, "COMPAT_ENGINES"):
            panel.COMPAT_ENGINES.discard(CRTTorchRenderEngine.bl_idname)

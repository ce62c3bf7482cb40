"""Property panels for the CRT Torch engine (counterpart of
``crt_tpu/frontend/blender/ui.py``; mirror of bl_crt_ui.py:13-156)."""

from __future__ import annotations

try:
    import bpy
except ImportError:  # pragma: no cover - outside Blender
    bpy = None

from crt_tpu_torch.frontend.blender.engine import ENGINE_ID

if bpy:

    class CRT_PT_render_settings(bpy.types.Panel):
        bl_idname = "CRT_PT_render_settings"
        bl_label = "CRT Settings"
        bl_space_type = "PROPERTIES"
        bl_region_type = "WINDOW"
        bl_context = "render"
        COMPAT_ENGINES = {ENGINE_ID}

        @classmethod
        def poll(cls, context):
            return context.engine == ENGINE_ID

        def draw(self, context):
            crt = context.scene.crt
            col = self.layout.column()
            col.prop(crt, "bucket_size")
            col.prop(crt, "max_ray_depth")
            col.prop(crt, "gi_on")
            col.prop(crt, "diffuse_reflection_ray_count")
            col.prop(crt, "reflections_on")
            col.prop(crt, "refractions_on")
            col.separator()
            col.prop(crt, "shadow_bias")
            col.prop(crt, "reflection_bias")
            col.prop(crt, "diffuse_reflection_bias")
            col.prop(crt, "refraction_bias")

    class CRT_PT_material(bpy.types.Panel):
        bl_idname = "CRT_PT_material"
        bl_label = "CRT Material"
        bl_space_type = "PROPERTIES"
        bl_region_type = "WINDOW"
        bl_context = "material"
        COMPAT_ENGINES = {ENGINE_ID}

        @classmethod
        def poll(cls, context):
            return context.engine == ENGINE_ID and context.material

        def draw(self, context):
            crt = context.material.crt
            col = self.layout.column()
            col.prop(crt, "type")
            col.prop(crt, "smooth_shading")
            col.prop(crt, "back_face_culling")
            if crt.type == "REFRACTIVE":
                col.prop(crt, "ior")
            else:
                col.prop(crt, "albedo")
                col.prop(crt, "albedo_texture")

    class CRT_PT_light(bpy.types.Panel):
        bl_idname = "CRT_PT_light"
        bl_label = "CRT Light"
        bl_space_type = "PROPERTIES"
        bl_region_type = "WINDOW"
        bl_context = "data"
        COMPAT_ENGINES = {ENGINE_ID}

        @classmethod
        def poll(cls, context):
            return (
                context.engine == ENGINE_ID
                and getattr(context, "light", None) is not None
            )

        def draw(self, context):
            self.layout.prop(context.light.crt, "intensity")

    class CRT_PT_texture(bpy.types.Panel):
        bl_idname = "CRT_PT_texture"
        bl_label = "CRT Texture"
        bl_space_type = "PROPERTIES"
        bl_region_type = "WINDOW"
        bl_context = "texture"
        COMPAT_ENGINES = {ENGINE_ID}

        @classmethod
        def poll(cls, context):
            return context.engine == ENGINE_ID and context.texture

        def draw(self, context):
            crt = context.texture.crt
            col = self.layout.column()
            col.prop(crt, "enabled")
            col.prop(crt, "type")
            if crt.type == "ALBEDO":
                col.prop(crt, "albedo")
            elif crt.type == "EDGES":
                col.prop(crt, "edge_color")
                col.prop(crt, "inner_color")
                col.prop(crt, "edge_width")
            elif crt.type == "CHECKER":
                col.prop(crt, "color_a")
                col.prop(crt, "color_b")
                col.prop(crt, "square_size")

    _CLASSES = (
        CRT_PT_render_settings,
        CRT_PT_material,
        CRT_PT_light,
        CRT_PT_texture,
    )

    def register():
        for c in _CLASSES:
            bpy.utils.register_class(c)

    def unregister():
        for c in reversed(_CLASSES):
            bpy.utils.unregister_class(c)

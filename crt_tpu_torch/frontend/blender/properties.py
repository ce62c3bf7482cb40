"""PropertyGroups for scenes, materials, lights, textures.

Counterpart of ``crt_tpu/frontend/blender/properties.py``, under the same
names (``Scene.crt``, ``Material.crt``, ...).  Functional mirror of bl_crt_properties.py:6-130: scene-level renderer
settings (defaults pulled from the framework constants exactly as the
reference pulls from ``_crt``), per-material CRT type/smooth/ior/albedo,
per-texture CRT parameters.
"""

from __future__ import annotations

try:
    import bpy
    from bpy.props import (
        BoolProperty,
        EnumProperty,
        FloatProperty,
        FloatVectorProperty,
        IntProperty,
        PointerProperty,
        StringProperty,
    )
except ImportError:  # pragma: no cover - outside Blender
    bpy = None

from crt_tpu_torch.scene.types import (
    DEFAULT_DIFFUSE_REFLECTION_BIAS,
    DEFAULT_DIFFUSE_REFLECTION_RAY_COUNT,
    DEFAULT_MAX_RAY_DEPTH,
    DEFAULT_REFLECTION_BIAS,
    DEFAULT_REFRACTION_BIAS,
    DEFAULT_SCENE_BUCKET_SIZE,
    DEFAULT_SHADOW_BIAS,
)

if bpy:

    class CRTSceneProperties(bpy.types.PropertyGroup):
        bucket_size: IntProperty(
            name="Bucket Size", default=DEFAULT_SCENE_BUCKET_SIZE, min=1
        )
        gi_on: BoolProperty(name="Global Illumination", default=False)
        reflections_on: BoolProperty(name="Reflections", default=True)
        refractions_on: BoolProperty(name="Refractions", default=True)
        max_ray_depth: IntProperty(
            name="Max Ray Depth", default=DEFAULT_MAX_RAY_DEPTH, min=0
        )
        diffuse_reflection_ray_count: IntProperty(
            name="GI Ray Count",
            default=DEFAULT_DIFFUSE_REFLECTION_RAY_COUNT, min=0,
        )
        shadow_bias: FloatProperty(
            name="Shadow Bias", default=DEFAULT_SHADOW_BIAS, precision=4
        )
        reflection_bias: FloatProperty(
            name="Reflection Bias", default=DEFAULT_REFLECTION_BIAS, precision=4
        )
        diffuse_reflection_bias: FloatProperty(
            name="GI Bias", default=DEFAULT_DIFFUSE_REFLECTION_BIAS, precision=4
        )
        refraction_bias: FloatProperty(
            name="Refraction Bias", default=DEFAULT_REFRACTION_BIAS, precision=4
        )

    class CRTMaterialProperties(bpy.types.PropertyGroup):
        type: EnumProperty(
            name="Type",
            items=[
                ("DIFFUSE", "Diffuse", ""),
                ("REFLECTIVE", "Reflective", ""),
                ("REFRACTIVE", "Refractive", ""),
                ("CONSTANT", "Constant", ""),
            ],
            default="DIFFUSE",
        )
        smooth_shading: BoolProperty(name="Smooth Shading", default=False)
        back_face_culling: BoolProperty(name="Back-face Culling", default=False)
        ior: FloatProperty(name="IOR", default=1.0, min=0.0)
        albedo: FloatVectorProperty(
            name="Albedo", subtype="COLOR", size=3,
            default=(0.8, 0.8, 0.8), min=0.0, max=1.0,
        )
        albedo_texture: StringProperty(
            name="Albedo Texture", description="CRT texture name (optional)"
        )

    class CRTLightProperties(bpy.types.PropertyGroup):
        intensity: FloatProperty(name="Intensity", default=1000.0, min=0.0)

    class CRTTextureProperties(bpy.types.PropertyGroup):
        enabled: BoolProperty(name="Export as CRT texture", default=False)
        type: EnumProperty(
            name="Type",
            items=[
                ("ALBEDO", "Albedo", ""),
                ("EDGES", "Edges", ""),
                ("CHECKER", "Checker", ""),
                ("BITMAP", "Bitmap", ""),
            ],
            default="ALBEDO",
        )
        albedo: FloatVectorProperty(subtype="COLOR", size=3,
                                    default=(1.0, 1.0, 1.0))
        edge_color: FloatVectorProperty(subtype="COLOR", size=3,
                                        default=(0.0, 0.0, 0.0))
        inner_color: FloatVectorProperty(subtype="COLOR", size=3,
                                         default=(1.0, 1.0, 1.0))
        edge_width: FloatProperty(default=0.05, min=0.0)
        color_a: FloatVectorProperty(subtype="COLOR", size=3,
                                     default=(1.0, 1.0, 1.0))
        color_b: FloatVectorProperty(subtype="COLOR", size=3,
                                     default=(0.0, 0.0, 0.0))
        square_size: FloatProperty(default=0.125, min=0.0)

    _CLASSES = (
        CRTSceneProperties,
        CRTMaterialProperties,
        CRTLightProperties,
        CRTTextureProperties,
    )

    def register():
        for c in _CLASSES:
            bpy.utils.register_class(c)
        bpy.types.Scene.crt = PointerProperty(type=CRTSceneProperties)
        bpy.types.Material.crt = PointerProperty(type=CRTMaterialProperties)
        bpy.types.Light.crt = PointerProperty(type=CRTLightProperties)
        bpy.types.Texture.crt = PointerProperty(type=CRTTextureProperties)

    def unregister():
        del bpy.types.Texture.crt
        del bpy.types.Light.crt
        del bpy.types.Material.crt
        del bpy.types.Scene.crt
        for c in reversed(_CLASSES):
            bpy.utils.unregister_class(c)

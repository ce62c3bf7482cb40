"""Operators: .crtscene import/export + debug-ray visualization.

Counterpart of ``crt_tpu/frontend/blender/ops.py``, under the same
idnames.  Functional mirror of bl_crt_ops.py:8-46 (file-menu import/export) plus the
debug-ray-add operator the reference DebugLog replay script targets
(crt_debug.cpp:29-38 emits ``bpy.ops.crt.debug_ray_add(...)`` lines).
"""

from __future__ import annotations

import json

try:
    import bpy
    from bpy_extras.io_utils import ExportHelper, ImportHelper
except ImportError:  # pragma: no cover - outside Blender
    bpy = None

if bpy:

    class CRT_OT_export_scene(bpy.types.Operator, ExportHelper):
        bl_idname = "crt.export_scene"
        bl_label = "Export .crtscene"
        filename_ext = ".crtscene"

        def execute(self, context):
            from crt_tpu_torch.frontend.blender.scene_bridge import (
                build_scene_dict,
            )

            depsgraph = context.evaluated_depsgraph_get()
            data = build_scene_dict(depsgraph)
            with open(self.filepath, "w") as f:
                json.dump(data, f, indent=1)
            self.report({"INFO"}, f"Wrote {self.filepath}")
            return {"FINISHED"}

    class CRT_OT_import_scene(bpy.types.Operator, ImportHelper):
        bl_idname = "crt.import_scene"
        bl_label = "Import .crtscene"
        filename_ext = ".crtscene"

        def execute(self, context):
            from crt_tpu_torch.frontend.blender.scene_bridge import (
                import_scene_dict,
            )

            with open(self.filepath) as f:
                data = json.load(f)
            import_scene_dict(data)
            self.report({"INFO"}, f"Imported {self.filepath}")
            return {"FINISHED"}

    class CRT_OT_debug_ray_add(bpy.types.Operator):
        """Add a debug-ray empty (target of the DebugLog replay script)."""

        bl_idname = "crt.debug_ray_add"
        bl_label = "Add CRT Debug Ray"

        origin: bpy.props.FloatVectorProperty(size=3)
        direction: bpy.props.FloatVectorProperty(size=3)
        length: bpy.props.FloatProperty(default=1.0)
        depth: bpy.props.IntProperty(default=0)
        raster_coords: bpy.props.IntVectorProperty(size=2)
        axis_forward: bpy.props.StringProperty(default="-Z")
        axis_up: bpy.props.StringProperty(default="Y")

        def execute(self, context):
            from crt_tpu_torch.frontend.blender.scene_bridge import r2b_vec
            from mathutils import Vector

            o = Vector(r2b_vec(self.origin))
            d = Vector(r2b_vec(self.direction))
            name = (
                f"crt_ray_{self.raster_coords[0]}_{self.raster_coords[1]}"
                f"_d{self.depth}"
            )
            empty = bpy.data.objects.new(name, None)
            empty.empty_display_type = "SINGLE_ARROW"
            empty.location = o
            if d.length > 0:
                empty.rotation_mode = "QUATERNION"
                empty.rotation_quaternion = d.to_track_quat("Z", "Y")
                empty.empty_display_size = max(self.length, 0.01)
            context.collection.objects.link(empty)
            return {"FINISHED"}

    def _menu_export(self, context):
        self.layout.operator(CRT_OT_export_scene.bl_idname)

    def _menu_import(self, context):
        self.layout.operator(CRT_OT_import_scene.bl_idname)

    _CLASSES = (CRT_OT_export_scene, CRT_OT_import_scene, CRT_OT_debug_ray_add)

    def register():
        for c in _CLASSES:
            bpy.utils.register_class(c)
        bpy.types.TOPBAR_MT_file_export.append(_menu_export)
        bpy.types.TOPBAR_MT_file_import.append(_menu_import)

    def unregister():
        bpy.types.TOPBAR_MT_file_import.remove(_menu_import)
        bpy.types.TOPBAR_MT_file_export.remove(_menu_export)
        for c in reversed(_CLASSES):
            bpy.utils.unregister_class(c)

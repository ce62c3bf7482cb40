"""Blender <-> .crtscene dict conversion.

A copy of ``crt_tpu/frontend/blender/scene_bridge.py`` (host code only).

Axis convention: Blender is Z-up right-handed with -Y forward; the renderer
is Y-up right-handed with -Z camera forward (same mapping the reference
bridge uses, reference src/blender/bl_crt_json.py:11-19).  The conversion is
the fixed permutation  (x, y, z)_blender -> (x, z, -y)_renderer.

Export walks the evaluated depsgraph: triangulated world-space meshes with
per-loop-vertex UVs, CRT material/texture custom properties, point lights,
and the active camera (FOV from ``cam.angle``, the sensor-fit axis — same
as the reference add-on, even though the renderer reads fov as vertical).
Import rebuilds Blender objects from a .crtscene dict.
"""

from __future__ import annotations

import math

try:
    import bpy
    import bmesh
    from mathutils import Matrix
except ImportError:  # pragma: no cover - outside Blender
    bpy = None


def b2r_vec(v):
    """Blender Z-up -> renderer Y-up: (x, y, z) -> (x, z, -y)."""
    return [v[0], v[2], -v[1]]


def r2b_vec(v):
    """Renderer Y-up -> Blender Z-up: (x, y, z) -> (x, -z, y)."""
    return [v[0], -v[2], v[1]]


_B2R = None
if bpy is not None:
    _B2R = Matrix(((1, 0, 0), (0, 0, 1), (0, -1, 0)))


def b2r_mat3(m):
    """Rotation matrix in renderer space, row-major row-vector convention.

    One-sided conversion, matching the reference exporter
    (bl_crt_json.py:22,109): the renderer matrix is ``(_B2R @ M).T`` — the
    change of basis re-expresses the camera's world columns in renderer
    axes; the camera's *local* axes are identified 1:1 (Blender camera
    looks along local -Z, renderer camera looks along -Z).  The transpose
    converts column-vector form to the renderer's row-vector convention.
    """
    rt = (_B2R @ m.to_3x3()).transposed()
    return [v for row in rt for v in row]


def build_camera(scene, depsgraph) -> dict:
    cam_obj = scene.camera
    if cam_obj is None:
        raise ValueError("scene has no active camera")
    mw = cam_obj.matrix_world
    # Reference parity (bl_crt_json.py:114): export ``cam.angle`` — the
    # sensor-fit axis FOV (horizontal for a landscape sensor), even though
    # the renderer treats fov as vertical.  Deliberately matches the
    # reference add-on's behavior rather than "fixing" it to angle_y.
    fov = math.degrees(cam_obj.data.angle)
    return {
        "position": b2r_vec(mw.translation),
        "matrix": b2r_mat3(mw),
        "fov_degrees": fov,
    }


def build_lights(depsgraph) -> list:
    lights = []
    for inst in depsgraph.object_instances:
        ob = inst.object
        if ob.type != "LIGHT" or ob.data.type != "POINT":
            continue
        crt = getattr(ob.data, "crt", None)
        intensity = crt.intensity if crt else ob.data.energy
        lights.append(
            {
                "intensity": float(intensity),
                "position": b2r_vec(inst.matrix_world.translation),
            }
        )
    return lights


def build_textures() -> list:
    out = []
    for tex in bpy.data.textures:
        crt = getattr(tex, "crt", None)
        if crt is None or not crt.enabled:
            continue
        t = {"name": tex.name, "type": crt.type.lower()}
        if crt.type == "ALBEDO":
            t["albedo"] = list(crt.albedo)
        elif crt.type == "EDGES":
            t.update(
                edge_color=list(crt.edge_color),
                inner_color=list(crt.inner_color),
                edge_width=crt.edge_width,
            )
        elif crt.type == "CHECKER":
            t.update(
                color_A=list(crt.color_a),
                color_B=list(crt.color_b),
                square_size=crt.square_size,
            )
        elif crt.type == "BITMAP":
            if tex.type != "IMAGE" or tex.image is None:
                raise ValueError(f"bitmap texture {tex.name!r} needs an image")
            t["file_path"] = bpy.path.abspath(tex.image.filepath)
        out.append(t)
    return out


def build_materials() -> tuple[list, dict]:
    mats = []
    index_of = {}
    for mat in bpy.data.materials:
        crt = getattr(mat, "crt", None)
        if crt is None:
            continue
        index_of[mat.name] = len(mats)
        m = {
            "type": crt.type.lower(),
            "smooth_shading": crt.smooth_shading,
            "back_face_culling": crt.back_face_culling,
        }
        if crt.type == "REFRACTIVE":
            m["ior"] = crt.ior
        elif crt.albedo_texture:
            m["albedo"] = crt.albedo_texture
        else:
            m["albedo"] = list(crt.albedo)
        mats.append(m)
    if not mats:
        mats.append(
            {"type": "diffuse", "albedo": [0.8, 0.8, 0.8],
             "smooth_shading": False}
        )
    return mats, index_of


def build_objects(depsgraph, material_index_of) -> list:
    objects = []
    for inst in depsgraph.object_instances:
        ob = inst.object
        if ob.type != "MESH":
            continue
        mesh = ob.evaluated_get(depsgraph).to_mesh()
        bm = bmesh.new()
        bm.from_mesh(mesh)
        bmesh.ops.triangulate(bm, faces=bm.faces)
        bm.transform(inst.matrix_world)

        uv_layer = bm.loops.layers.uv.active
        verts, uvs, tris = [], [], []
        index_map = {}

        def vkey(loop):
            co = loop.vert.co
            uv = loop[uv_layer].uv if uv_layer else (0.0, 0.0)
            return (co.x, co.y, co.z, uv[0], uv[1])

        for face in bm.faces:
            idx = []
            for loop in face.loops:
                k = vkey(loop)
                if k not in index_map:
                    index_map[k] = len(verts) // 3
                    verts.extend(b2r_vec(loop.vert.co))
                    uv = loop[uv_layer].uv if uv_layer else (0.0, 0.0)
                    uvs.extend([uv[0], uv[1], 0.0])
                idx.append(index_map[k])
            tris.extend(idx)
        bm.free()

        mat_index = 0
        if ob.material_slots and ob.material_slots[0].material:
            mat_index = material_index_of.get(
                ob.material_slots[0].material.name, 0
            )
        objects.append(
            {
                "material_index": mat_index,
                "vertices": verts,
                "uvs": uvs,
                "triangles": tris,
            }
        )
    return objects


def build_scene_dict(depsgraph) -> dict:
    scene = depsgraph.scene
    crt = getattr(scene, "crt", None)
    render = scene.render
    scale = render.resolution_percentage / 100.0
    mats, index_of = build_materials()
    d = {
        "settings": {
            "background_color": list(scene.world.color)
            if scene.world else [0.0, 0.0, 0.0],
            "image_settings": {
                "width": int(render.resolution_x * scale),
                "height": int(render.resolution_y * scale),
            },
        },
        "camera": build_camera(scene, depsgraph),
        "lights": build_lights(depsgraph),
        "textures": build_textures(),
        "materials": mats,
        "objects": build_objects(depsgraph, index_of),
    }
    if crt is not None:
        d["settings"]["image_settings"]["bucket_size"] = crt.bucket_size
        d["settings"]["gi_on"] = crt.gi_on
        d["settings"]["reflections_on"] = crt.reflections_on
        d["settings"]["refractions_on"] = crt.refractions_on
    return d


# --------------------------------------------------------------------------
# Import: .crtscene dict -> Blender data
# --------------------------------------------------------------------------

def import_scene_dict(d: dict, collection=None):
    """Rebuild Blender objects from a .crtscene dict (functional mirror of
    the reference importer, bl_crt_json.py:228-401)."""
    coll = collection or bpy.context.collection

    materials = []
    for i, mv in enumerate(d.get("materials", [])):
        mat = bpy.data.materials.new(f"crt_material_{i}")
        if hasattr(mat, "crt"):
            mat.crt.type = mv.get("type", "diffuse").upper()
            mat.crt.smooth_shading = mv.get("smooth_shading", False)
            mat.crt.back_face_culling = mv.get("back_face_culling", False)
            if isinstance(mv.get("albedo"), list):
                mat.crt.albedo = mv["albedo"]
            elif isinstance(mv.get("albedo"), str):
                mat.crt.albedo_texture = mv["albedo"]
            mat.crt.ior = mv.get("ior", 1.0)
        materials.append(mat)

    for oi, ov in enumerate(d.get("objects", [])):
        verts = ov["vertices"]
        tris = ov["triangles"]
        mesh = bpy.data.meshes.new(f"crt_mesh_{oi}")
        bverts = [r2b_vec(verts[i : i + 3]) for i in range(0, len(verts), 3)]
        faces = [tuple(tris[i : i + 3]) for i in range(0, len(tris), 3)]
        mesh.from_pydata(bverts, [], faces)
        uvs = ov.get("uvs")
        if uvs:
            layer = mesh.uv_layers.new()
            for loop in mesh.loops:
                u, v = uvs[3 * loop.vertex_index], uvs[3 * loop.vertex_index + 1]
                layer.data[loop.index].uv = (u, v)
        mesh.update()
        ob = bpy.data.objects.new(f"crt_object_{oi}", mesh)
        mi = ov.get("material_index", 0)
        if mi < len(materials):
            ob.data.materials.append(materials[mi])
        coll.objects.link(ob)

    for li, lv in enumerate(d.get("lights", [])):
        light = bpy.data.lights.new(f"crt_light_{li}", "POINT")
        light.energy = lv["intensity"]
        ob = bpy.data.objects.new(f"crt_light_{li}", light)
        ob.location = r2b_vec(lv["position"])
        coll.objects.link(ob)

    cam = d.get("camera")
    if cam:
        camera = bpy.data.cameras.new("crt_camera")
        if "fov_degrees" in cam:
            # Mirror of export: the reference stores the sensor-fit-axis
            # angle (bl_crt_json.py:310).
            camera.angle = math.radians(cam["fov_degrees"])
        ob = bpy.data.objects.new("crt_camera", camera)
        ob.location = r2b_vec(cam["position"])
        m = cam["matrix"]
        rt = Matrix(
            ((m[0], m[3], m[6]), (m[1], m[4], m[7]), (m[2], m[5], m[8]))
        )  # transpose back to column-vector form
        # Inverse of the one-sided export conversion (reference
        # bl_crt_json.py:313-321): matrix_world = _B2R^T @ R (no trailing
        # _B2R factor — export is (_B2R @ M).T, see b2r_mat3).
        ob.matrix_world = _B2R.transposed().to_4x4() @ rt.to_4x4()
        ob.location = r2b_vec(cam["position"])
        coll.objects.link(ob)
        bpy.context.scene.camera = ob

""".crtscene JSON -> Scene.

A copy of the parsing in ``crt_tpu/scene/json_loader.py``, kept here
because importing any ``crt_tpu`` module imports JAX.  Same rules, same
errors, same legacy 07-/08-era handling; the arrays it builds are
bit-identical to crt_tpu's, bitmap textures included (decoded by the
stb_image-exact baseline JPEG decoder copied into ``io/jpeg_stb.py``, PIL
for other files).  The KD acceleration tree of the tree backend is built
at load (``scene/accel.py``), as crt_tpu builds it.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any

import numpy as np
import torch

from crt_tpu_torch.scene.accel import build_accel_tree
from crt_tpu_torch.scene.types import (
    DEFAULT_SCENE_BUCKET_SIZE,
    MATERIAL_REFRACTIVE,
    MATERIAL_TYPE_NAMES,
    TEXTURE_ALBEDO,
    TEXTURE_TYPE_NAMES,
    Scene,
    resolve_device,
)


class SceneFormatError(ValueError):
    """Raised on malformed .crtscene content."""


def _require(cond: bool, msg: str):
    if not cond:
        raise SceneFormatError(msg)


def _vec3(v: Any, what: str) -> np.ndarray:
    _require(
        isinstance(v, list) and len(v) == 3
        and all(isinstance(x, (int, float)) for x in v),
        f"{what}: expected [x, y, z]",
    )
    return np.asarray(v, np.float32)


def _mat3(v: Any, what: str) -> np.ndarray:
    _require(
        isinstance(v, list) and len(v) == 9
        and all(isinstance(x, (int, float)) for x in v),
        f"{what}: expected 9 numbers",
    )
    return np.asarray(v, np.float32).reshape(3, 3)


def load_scene(path: str, device=None, **kwargs) -> Scene:
    """Load a .crtscene file onto ``device`` (None: the card);
    asset_root = the file's directory."""
    with open(path, "rb") as f:
        data = json.load(f)
    asset_root = kwargs.pop("asset_root", os.path.dirname(os.path.abspath(path)))
    return scene_from_dict(data, asset_root=asset_root, device=device,
                           **kwargs)


def scene_from_json(text: str, asset_root: str = "/", device=None,
                    **kwargs) -> Scene:
    return scene_from_dict(json.loads(text), asset_root=asset_root,
                           device=device, **kwargs)


def accumulate_vertex_normals(pos: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Smooth vertex normals: each triangle adds its normalized face normal
    to its three vertices, then each vertex sum is normalized.
    Unreferenced vertices keep zero."""
    if len(idx) == 0:
        return np.zeros_like(pos)
    v0 = pos[idx[:, 0]]
    v1 = pos[idx[:, 1]]
    v2 = pos[idx[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    norm = np.linalg.norm(fn, axis=1, keepdims=True)
    fn = fn / np.where(norm > 0, norm, 1.0)

    out = np.zeros_like(pos)
    for k in range(3):
        np.add.at(out, idx[:, k], fn)
    n = np.linalg.norm(out, axis=1, keepdims=True)
    return (out / np.where(n > 0, n, 1.0)).astype(np.float32)


def _load_bitmap(path: str) -> np.ndarray:
    """Decode an image file to float32 [H, W, 3] RGB / 255, as crt_tpu
    does: baseline JPEGs through the stb_image-exact decoder (the
    reference's ``stbi_load`` texels byte for byte), PNGs through
    ``io/png.py`` (PIL's RGB bytes), PIL for every other file and for JPEG
    features outside the baseline path.  PIL is imported only then; where
    it is missing, the ImportError names the file."""
    if path.lower().endswith(".png"):
        from crt_tpu_torch.io import png

        return png.read_png(path).astype(np.float32) / 255.0
    if path.lower().endswith((".jpg", ".jpeg")):
        from crt_tpu_torch.io import jpeg_stb

        try:
            return jpeg_stb.decode_file(path).astype(np.float32) / 255.0
        except jpeg_stb.UnsupportedJPEG:
            pass
    try:
        from PIL import Image as PILImage
    except ImportError as e:
        raise ImportError(
            f"decoding the bitmap texture {path!r} needs PIL, which is not "
            "installed (only baseline JPEGs decode without it)") from e

    with PILImage.open(path) as im:
        return np.asarray(im.convert("RGB"), np.float32) / 255.0


def _parse_textures(tex_list: Any, asset_root: str):
    """Parse the textures array -> (tables, bitmaps, name->index map)."""
    tables = {"type": [], "color_a": [], "color_b": [], "scalar": [],
              "bitmap": []}
    bitmaps: list[np.ndarray] = []
    name_map: dict[str, int] = {}
    if tex_list is None:
        return tables, bitmaps, name_map

    _require(isinstance(tex_list, list), "textures must be an array")
    for i, tv in enumerate(tex_list):
        _require(isinstance(tv, dict), "texture must be an object")
        name = tv.get("name")
        _require(isinstance(name, str), "texture.name must be a string")
        name_map[name] = i
        ttype = tv.get("type")
        _require(ttype in TEXTURE_TYPE_NAMES, f"unknown texture type {ttype!r}")
        code = TEXTURE_TYPE_NAMES.index(ttype)

        color_a = np.zeros(3, np.float32)
        color_b = np.zeros(3, np.float32)
        scalar = 0.0
        bitmap_idx = -1
        if ttype == "albedo":
            color_a = _vec3(tv.get("albedo"), "albedo texture albedo")
        elif ttype == "edges":
            _require("edge_width" in tv, "edges texture needs edge_width")
            scalar = float(tv["edge_width"])
            color_a = _vec3(tv.get("edge_color"), "edges edge_color")
            color_b = _vec3(tv.get("inner_color"), "edges inner_color")
        elif ttype == "checker":
            color_a = _vec3(tv.get("color_A"), "checker color_A")
            color_b = _vec3(tv.get("color_B"), "checker color_B")
            _require("square_size" in tv, "checker texture needs square_size")
            scalar = float(tv["square_size"])
        elif ttype == "bitmap":
            fp = tv.get("file_path")
            _require(isinstance(fp, str), "bitmap texture needs file_path")
            # asset_root / relative(file_path), as the reference joins them
            full = os.path.join(asset_root, fp.lstrip("/\\"))
            bitmap_idx = len(bitmaps)
            bitmaps.append(_load_bitmap(full))

        tables["type"].append(code)
        tables["color_a"].append(color_a)
        tables["color_b"].append(color_b)
        tables["scalar"].append(scalar)
        tables["bitmap"].append(bitmap_idx)
    return tables, bitmaps, name_map


def _parse_materials(mat_list: Any, tex_tables, name_map):
    """Parse materials; may append inline albedo textures."""
    _require(isinstance(mat_list, list) and len(mat_list) > 0,
             "materials must be a non-empty array")
    mats = {"type": [], "albedo_tex": [], "ior": [], "smooth": [],
            "backface": []}
    for mv in mat_list:
        _require(isinstance(mv, dict), "material must be an object")
        mtype = mv.get("type")
        _require(mtype in MATERIAL_TYPE_NAMES, f"unknown material type {mtype!r}")
        code = MATERIAL_TYPE_NAMES.index(mtype)
        _require(isinstance(mv.get("smooth_shading"), bool),
                 "material.smooth_shading (bool) is required")
        backface = mv.get("back_face_culling", False)
        _require(isinstance(backface, bool), "back_face_culling must be bool")

        ior = 1.0
        albedo_tex = -1
        if code != MATERIAL_REFRACTIVE:
            albedo = mv.get("albedo")
            _require(albedo is not None, "non-refractive material needs albedo")
            if isinstance(albedo, str):
                _require(albedo in name_map, f"unknown texture name {albedo!r}")
                albedo_tex = name_map[albedo]
            else:
                # Inline color auto-wrapped as a new albedo texture.
                albedo_tex = len(tex_tables["type"])
                tex_tables["type"].append(TEXTURE_ALBEDO)
                tex_tables["color_a"].append(_vec3(albedo, "material.albedo"))
                tex_tables["color_b"].append(np.zeros(3, np.float32))
                tex_tables["scalar"].append(0.0)
                tex_tables["bitmap"].append(-1)
        elif "ior" in mv:
            _require(isinstance(mv["ior"], (int, float)), "ior must be a number")
            ior = float(mv["ior"])

        mats["type"].append(code)
        mats["albedo_tex"].append(albedo_tex)
        mats["ior"].append(ior)
        mats["smooth"].append(bool(mv["smooth_shading"]))
        mats["backface"].append(bool(backface))
    return mats


# 08-era per-object albedos (object 0 the room, object 1 the prop).
ERA08_PALETTE = (
    (0.28345, 0.53446, 0.77744),
    (0.57041, 0.06844, 0.55472),
)


def _parse_objects(obj_list: Any, num_materials: int, legacy: bool,
                   material_per_object: bool = False):
    """Parse meshes and accumulate smooth normals per mesh."""
    _require(isinstance(obj_list, list), "objects must be an array")
    all_v, all_n, all_uv, all_tri, all_mat = [], [], [], [], []
    base = 0
    for oi, ov in enumerate(obj_list):
        _require(isinstance(ov, dict), "object must be an object")
        verts = ov.get("vertices")
        tris = ov.get("triangles")
        _require(isinstance(verts, list) and len(verts) % 3 == 0,
                 "object.vertices must be a flat array of triples")
        _require(isinstance(tris, list) and len(tris) % 3 == 0,
                 "object.triangles must be a flat array of index triples")
        if material_per_object:
            mat_idx = oi
        else:
            mat_idx = ov.get("material_index", 0 if legacy else None)
        _require(isinstance(mat_idx, int), "object.material_index is required")
        _require(0 <= mat_idx < max(num_materials, 1),
                 "material_index out of range")

        pos = np.asarray(verts, np.float32).reshape(-1, 3)
        idx = np.asarray(tris, np.int32).reshape(-1, 3)
        _require(idx.size == 0 or (idx.min() >= 0 and idx.max() < len(pos)),
                 "triangle index out of range")

        uvs = ov.get("uvs")
        if uvs is not None:
            uv = np.asarray(uvs, np.float32).reshape(-1, 3)
            _require(len(uv) == len(pos), "uvs length must match vertices")
        else:
            uv = np.zeros_like(pos)

        all_v.append(pos)
        all_n.append(accumulate_vertex_normals(pos, idx))
        all_uv.append(uv)
        all_tri.append(idx + base)
        all_mat.append(np.full(len(idx), mat_idx, np.int32))
        base += len(pos)

    if not all_v:
        return (np.zeros((0, 3), np.float32),) * 3 + (
            np.zeros((0, 3), np.int32), np.zeros((0,), np.int32))
    return (
        np.concatenate(all_v),
        np.concatenate(all_n),
        np.concatenate(all_uv),
        np.concatenate(all_tri),
        np.concatenate(all_mat),
    )


def scene_from_dict(data: dict, asset_root: str = "/",
                    strict: bool = False, build_accel: bool = True,
                    device=None) -> Scene:
    """Build a render-ready Scene from a .crtscene dict on ``device``
    (None: the card; it raises where there is none, ``"cpu"`` asks for the
    CPU).  Bitmap textures are read from ``asset_root`` joined with their
    ``file_path``; ``build_accel`` builds the KD tree (``Scene.accel``) of
    a scene with triangles."""
    device = resolve_device(device)
    _require(isinstance(data, dict), "scene root must be an object")

    settings = data.get("settings")
    _require(isinstance(settings, dict), "settings object is required")
    bg = _vec3(settings.get("background_color"), "settings.background_color")

    img = settings.get("image_settings")
    _require(isinstance(img, dict), "settings.image_settings is required")
    _require(isinstance(img.get("width"), int)
             and isinstance(img.get("height"), int),
             "image_settings width/height (int) required")
    width, height = img["width"], img["height"]
    bucket_size = img.get("bucket_size", DEFAULT_SCENE_BUCKET_SIZE)
    _require(isinstance(bucket_size, int), "bucket_size must be int")

    cam = data.get("camera")
    _require(isinstance(cam, dict), "camera object is required")
    cam_pos = _vec3(cam.get("position"), "camera.position")
    cam_mat = _mat3(cam.get("matrix"), "camera.matrix")
    fov_degrees = cam.get("fov_degrees", 90.0)
    _require(isinstance(fov_degrees, (int, float)),
             "fov_degrees must be a number")
    tan_half_fov = math.tan(math.radians(float(fov_degrees)) * 0.5)

    tex_tables, bitmaps, name_map = _parse_textures(data.get("textures"),
                                                    asset_root)

    legacy = False
    era08 = False
    if "materials" in data:
        mats = _parse_materials(data["materials"], tex_tables, name_map)
    else:
        _require(not strict, "materials array is required (strict mode)")
        legacy = True
        era08 = bool(data.get("lights"))
        if era08:
            n_obj = len(data.get("objects") or [])
            synth = [
                {
                    "type": "diffuse",
                    "albedo": list(ERA08_PALETTE[i % len(ERA08_PALETTE)]),
                    "smooth_shading": False,
                }
                for i in range(max(n_obj, 1))
            ]
            mats = _parse_materials(synth, tex_tables, name_map)
        else:
            mats = {"type": [0], "albedo_tex": [-1], "ior": [1.0],
                    "smooth": [False], "backface": [False]}

    _require("objects" in data, "objects array is required")
    vertices, normals, uvs, tri_vidx, tri_material = _parse_objects(
        data["objects"], len(mats["type"]), legacy,
        material_per_object=era08,
    )

    if "lights" in data:
        lights = data["lights"]
        _require(isinstance(lights, list), "lights must be an array")
        lpos, lint = [], []
        for lv in lights:
            _require(isinstance(lv, dict), "light must be an object")
            _require(isinstance(lv.get("intensity"), (int, float)),
                     "light.intensity required")
            lpos.append(_vec3(lv.get("position"), "light.position"))
            lint.append(float(lv["intensity"]))
        light_position = np.asarray(lpos, np.float32).reshape(-1, 3)
        light_intensity = np.asarray(lint, np.float32)
    else:
        _require(not strict, "lights array is required (strict mode)")
        light_position = np.zeros((0, 3), np.float32)
        light_intensity = np.zeros((0,), np.float32)

    def _flag(key: str, default: bool) -> bool:
        v = settings.get(key, default)
        _require(isinstance(v, bool), f"settings.{key} must be bool")
        return v

    gi_on = _flag("gi_on", False)
    reflections_on = _flag("reflections_on", True)
    refractions_on = _flag("refractions_on", True)

    # the bitmaps packed into one array padded to the largest
    if bitmaps:
        hmax = max(b.shape[0] for b in bitmaps)
        wmax = max(b.shape[1] for b in bitmaps)
        bitmap_data = np.zeros((len(bitmaps), hmax, wmax, 3), np.float32)
        bitmap_size = np.zeros((len(bitmaps), 2), np.int32)
        for i, b in enumerate(bitmaps):
            bitmap_data[i, :b.shape[0], :b.shape[1]] = b
            bitmap_size[i] = (b.shape[0], b.shape[1])
    else:
        bitmap_data = np.zeros((0, 1, 1, 3), np.float32)
        bitmap_size = np.zeros((0, 2), np.int32)

    mat_type = np.asarray(mats["type"], np.int32)
    present = set(int(t) for t in np.unique(mat_type[np.unique(tri_material)])) \
        if len(tri_material) else set()
    tex_type = np.asarray(tex_tables["type"], np.int32)
    if len(tex_type) == 0:
        # keep at least one dummy texture row so gathers are well-formed
        tex_type = np.zeros(1, np.int32)
        tex_tables["color_a"].append(np.zeros(3, np.float32))
        tex_tables["color_b"].append(np.zeros(3, np.float32))
        tex_tables["scalar"].append(0.0)
        tex_tables["bitmap"].append(-1)

    accel = None
    if build_accel and len(tri_vidx) > 0:
        accel = build_accel_tree(vertices, tri_vidx, device="cpu")

    def t(a, dtype=None):
        return torch.from_numpy(np.array(a, dtype=dtype, order="C"))

    return Scene(
        vertices=t(vertices),
        vertex_normals=t(normals),
        vertex_uvs=t(uvs),
        tri_vidx=t(tri_vidx),
        tri_material=t(tri_material),
        mat_type=t(mat_type),
        mat_albedo_tex=t(mats["albedo_tex"], np.int32),
        mat_ior=t(mats["ior"], np.float32),
        mat_smooth=t(mats["smooth"], bool),
        mat_backface=t(mats["backface"], bool),
        tex_type=t(tex_type),
        tex_color_a=t(np.stack(tex_tables["color_a"]), np.float32),
        tex_color_b=t(np.stack(tex_tables["color_b"]), np.float32),
        tex_scalar=t(tex_tables["scalar"], np.float32),
        tex_bitmap=t(tex_tables["bitmap"], np.int32),
        bitmap_data=t(bitmap_data),
        bitmap_size=t(bitmap_size),
        light_position=t(light_position),
        light_intensity=t(light_intensity),
        cam_position=t(cam_pos),
        cam_rotation=t(cam_mat),
        cam_tan_half_fov=torch.tensor(tan_half_fov, dtype=torch.float32),
        background_color=t(bg),
        accel=accel,
        width=width,
        height=height,
        bucket_size=bucket_size,
        gi_on=gi_on,
        reflections_on=reflections_on,
        refractions_on=refractions_on,
        has_reflective=1 in present,
        has_refractive=2 in present,
        has_constant=3 in present,
        has_materials=not legacy or era08,
        has_lights=len(light_intensity) > 0,
        any_smooth=bool(any(mats["smooth"])),
        texture_types_present=tuple(sorted(set(int(x) for x in tex_type))),
    ).to(device)

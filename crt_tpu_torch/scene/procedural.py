"""Procedural test scenes (no file dependencies).

Counterpart of ``crt_tpu/scene/procedural.py``: the same seeds give the
same geometry, bit for bit.  ``make_test_scene(1920, 1080, num_quads=64)``
is the forward benchmark scene.
"""

from __future__ import annotations

import numpy as np
import torch

from crt_tpu_torch.scene.accel import build_accel_tree
from crt_tpu_torch.scene.json_loader import scene_from_dict
from crt_tpu_torch.scene.types import Scene, resolve_device


def make_test_scene_dict(
    width: int = 64,
    height: int = 36,
    num_quads: int = 8,
    seed: int = 0,
    with_reflective: bool = True,
    with_refractive: bool = False,
    with_edges: bool = False,
    gi_on: bool = False,
    floor_bitmap: str | None = None,
) -> dict:
    """The .crtscene dict behind ``make_test_scene``: a floor, random
    triangles, two point lights and up to four materials.
    ``floor_bitmap`` (a ``file_path``, read from the loader's
    ``asset_root``) textures the floor with that bitmap, tiled 4 x 4 by
    its uvs."""
    rng = np.random.default_rng(seed)

    objects = [
        {  # floor
            "material_index": 0,
            "vertices": [-20, -2, 20, 20, -2, 20, -20, -2, -20,
                         20, -2, -20],
            "triangles": [0, 1, 2, 3, 2, 1],
        }
    ]
    floor_albedo = "floor_edges" if with_edges else [0.7, 0.7, 0.7]
    textures = []
    if with_edges:
        textures.append({"name": "floor_edges", "type": "edges",
                         "edge_color": [0.2, 0.8, 0.3],
                         "inner_color": [0.7, 0.7, 0.7], "edge_width": 0.3})
    if floor_bitmap is not None:
        floor_albedo = "floor_bitmap"
        textures.append({"name": "floor_bitmap", "type": "bitmap",
                         "file_path": floor_bitmap})
        objects[0]["uvs"] = [0, 0, 0, 4, 0, 0, 0, 4, 0, 4, 4, 0]
    mats = [
        {"type": "diffuse", "albedo": floor_albedo, "smooth_shading": False},
        {"type": "diffuse", "albedo": [0.9, 0.2, 0.2], "smooth_shading": True},
    ]
    if with_reflective:
        mats.append({"type": "reflective", "albedo": [0.8, 0.8, 0.9],
                     "smooth_shading": False})
    if with_refractive:
        mats.append({"type": "refractive", "ior": 1.5, "smooth_shading": True})

    for _ in range(num_quads):
        c = rng.uniform(-6, 6, 3)
        c[1] = rng.uniform(-1.5, 3.0)
        c[2] = -abs(c[2]) - 3.0
        s = rng.uniform(0.4, 1.2)
        v = np.array(
            [c + [-s, -s, 0], c + [s, -s, 0], c + [0, s, 0]], np.float32
        )
        objects.append(
            {
                "material_index": int(rng.integers(1, len(mats))),
                "vertices": v.reshape(-1).tolist(),
                "triangles": [0, 1, 2],
            }
        )

    data = {
        "settings": {
            "background_color": [0.1, 0.2, 0.3],
            "image_settings": {"width": width, "height": height},
            "gi_on": gi_on,
        },
        "camera": {
            "matrix": [1, 0, 0, 0, 1, 0, 0, 0, 1],
            "position": [0, 0, 6],
        },
        "lights": [
            {"intensity": 800, "position": [3, 6, 2]},
            {"intensity": 300, "position": [-4, 5, -1]},
        ],
        "materials": mats,
        "objects": objects,
    }
    if textures:
        data["textures"] = textures
    return data


def make_test_scene(*args, device=None, **kwargs) -> Scene:
    """A small random quad-soup scene (see make_test_scene_dict), built
    through the same loader as real .crtscene files, on ``device`` (None:
    the card)."""
    return scene_from_dict(make_test_scene_dict(*args, **kwargs),
                           device=device)


def make_big_scene(
    num_triangles: int = 1_000_000,
    width: int = 1920,
    height: int = 1080,
    seed: int = 0,
    build_accel: bool = True,
    device=None,
) -> Scene:
    """A large random triangle soup in a slab in front of the camera, built
    directly as arrays (one diffuse material, one light), on ``device``
    (None: the card).  ``build_accel`` builds its KD tree (the native
    builder where it builds)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    T = num_triangles
    centers = np.empty((T, 3), np.float32)
    centers[:, 0] = rng.uniform(-30, 30, T)
    centers[:, 1] = rng.uniform(-18, 18, T)
    centers[:, 2] = rng.uniform(-60, -5, T)
    size = rng.uniform(0.02, 0.12, (T, 1)).astype(np.float32)
    offs = rng.standard_normal((T, 3, 3)).astype(np.float32)
    verts = (centers[:, None, :] + offs * size[:, None, :]).reshape(-1, 3)
    tri_vidx = np.arange(3 * T, dtype=np.int32).reshape(T, 3)

    f32 = torch.float32
    i32 = torch.int32
    return Scene(
        vertices=torch.from_numpy(verts),
        vertex_normals=torch.zeros(verts.shape, dtype=f32),
        vertex_uvs=torch.zeros(verts.shape, dtype=f32),
        tri_vidx=torch.from_numpy(tri_vidx),
        tri_material=torch.zeros((T,), dtype=i32),
        mat_type=torch.zeros((1,), dtype=i32),  # diffuse
        mat_albedo_tex=torch.zeros((1,), dtype=i32),
        mat_ior=torch.ones((1,), dtype=f32),
        mat_smooth=torch.zeros((1,), dtype=torch.bool),
        mat_backface=torch.zeros((1,), dtype=torch.bool),
        tex_type=torch.zeros((1,), dtype=i32),
        tex_color_a=torch.tensor([[0.7, 0.6, 0.5]], dtype=f32),
        tex_color_b=torch.zeros((1, 3), dtype=f32),
        tex_scalar=torch.zeros((1,), dtype=f32),
        tex_bitmap=torch.full((1,), -1, dtype=i32),
        bitmap_data=torch.zeros((0, 1, 1, 3), dtype=f32),
        bitmap_size=torch.zeros((0, 2), dtype=i32),
        light_position=torch.tensor([[0.0, 30.0, 0.0]], dtype=f32),
        light_intensity=torch.tensor([20000.0], dtype=f32),
        cam_position=torch.zeros((3,), dtype=f32),
        cam_rotation=torch.eye(3, dtype=f32),
        cam_tan_half_fov=torch.tensor(1.0, dtype=f32),
        background_color=torch.tensor([0.05, 0.08, 0.12], dtype=f32),
        accel=(build_accel_tree(verts, tri_vidx, device="cpu")
               if build_accel else None),
        width=width,
        height=height,
        has_reflective=False,
        has_refractive=False,
        has_constant=False,
        any_smooth=False,
        texture_types_present=(0,),
    ).to(device)

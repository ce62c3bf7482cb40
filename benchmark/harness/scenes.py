"""The scenes of the configurations, made by the benchmark from their
parameters, and handed alike to the program and to the reference.

``quads``: a floor, random single-triangle quads, two point lights and up
to three materials (the port's ``make_test_scene_dict`` as of the
benchmark's first version, frozen here), as a .crtscene dict.
``soup``: a random triangle soup in a slab before the camera, one diffuse
material and one light (the port's ``make_big_scene``, frozen), as arrays.
"""

from __future__ import annotations

import numpy as np


def quads_description(p: dict, gi_on: bool = False) -> dict:
    """The .crtscene dict of a ``quads`` configuration."""
    rng = np.random.default_rng(p["layout_seed"])
    objects = [{"material_index": 0,
                "vertices": [-20, -2, 20, 20, -2, 20, -20, -2, -20,
                             20, -2, -20],
                "triangles": [0, 1, 2, 3, 2, 1]}]
    mats = [
        {"type": "diffuse", "albedo": [0.7, 0.7, 0.7], "smooth_shading": False},
        {"type": "diffuse", "albedo": [0.9, 0.2, 0.2], "smooth_shading": True},
    ]
    if p.get("with_reflective", True):
        mats.append({"type": "reflective", "albedo": [0.8, 0.8, 0.9],
                     "smooth_shading": False})
    for _ in range(p["num_quads"]):
        c = rng.uniform(-6, 6, 3)
        c[1] = rng.uniform(-1.5, 3.0)
        c[2] = -abs(c[2]) - 3.0
        s = rng.uniform(0.4, 1.2)
        v = np.array([c + [-s, -s, 0], c + [s, -s, 0], c + [0, s, 0]],
                     np.float32)
        objects.append({"material_index": int(rng.integers(1, len(mats))),
                        "vertices": v.reshape(-1).tolist(),
                        "triangles": [0, 1, 2]})
    return {
        "settings": {"background_color": [0.1, 0.2, 0.3],
                     "image_settings": {"width": p["width"],
                                        "height": p["height"]},
                     "gi_on": gi_on},
        "camera": {"matrix": [1, 0, 0, 0, 1, 0, 0, 0, 1],
                   "position": [0, 0, 6]},
        "lights": [{"intensity": 800, "position": [3, 6, 2]},
                   {"intensity": 300, "position": [-4, 5, -1]}],
        "materials": mats,
        "objects": objects,
    }


def soup_arrays(p: dict) -> dict:
    """The arrays of a ``soup`` configuration."""
    rng = np.random.default_rng(p["layout_seed"])
    T = int(p["num_triangles"])
    centers = np.empty((T, 3), np.float32)
    centers[:, 0] = rng.uniform(-30, 30, T)
    centers[:, 1] = rng.uniform(-18, 18, T)
    centers[:, 2] = rng.uniform(-60, -5, T)
    size = rng.uniform(0.02, 0.12, (T, 1)).astype(np.float32)
    offs = rng.standard_normal((T, 3, 3)).astype(np.float32)
    verts = (centers[:, None, :] + offs * size[:, None, :]).reshape(-1, 3)
    return {"vertices": verts, "albedo": [0.7, 0.6, 0.5],
            "light_position": [0.0, 30.0, 0.0], "light_intensity": 20000.0,
            "background": [0.05, 0.08, 0.12],
            "width": p["width"], "height": p["height"]}


def description(config: dict, gi_on: bool = False):
    """(kind, the scene's description) of a configuration."""
    kind = config["scene"]["kind"]
    if kind == "quads":
        return kind, quads_description(config["scene"], gi_on)
    if kind == "soup":
        if gi_on:
            raise ValueError("the soup scene has no GI setting")
        return kind, soup_arrays(config["scene"])
    raise ValueError(f"unknown scene kind {kind!r}")


def program_scene(kind: str, desc, device):
    """The program's Scene of a description, on ``device``."""
    import torch

    if kind == "quads":
        from crt_tpu_torch.scene.json_loader import scene_from_dict

        return scene_from_dict(desc, build_accel=False, device=device)
    from crt_tpu_torch.scene.types import Scene

    verts = torch.from_numpy(desc["vertices"])
    T = verts.shape[0] // 3
    f32, i32 = torch.float32, torch.int32
    return Scene(
        vertices=verts, vertex_normals=torch.zeros_like(verts),
        vertex_uvs=torch.zeros_like(verts),
        tri_vidx=torch.arange(3 * T, dtype=i32).reshape(T, 3),
        tri_material=torch.zeros((T,), dtype=i32),
        mat_type=torch.zeros((1,), dtype=i32),
        mat_albedo_tex=torch.zeros((1,), dtype=i32),
        mat_ior=torch.ones((1,), dtype=f32),
        mat_smooth=torch.zeros((1,), dtype=torch.bool),
        mat_backface=torch.zeros((1,), dtype=torch.bool),
        tex_type=torch.zeros((1,), dtype=i32),
        tex_color_a=torch.tensor([desc["albedo"]], dtype=f32),
        tex_color_b=torch.zeros((1, 3), dtype=f32),
        tex_scalar=torch.zeros((1,), dtype=f32),
        tex_bitmap=torch.full((1,), -1, dtype=i32),
        bitmap_data=torch.zeros((0, 1, 1, 3), dtype=f32),
        bitmap_size=torch.zeros((0, 2), dtype=i32),
        light_position=torch.tensor([desc["light_position"]], dtype=f32),
        light_intensity=torch.tensor([desc["light_intensity"]], dtype=f32),
        cam_position=torch.zeros((3,), dtype=f32),
        cam_rotation=torch.eye(3, dtype=f32),
        cam_tan_half_fov=torch.tensor(1.0, dtype=f32),
        background_color=torch.tensor(desc["background"], dtype=f32),
        accel=None, width=desc["width"], height=desc["height"],
        has_reflective=False, has_refractive=False, has_constant=False,
        any_smooth=False, texture_types_present=(0,),
    ).to(device)


def reference_scene(kind: str, desc):
    """The reference's RefScene of a description."""
    from reference.render import scene_from_description, scene_from_soup

    return scene_from_description(desc) if kind == "quads" \
        else scene_from_soup(desc)

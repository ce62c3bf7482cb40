"""The scenes of the configurations, made by the benchmark from their
parameters, and handed alike to the program and to the reference.

A configuration's ``scene.kind`` names its kind.  Two are built in:

``quads``: a floor, random single-triangle quads, two point lights and up
to three materials (the port's ``make_test_scene_dict`` as of the
benchmark's first version, frozen here), as a .crtscene dict.
``soup``: a random triangle soup in a slab before the camera, one diffuse
material and one light (the port's ``make_big_scene``, frozen), as arrays.

Any other kind is the module ``benchmark/scenes/<kind>.py``, loaded by its
path.  It gives ``description(params, gi_on)`` (``params``: the
configuration's ``scene``), ``program_scene(desc, device)`` and
``reference_scene(desc)``, and may give ``Renderer``, a subclass of
``reference.render.Renderer`` for materials the base reference raises on;
the frame and fit checks of its cells build that one.
"""

from __future__ import annotations

import dataclasses
import functools
import pathlib
from typing import Callable

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


def soup_description(p: dict, gi_on: bool = False) -> dict:
    """The arrays of a ``soup`` configuration, which has no GI."""
    if gi_on:
        raise ValueError("the soup scene has no GI setting")
    return soup_arrays(p)


def program_scene(kind: str, desc, device):
    """The program's Scene of a built-in kind's description, on ``device``."""
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
    """The reference's RefScene of a built-in kind's description."""
    from reference.render import scene_from_description, scene_from_soup

    return scene_from_description(desc) if kind == "quads" \
        else scene_from_soup(desc)


@dataclasses.dataclass(frozen=True)
class Kind:
    """What the harness takes from a scene kind."""

    description: Callable  # (params, gi_on) -> the scene's description
    program_scene: Callable  # (desc, device) -> the program's Scene
    reference_scene: Callable  # (desc) -> the reference's RefScene
    Renderer: type  # the reference renderer of the kind's checks


_BUILTIN = {"quads": quads_description, "soup": soup_description}


def with_tree(scene, device):
    """``scene`` with the KD tree that the ``tree`` backend walks, built
    from its triangles as the program's loader builds it."""
    from crt_tpu_torch.scene.accel import build_accel_tree

    tree = build_accel_tree(scene.vertices.cpu().numpy(),
                            scene.tri_vidx.cpu().numpy(), device="cpu")
    return scene.replace(accel=tree.to(device))


def find(config: dict, bench_dir: pathlib.Path) -> Kind:
    """The kind of a configuration's scene: built in, or the module
    ``<bench_dir>/scenes/<kind>.py``.  Its program scene carries the KD
    tree exactly where the configuration's ``settings`` ask for the
    ``tree`` backend, which walks it."""
    from reference.render import Renderer

    name = config["scene"]["kind"]
    if name in _BUILTIN:
        kind = Kind(_BUILTIN[name], functools.partial(program_scene, name),
                    functools.partial(reference_scene, name), Renderer)
    else:
        path = bench_dir / "scenes" / f"{name}.py"
        if not path.is_file():
            raise ValueError(f"unknown scene kind {name!r}")
        from harness.registry import load_module

        mod = load_module(path, "bench_scene")
        kind = Kind(mod.description, mod.program_scene, mod.reference_scene,
                    getattr(mod, "Renderer", Renderer))
    if config.get("settings", {}).get("backend") != "tree":
        return kind
    make = kind.program_scene
    return dataclasses.replace(
        kind, program_scene=lambda desc, device: with_tree(
            make(desc, device), device))

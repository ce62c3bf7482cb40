"""crt_tpu_torch's Blender add-on under the mock bpy (tests/mock_bpy.py).

The port's add-on is registered alone (it keeps crt_tpu's operator and
property names, so the two are never enabled together) and driven as
tests/test_blender_addon.py drives crt_tpu's: registration, the panels,
the scene export from a depsgraph (equal to crt_tpu's exporter's dict),
the camera-matrix round trip, the operators, and the engine's Combined
pass, rendered on the CPU (``engine.DEVICE`` patched) and held to crt_tpu's
engine on the same mock scene at rtol 1e-5 / atol 1e-6, the tolerance of
tests/test_torch_render.py for a jitted crt_tpu image.
"""

import importlib
import json
import math
import sys
import types

import numpy as np
import pytest

from torch_port_fixtures import _one_torch_thread, _release_heap  # noqa: F401

sys.path.insert(0, __file__.rsplit("/", 1)[0])
import mock_bpy  # noqa: E402

_B2R = np.array([[1.0, 0, 0], [0, 0, 1.0], [0, -1.0, 0]])

_PORT_MODULES = tuple(
    f"crt_tpu_torch.frontend.blender.{m}"
    for m in ("scene_bridge", "properties", "engine", "ui", "ops"))


def _reload_port():
    for name in _PORT_MODULES:
        mod = sys.modules.get(name)
        if mod is not None:
            importlib.reload(mod)
        else:
            importlib.import_module(name)


@pytest.fixture(scope="module")
def bpy():
    b = mock_bpy.install()
    _reload_port()
    from crt_tpu_torch.frontend import blender as addon

    addon.register()
    yield b
    addon.unregister()
    mock_bpy.uninstall()
    _reload_port()


def _rotx(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], float)


def _matrix(rot3=np.eye(3), loc=(0.0, 0.0, 0.0)):
    from mathutils import Matrix

    mw = np.eye(4)
    mw[:3, :3] = rot3
    mw[:3, 3] = loc
    return Matrix(mw.tolist())


def _camera(bpy, rot3, loc, fov_deg=90.0):
    cam_data = bpy.data.cameras.new("Camera")
    cam_data.angle = math.radians(fov_deg)
    ob = bpy.data.objects.new("Camera", cam_data)
    ob.matrix_world = _matrix(rot3, loc)
    return ob


def _depsgraph(bpy, objects, camera, width=24, height=16):
    scene = bpy.types.Scene()
    scene.camera = camera
    scene.render = types.SimpleNamespace(
        resolution_x=width, resolution_y=height, resolution_percentage=100)
    scene.world = types.SimpleNamespace(color=(0.1, 0.2, 0.3))
    instances = [types.SimpleNamespace(object=ob, matrix_world=ob.matrix_world)
                 for ob in list(objects) + [camera]]
    return types.SimpleNamespace(scene=scene, object_instances=instances)


def _mesh_object(bpy, name, verts, faces, material, loc=(0.0, 0.0, 0.0)):
    mesh = bpy.data.meshes.new(name)
    mesh.from_pydata(verts, [], faces)
    mesh.materials.new(material)
    ob = bpy.data.objects.new(name, mesh)
    ob.matrix_world = _matrix(loc=loc)
    return ob


def _test_depsgraph(bpy):
    """A floor, a cube and a mirror triangle under two point lights, seen
    by a camera looking along Blender's +Y."""
    floor_mat = bpy.data.materials.new("floor_mat")
    floor_mat.crt.type = "DIFFUSE"
    floor_mat.crt.albedo = [0.8, 0.7, 0.6]
    cube_mat = bpy.data.materials.new("cube_mat")
    cube_mat.crt.type = "DIFFUSE"
    cube_mat.crt.albedo = [1.0, 0.5, 0.25]
    mirror = bpy.data.materials.new("mirror_mat")
    mirror.crt.type = "REFLECTIVE"
    mirror.crt.albedo = [0.9, 0.9, 0.9]
    objs = [
        _mesh_object(bpy, "floor", [(-4, 0, -1), (4, 0, -1), (4, 8, -1),
                                    (-4, 8, -1)], [(0, 1, 2, 3)], floor_mat),
        _mesh_object(bpy, "cube", [
            (-0.5, -0.5, -0.5), (0.5, -0.5, -0.5), (0.5, 0.5, -0.5),
            (-0.5, 0.5, -0.5), (-0.5, -0.5, 0.5), (0.5, -0.5, 0.5),
            (0.5, 0.5, 0.5), (-0.5, 0.5, 0.5)],
            [(0, 1, 2, 3), (4, 7, 6, 5), (0, 4, 5, 1), (1, 5, 6, 2),
             (2, 6, 7, 3), (3, 7, 4, 0)], cube_mat, loc=(0.6, 3.5, -0.4)),
        _mesh_object(bpy, "mirror", [(-2.5, 5, -1), (-0.5, 6, -1),
                                     (-1.5, 5.5, 1.5)], [(0, 1, 2)], mirror),
    ]
    for name, loc, power in (("key", (0.0, 1.0, 2.0), 2000.0),
                             ("fill", (-2.0, 2.0, 1.0), 500.0)):
        data = bpy.data.lights.new(name, "POINT")
        data.crt.intensity = power
        light = bpy.data.objects.new(name, data)
        light.matrix_world = _matrix(loc=loc)
        objs.append(light)
    cam = _camera(bpy, _rotx(math.pi / 2), (0.0, 0.0, 0.0), fov_deg=70.0)
    return _depsgraph(bpy, objs, cam)


def test_register_unregister(bpy):
    from crt_tpu.frontend.blender.engine import CRTTpuRenderEngine
    from crt_tpu_torch.frontend import blender as addon
    from crt_tpu_torch.frontend.blender.engine import CRTTorchRenderEngine

    assert CRTTorchRenderEngine in bpy.utils.registered_classes
    assert CRTTorchRenderEngine.bl_idname == "CRT_TORCH"
    assert CRTTorchRenderEngine.bl_idname != CRTTpuRenderEngine.bl_idname
    assert callable(bpy.ops.crt.export_scene)
    scene = bpy.types.Scene()
    assert scene.crt.max_ray_depth == 3
    assert scene.crt.diffuse_reflection_ray_count == 4
    assert scene.crt.shadow_bias == pytest.approx(1e-2)
    assert scene.crt.reflections_on is True
    mat = bpy.data.materials.new("m")
    assert mat.crt.type == "DIFFUSE"
    assert list(mat.crt.albedo) == pytest.approx([0.8, 0.8, 0.8])
    assert bpy.data.lights.new("l", "POINT").crt.intensity == 1000.0

    addon.unregister()
    assert CRTTorchRenderEngine not in bpy.utils.registered_classes
    assert not hasattr(bpy.ops.crt, "export_scene")
    assert not hasattr(bpy.types.Scene, "crt")
    addon.register()
    assert CRTTorchRenderEngine in bpy.utils.registered_classes
    assert hasattr(bpy.ops.crt, "debug_ray_add")


def test_panels_draw_for_the_torch_engine(bpy):
    from crt_tpu_torch.frontend.blender import ui

    calls = []
    col = types.SimpleNamespace(prop=lambda *a, **k: calls.append(a),
                                separator=lambda: None)
    layout = types.SimpleNamespace(column=lambda: col,
                                   prop=lambda *a, **k: calls.append(a))
    scene = bpy.types.Scene()
    mat = bpy.data.materials.new("pm")
    light = bpy.data.lights.new("pl", "POINT")
    ctx = types.SimpleNamespace(engine="CRT_TORCH", scene=scene,
                                material=mat, light=light, texture=None)
    for panel_cls in (ui.CRT_PT_render_settings, ui.CRT_PT_material,
                      ui.CRT_PT_light):
        assert "CRT_TPU" not in panel_cls.COMPAT_ENGINES
        p = panel_cls()
        p.layout = layout
        assert panel_cls.poll(ctx)
        assert not panel_cls.poll(
            types.SimpleNamespace(**{**vars(ctx), "engine": "CRT_TPU"}))
        p.draw(ctx)
    assert len(calls) >= 12


def test_build_scene_dict_equals_crt_tpu(bpy):
    from crt_tpu.frontend.blender import scene_bridge as jbridge
    from crt_tpu_torch.frontend.blender import scene_bridge

    dg = _test_depsgraph(bpy)
    tex = bpy.data.textures.new("checks", "NONE")
    tex.crt.enabled = True
    tex.crt.type = "CHECKER"
    d = scene_bridge.build_scene_dict(dg)
    assert d == jbridge.build_scene_dict(dg)
    assert len(d["objects"]) == 3 and len(d["lights"]) == 2
    assert d["textures"][-1]["type"] == "checker"
    tex.crt.enabled = False


def test_camera_matrix_round_trip(bpy):
    from crt_tpu_torch.frontend.blender import scene_bridge

    rot = _rotx(0.7)
    loc = (1.0, 2.0, 3.0)
    cam = _camera(bpy, rot, loc, fov_deg=72.0)
    dg = _depsgraph(bpy, [], cam)
    d = scene_bridge.build_camera(dg.scene, dg)
    assert d["fov_degrees"] == pytest.approx(72.0)
    np.testing.assert_allclose(np.array(d["matrix"]),
                               (_B2R @ rot).T.flatten(), atol=1e-12)
    np.testing.assert_allclose(np.array(d["position"]),
                               _B2R @ np.array(loc), atol=1e-12)
    scene_bridge.import_scene_dict({"camera": d},
                                   collection=bpy.context.collection)
    imported = bpy.context.scene.camera
    np.testing.assert_allclose(imported.matrix_world.to_3x3().a, rot,
                               atol=1e-12)
    np.testing.assert_allclose(np.array(list(imported.location)),
                               np.array(loc), atol=1e-12)
    assert imported.data.angle == pytest.approx(math.radians(72.0))


def test_engine_combined_pass_matches_crt_tpu(bpy, monkeypatch):
    from crt_tpu.frontend.blender.engine import CRTTpuRenderEngine
    from crt_tpu_torch.frontend.blender import engine

    dg = _test_depsgraph(bpy)
    monkeypatch.setattr(engine, "DEVICE", "cpu")
    ours = engine.CRTTorchRenderEngine()
    ours.render(dg)
    ref = CRTTpuRenderEngine()
    ref.render(dg)
    got = np.asarray(ours.result.layers[0].passes["Combined"].rect,
                     np.float32)
    want = np.asarray(ref.result.layers[0].passes["Combined"].rect,
                      np.float32)
    assert got.shape == want.shape == (24 * 16, 4)
    assert np.all(got[:, 3] == 1.0)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    hit = np.abs(got[:, :3] - bg).max(axis=1) > 1e-6
    assert 0 < hit.sum() < hit.size  # geometry and background both seen
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_export_import_operators_round_trip(bpy, tmp_path):
    from crt_tpu.frontend.blender import scene_bridge as jbridge

    dg = _test_depsgraph(bpy)
    bpy.context.evaluated_depsgraph_get = lambda: dg
    path = tmp_path / "scene.crtscene"
    assert bpy.ops.crt.export_scene(filepath=str(path)) == {"FINISHED"}
    data = json.loads(path.read_text())
    assert data == json.loads(json.dumps(jbridge.build_scene_dict(dg)))

    n_objects = len(bpy.data.objects)
    assert bpy.ops.crt.import_scene(filepath=str(path)) == {"FINISHED"}
    # 3 meshes, 2 lights and the camera come back
    assert len(bpy.data.objects) == n_objects + 6
    cam = bpy.context.scene.camera
    np.testing.assert_allclose(cam.matrix_world.to_3x3().a, _rotx(math.pi / 2),
                               atol=1e-12)


def test_debug_ray_add_operator(bpy):
    n = len(bpy.context.collection.objects._items)
    result = bpy.ops.crt.debug_ray_add(
        origin=(0.0, 1.0, 2.0), direction=(0.0, 0.0, -1.0), length=2.5,
        depth=1, raster_coords=(827, 410))
    assert result == {"FINISHED"}
    items = bpy.context.collection.objects._items
    assert len(items) == n + 1
    assert items[-1].name == "crt_ray_827_410_d1"
    # renderer (0, 1, 2) -> blender (0, -2, 1)
    assert list(items[-1].location) == [0.0, -2.0, 1.0]

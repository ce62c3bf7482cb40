"""crt_tpu_torch scene model, loader, converter and raygen vs crt_tpu.

Tolerances: everything here is compared EXACTLY (array_equal).  The loader
is the same NumPy code on the same JSON; raygen is the same fp32 op
sequence, with the port's square root correctly rounded like XLA's, and
the JAX side runs eagerly (one XLA op per call, so no multiply-add is
contracted into an FMA).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crt_tpu import renderer as jrenderer
from crt_tpu.ops import camera as jcamera
from crt_tpu.scene.json_loader import SceneFormatError as JSceneFormatError
from crt_tpu.scene.json_loader import scene_from_dict as jscene_from_dict
from crt_tpu.scene.procedural import make_test_scene as jmake_test_scene
from crt_tpu.scene.types import RenderSettings as JRenderSettings
from crt_tpu_torch import RenderSettings, scene_from_dict, scene_from_json
from crt_tpu_torch import renderer as trenderer
from crt_tpu_torch.ops import camera as tcamera
from crt_tpu_torch.scene.convert import scene_from_numpy, scene_to_numpy
from crt_tpu_torch.scene.json_loader import SceneFormatError
from crt_tpu_torch.scene.procedural import make_test_scene, make_test_scene_dict
from crt_tpu_torch.scene.types import SCENE_META_FIELDS, SCENE_TENSOR_FIELDS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs one worker per core, and torch's
    default (a thread per core in every worker) oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CHECKER_SCENE = {
    "settings": {
        "background_color": [0.0, 0.5, 0.0],
        "image_settings": {"width": 40, "height": 30, "bucket_size": 8},
        "reflections_on": False,
    },
    "camera": {"matrix": [0, 0, 1, 0, 1, 0, -1, 0, 0],
               "position": [1, 2, 3], "fov_degrees": 60},
    "lights": [{"intensity": 50, "position": [0, 5, 0]}],
    "textures": [
        {"name": "chk", "type": "checker", "color_A": [1, 0, 0],
         "color_B": [0, 0, 1], "square_size": 0.25},
    ],
    "materials": [
        {"type": "diffuse", "albedo": "chk", "smooth_shading": True,
         "back_face_culling": True},
        {"type": "constant", "albedo": [0.3, 0.4, 0.5],
         "smooth_shading": False},
    ],
    "objects": [
        {"material_index": 0, "vertices": [0, 0, -4, 1, 0, -4, 0, 1, -4,
                                           1, 1, -4],
         "triangles": [0, 1, 2, 2, 1, 3],
         "uvs": [0, 0, 0, 1, 0, 0, 0, 1, 0, 1, 1, 0]},
        {"material_index": 1, "vertices": [-1, -1, -5, 0, -1, -5, -1, 0, -5],
         "triangles": [0, 1, 2]},
    ],
}

SCENES = {
    "default": lambda: make_test_scene_dict(),
    "with_edges": lambda: make_test_scene_dict(with_edges=True),
    "checker": lambda: json.loads(json.dumps(CHECKER_SCENE)),
}


def assert_scene_matches(jscene, tscene):
    for f in SCENE_TENSOR_FIELDS:
        a = np.asarray(getattr(jscene, f))
        b = getattr(tscene, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    for f in SCENE_META_FIELDS:
        assert getattr(tscene, f) == getattr(jscene, f), f


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_from_dict_matches_crt_tpu(name):
    data = SCENES[name]()
    assert_scene_matches(jscene_from_dict(data, build_accel=False),
                         scene_from_dict(data, device="cpu"))


def test_make_test_scene_matches_crt_tpu():
    assert_scene_matches(jmake_test_scene(96, 64, num_quads=16, seed=3),
                         make_test_scene(96, 64, num_quads=16, seed=3,
                                         device="cpu"))


def test_scene_from_numpy_round_trip():
    jscene = jmake_test_scene(with_edges=True)
    arrays = {f: np.asarray(getattr(jscene, f)) for f in SCENE_TENSOR_FIELDS}
    meta = {f: getattr(jscene, f) for f in SCENE_META_FIELDS}
    tscene = scene_from_numpy(arrays, meta, device="cpu")
    assert_scene_matches(jscene, tscene)
    arrays2, meta2 = scene_to_numpy(tscene)
    for f in SCENE_TENSOR_FIELDS:
        np.testing.assert_array_equal(arrays2[f], arrays[f])
    assert meta2 == meta
    with pytest.raises(KeyError):
        scene_from_numpy({"vertices": arrays["vertices"]}, meta, device="cpu")


def test_scene_to_and_replace():
    s = make_test_scene(device="cpu")
    moved = s.to("cpu").replace(width=7)
    assert moved.width == 7 and moved.device == torch.device("cpu")
    assert moved.num_triangles == s.num_triangles == 10
    assert s.num_lights == 2


def test_render_settings_parity():
    jfields = JRenderSettings.__dataclass_fields__
    tfields = RenderSettings.__dataclass_fields__
    assert list(tfields) == list(jfields)
    for f in jfields:
        assert tfields[f].default == jfields[f].default, f
    for kw in ({}, {"head_compat": True}, {"compat_no_shadows": True},
               {"compat_gi_divide": True}, {"compat_hadamard_y": True}):
        j, t = JRenderSettings(**kw), RenderSettings(**kw)
        assert (t.no_shadows, t.gi_divide, t.hadamard_y) == \
            (j.no_shadows, j.gi_divide, j.hadamard_y)


@pytest.mark.parametrize("bad", [
    {},
    {"settings": {"background_color": [0, 0, 0]}},
    dict(make_test_scene_dict(), materials=[]),
    dict(make_test_scene_dict(), camera={"matrix": [1, 0, 0],
                                         "position": [0, 0, 0]}),
])
def test_malformed_scenes_raise_like_crt_tpu(bad):
    with pytest.raises(JSceneFormatError):
        jscene_from_dict(bad, build_accel=False)
    with pytest.raises(SceneFormatError):
        scene_from_dict(bad, device="cpu")


def test_scene_from_json_and_bitmap_not_implemented():
    text = json.dumps(make_test_scene_dict())
    assert scene_from_json(text, device="cpu").num_triangles == 10
    data = make_test_scene_dict()
    data["textures"] = [{"name": "img", "type": "bitmap",
                         "file_path": "tex.png"}]
    data["materials"][0]["albedo"] = "img"
    with pytest.raises(NotImplementedError, match="A9"):
        scene_from_dict(data, device="cpu")


@pytest.mark.parametrize("hw", [(36, 64), (64, 96), (40, 30)])
def test_make_tiler_bit_equal(hw):
    h, w = hw
    jx, jy, juntile = jrenderer.make_tiler(h, w)
    tx, ty, tuntile = trenderer.make_tiler(h, w)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    colors = np.random.default_rng(0).random((tx.shape[0], 3), np.float32)
    np.testing.assert_array_equal(
        tuntile(torch.from_numpy(colors)).numpy(),
        np.asarray(juntile(jnp.asarray(colors))),
    )


@pytest.mark.parametrize("name", sorted(SCENES))
def test_generate_rays_bit_equal(name):
    data = SCENES[name]()
    js = jscene_from_dict(data, build_accel=False)
    ts = scene_from_dict(data, device="cpu")
    jx, jy, _ = jrenderer.make_tiler(js.height, js.width)
    tx, ty, _ = trenderer.make_tiler(ts.height, ts.width)
    jo, jd = jcamera.generate_rays(js.cam_position, js.cam_rotation,
                                   js.cam_tan_half_fov, js.width, js.height,
                                   jx, jy)
    to, td = tcamera.generate_rays(ts.cam_position, ts.cam_rotation,
                                   ts.cam_tan_half_fov, ts.width, ts.height,
                                   tx, ty)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    # the full-grid form (no raster coords) too
    jo2, jd2 = jcamera.generate_rays(js.cam_position, js.cam_rotation,
                                     js.cam_tan_half_fov, js.width, js.height)
    to2, td2 = tcamera.generate_rays(ts.cam_position, ts.cam_rotation,
                                     ts.cam_tan_half_fov, ts.width, ts.height)
    np.testing.assert_array_equal(td2.numpy(), np.asarray(jd2))
    np.testing.assert_array_equal(to2.numpy(), np.asarray(jo2))

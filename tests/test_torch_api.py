"""The ``_crt`` API of crt_tpu_torch (``frontend/api.py``) and the CLI's
``--aov``, ``--max-ray-depth`` and ``--head-compat``, against crt_tpu's.

The API tests mirror tests/test_api.py on ``device="cpu"``.  Images are
held to crt_tpu's (its render run eagerly, ``jit=False``) at rtol 1e-5 /
atol 1e-6, the image tolerance of tests/test_torch_render.py; the CLI's
PPM, 8-bit values of the same image, exactly.
"""

import json

import numpy as np
import pytest
import torch

import crt_tpu
from crt_tpu.frontend import api as japi
from crt_tpu.scene.json_loader import scene_from_dict as jscene_from_dict
from crt_tpu_torch import RenderSettings, render_aov, render_image
from crt_tpu_torch import scene_from_dict
from crt_tpu_torch.frontend import api, cli
from crt_tpu_torch.io.ppm import read_ppm
from crt_tpu_torch.scene.procedural import make_test_scene_dict
from test_scene_loader import minimal_dict
from torch_port_fixtures import _one_torch_thread, _release_heap  # noqa: F401


def test_renderer_settings_tuple_contract():
    rs = api.RendererSettings()
    # positional 6-tuple, same field order as the struct-sequence
    assert tuple(rs) == (
        api.DEFAULT_MAX_RAY_DEPTH,
        api.DEFAULT_DIFFUSE_REFLECTION_RAY_COUNT,
        api.DEFAULT_SHADOW_BIAS,
        api.DEFAULT_REFLECTION_BIAS,
        api.DEFAULT_DIFFUSE_REFLECTION_BIAS,
        api.DEFAULT_REFRACTION_BIAS,
    )
    assert api.DEFAULT_MAX_RAY_DEPTH == 3
    assert api.DEFAULT_DIFFUSE_REFLECTION_RAY_COUNT == 4
    assert api.DEFAULT_SCENE_BUCKET_SIZE == 24
    assert tuple(rs) == tuple(japi.RendererSettings())
    assert rs._fields == japi.RendererSettings._fields


def test_render_scene_from_dict_vflip_and_rgba():
    d = minimal_dict()
    rgba = api.render_scene_from_dict_array(d, "/", device="cpu")
    assert rgba.shape == (4, 8, 4) and rgba.dtype == np.float32
    assert (rgba[..., 3] == 1.0).all()

    flat = api.render_scene_from_dict(d, "/", device="cpu")
    assert len(flat) == 4 * 8
    assert all(len(px) == 4 for px in flat)

    # V-flip: flat row 0 is the image's BOTTOM row
    img = render_image(scene_from_dict(d, device="cpu")).numpy()
    np.testing.assert_array_equal(np.asarray(flat[:8])[:, :3], img[-1])
    np.testing.assert_allclose(rgba, japi.render_scene_from_dict_array(d, "/"),
                               rtol=1e-5, atol=1e-6)


def test_render_scene_from_dict_accepts_plain_tuple():
    d = minimal_dict()
    out = api.render_scene_from_dict_array(
        d, "/", (2, 1, 1e-2, 1e-2, 1e-2, 1e-2), device="cpu")
    assert out.shape == (4, 8, 4)
    st = api._to_settings((2, 1, 1e-2, 1e-2, 1e-2, 1e-2))
    assert (st.max_ray_depth, st.diffuse_reflection_ray_count) == (2, 1)
    full = RenderSettings(backend="bruteforce", aov="depth")
    assert api._to_settings(full) is full


def test_api_settings_reach_the_render():
    """A depth-1 tuple and a RenderSettings with an AOV render what
    render_image renders with them, V-flipped, as crt_tpu's API does."""
    d = make_test_scene_dict(32, 24, num_quads=4)
    scene = scene_from_dict(d, device="cpu")
    js = jscene_from_dict(d, build_accel=False)
    for rs, jrs in (((1, 4, 1e-2, 1e-2, 1e-2, 1e-2), None),
                    (RenderSettings(aov="normal"),
                     crt_tpu.RenderSettings(aov="normal",
                                            backend="bruteforce"))):
        got = api.render_scene_from_dict_array(d, "/", rs, device="cpu")
        want = render_image(scene, api._to_settings(rs)).numpy()[::-1]
        np.testing.assert_array_equal(got[..., :3], want)
        if jrs is not None:
            ref = np.asarray(crt_tpu.render_image(js, jrs, jit=False))
            np.testing.assert_allclose(got[..., :3], ref[::-1], rtol=1e-5,
                                       atol=1e-6)


def test_api_strict_and_default_device(monkeypatch):
    """Scenes go through the strict loader, as in crt_tpu; the default
    device is the card, which raises where there is none."""
    d = minimal_dict()
    del d["lights"]
    with pytest.raises(ValueError, match="strict"):
        api.render_scene_from_dict_array(d, "/", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        api.render_scene_from_dict(minimal_dict(), "/")


def test_cli_aov_depth_and_head_compat(tmp_path, capsys, monkeypatch):
    """--aov depth --max-ray-depth 1 --head-compat --device cpu writes the
    depth AOV's PPM; the flags reach the settings as crt_tpu's CLI sets
    them."""
    data = make_test_scene_dict(40, 24, num_quads=4)
    scene_path = tmp_path / "scene.crtscene"
    scene_path.write_text(json.dumps(data))
    out = tmp_path / "depth.ppm"
    assert cli.main([str(scene_path), str(out), "--aov", "depth",
                     "--max-ray-depth", "1", "--head-compat",
                     "--device", "cpu"]) == 0
    assert "Execution time:" in capsys.readouterr().out
    assert out.read_text().startswith("P3\n40 24\n255\n")
    depth = render_aov(scene_from_dict(data, device="cpu"),
                       RenderSettings(), "depth").numpy()
    np.testing.assert_array_equal(
        read_ppm(str(out)),
        np.clip(np.trunc(depth * np.float32(255)), 0, 255) / 255)

    seen = []
    real = cli.render_image_hwc
    monkeypatch.setattr(cli, "render_image_hwc",
                        lambda scene, st: seen.append(st) or real(scene, st))
    assert cli.main([str(scene_path), str(out), "--max-ray-depth", "1",
                     "--head-compat", "--device", "cpu"]) == 0
    assert cli.main([str(scene_path), str(out), "--aov", "tri_id",
                     "--device", "cpu"]) == 0
    beauty, tri = seen
    assert (beauty.max_ray_depth, beauty.head_compat, beauty.aov) == (
        1, True, "")
    assert beauty.no_shadows and beauty.gi_divide
    assert (tri.max_ray_depth, tri.head_compat, tri.aov) == (
        RenderSettings().max_ray_depth, False, "tri_id")
    img = read_ppm(str(out))
    want = render_aov(scene_from_dict(data, device="cpu"),
                      RenderSettings(), "tri_id").numpy()
    np.testing.assert_array_equal(
        img, np.clip(np.trunc(want * np.float32(255)), 0, 255) / 255)
    with pytest.raises(SystemExit):
        cli.main([str(scene_path), str(out), "--aov", "beauty",
                  "--device", "cpu"])

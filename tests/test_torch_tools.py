"""crt_tpu_torch/tools/: each tool held to crt_tpu's tool of the same name.

- render_turntable: the frames written as PNGs equal quantize(render) of
  the same rigs, and those renders equal crt_tpu's render_image of
  crt_tpu's rigs at rtol 1e-5 / atol 1e-6 (tests/test_torch_render.py's
  tolerance for a jitted crt_tpu image);
- golden_check and render_all on a corpus built in tmp_path (two
  HEAD_GOLDEN_CASES scenes, goldens rendered by the port with seeded
  noise on a tenth of the pixels): fractions and MAEs equal to crt_tpu's
  tools within 1e-6, crt_tpu's golden paths monkeypatched;
- export_mesh_header: byte-equal text;
- oracle_f64: OracleScene.shade within 1e-12 of crt_tpu's on the same
  float64 rays, and its share of pixels within 2.5/255 of the port's render
  at least the share crt_tpu's oracle reaches against crt_tpu's render;
- stage_blender_addon: the zip's files, then the unpacked add-on rendering
  in a child process that can import crt_tpu_torch only from the zip,
  equal to render_scene_from_dict_array on the CPU;
- the tools that render refuse to run without a card unless given
  ``--device cpu``.
"""

import importlib.util
import json
import math
import os
import pathlib
import sys
import tomllib
import zipfile

import numpy as np
import pytest
import torch

import crt_tpu
import crt_tpu.utils.cache as jcache
import crt_tpu.utils.golden as jgolden
from crt_tpu.ops import camera as jcamera
from crt_tpu.scene.json_loader import load_scene as jload_scene
from crt_tpu.utils.camera_rig import CameraRig as JCameraRig
from crt_tpu_torch import RenderSettings, load_scene, render_image
from crt_tpu_torch.frontend import api
from crt_tpu_torch.io import png
from crt_tpu_torch.io.ppm import quantize, read_ppm
from crt_tpu_torch.scene.procedural import make_test_scene_dict
from crt_tpu_torch.tools import (
    export_mesh_header,
    golden_check,
    oracle_f64,
    render_all,
    render_turntable,
    stage_blender_addon,
)
from crt_tpu_torch.utils import golden
from blender_addon_child import run_staged_addon
from torch_port_fixtures import _one_torch_thread, _release_heap  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = 2.5 / 255

# (kwargs of make_test_scene_dict, golden case): the opaque and the mirror
# variants of the test scene under two golden names and their profiles
CORPUS = {
    "09-02-diffuse-smooth-shading-scene2": dict(with_reflective=False),
    "09-03-reflective-scene4": dict(),
}
SCENE_KW = {"opaque": dict(with_reflective=False), "mirror": dict(),
            "glass": dict(with_refractive=True)}


def _crt_tpu_tool(name):
    """crt_tpu's tools/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(
        f"crt_tpu_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_scene(path, d):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(d))
    return path


@pytest.fixture
def corpus(tmp_path, monkeypatch):
    """A reference checkout in tmp_path: scenes/<rel> and
    results/png/<name>.png for the CORPUS cases; CRT_REFERENCE names it
    and crt_tpu's golden paths point into it."""
    root = tmp_path / "reference"
    rng = np.random.default_rng(0)
    filters = []
    for rel, name, overrides in golden.HEAD_GOLDEN_CASES:
        if name not in CORPUS:
            continue
        d = make_test_scene_dict(48, 27, num_quads=6, **CORPUS[name])
        path = _write_scene(root / "scenes" / rel, d)
        img = render_image(load_scene(str(path), device="cpu"),
                           RenderSettings(**overrides)).numpy()
        q = quantize(img)
        noisy = rng.random(q.shape[:2]) < 0.1
        q[noisy] += rng.integers(-9, 10, (int(noisy.sum()), 3))
        (root / "results" / "png").mkdir(parents=True, exist_ok=True)
        png.write_png(np.clip(q, 0, 255).astype(np.uint8),
                      root / "results" / "png" / f"{name}.png")
        filters.append(rel.removesuffix(".crtscene"))
    assert len(filters) == 2
    monkeypatch.setenv("CRT_REFERENCE", str(root))
    monkeypatch.setattr(jgolden, "GOLDEN_PNG", root / "results" / "png")
    monkeypatch.setattr(jgolden, "SCENES", root / "scenes")
    monkeypatch.setattr(jcache, "enable_compilation_cache", lambda: None)
    return root, filters


def test_golden_check_matches_crt_tpu(corpus, tmp_path, capsys):
    _, filters = corpus
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    assert golden_check.main([*filters, "--json", str(ours),
                              "--device", "cpu"]) == 0
    _crt_tpu_tool("golden_check").main([*filters, "--json", str(theirs)])
    assert "ERROR" not in capsys.readouterr().out
    got, want = json.loads(ours.read_text()), json.loads(theirs.read_text())
    assert [g["name"] for g in got] == [w["name"] for w in want]
    assert len(got) == 2
    for g, w in zip(got, want):
        assert 0.5 < g["frac"] < 1.0 and g["mae"] > 0
        assert abs(g["frac"] - w["frac"]) <= 1e-6
        assert abs(g["mae"] - w["mae"]) <= 1e-6


def _table(readme):
    return [line.split(" | ") for line in readme.read_text().splitlines()
            if line.startswith("| 0")]


def test_render_all_matches_crt_tpu(corpus, tmp_path, capsys):
    _, filters = corpus
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    assert render_all.main([str(ours), *filters, "--device", "cpu"]) == 0
    _crt_tpu_tool("render_all").main([str(theirs), *filters])
    assert "ERROR" not in capsys.readouterr().out
    assert (ours / "README.md").read_text().startswith(
        "# crt_tpu_torch renders")
    got, want = _table(ours / "README.md"), _table(theirs / "README.md")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g[0] == w[0]
        assert abs(float(g[2]) - float(w[2])) <= 1e-6  # golden match
        assert abs(float(g[3].rstrip(" |")) - float(w[3].rstrip(" |"))) \
            <= 1e-6  # MAE
    assert len(list((ours / "ppm").iterdir())) == 2
    for p in (ours / "png").iterdir():
        ppm = read_ppm(ours / "ppm" / f"{p.stem}.ppm")  # float, / 255
        np.testing.assert_array_equal(png.read_png(p), np.rint(ppm * 255))


def test_golden_check_reports_a_failed_case(corpus, capsys):
    root, filters = corpus
    (root / "results" / "png" / "09-03-reflective-scene4.png").unlink()
    assert golden_check.main([*filters, "--device", "cpu"]) == 1
    assert "09-03-reflective-scene4: ERROR FileNotFoundError" in \
        capsys.readouterr().out


def test_turntable_matches_crt_tpu(tmp_path):
    path = _write_scene(tmp_path / "s.crtscene",
                        make_test_scene_dict(48, 32, num_quads=6))
    out = tmp_path / "frames"
    assert render_turntable.main([str(path), str(out), "--frames", "3",
                                  "--device", "cpu"]) == 0
    scene = load_scene(str(path), device="cpu")
    rigs = render_turntable.orbit_rigs(scene, 3)
    jscene = jload_scene(str(path))
    anchor = np.asarray(jscene.vertices).mean(axis=0)
    jrig0 = JCameraRig.from_scene(jscene)
    assert sorted(p.name for p in out.iterdir()) == [
        "frame_000.png", "frame_001.png", "frame_002.png"]
    for f, rig in enumerate(rigs):
        img = render_image(rig.apply(scene)).numpy()
        np.testing.assert_array_equal(
            png.read_png(out / f"frame_{f:03d}.png"), quantize(img))
        jrig = jrig0.pan_around(2.0 * math.pi * f / 3, anchor)
        ref = np.asarray(crt_tpu.render_image(jrig.apply(jscene),
                                              crt_tpu.RenderSettings()))
        np.testing.assert_allclose(img, ref, rtol=1e-5, atol=1e-6)
        if f:
            assert not np.array_equal(
                img, render_image(rigs[0].apply(scene)).numpy())


def test_export_header_byte_equal(tmp_path):
    path = _write_scene(tmp_path / "s.crtscene", make_test_scene_dict(
        32, 18, num_quads=5, with_refractive=True))
    want = _crt_tpu_tool("export_mesh_header").export_header(
        jload_scene(str(path), build_accel=False), "mesh_ns")
    got = export_mesh_header.export_header(
        load_scene(str(path), device="cpu", build_accel=False), "mesh_ns")
    assert got == want
    out = tmp_path / "m.h"
    assert export_mesh_header.main([str(path), str(out), "mesh_ns"]) == 0
    assert out.read_bytes() == want.encode("utf-8")


def _jrays(jscene):
    ys, xs = np.mgrid[0:jscene.height, 0:jscene.width]
    o, d = jcamera.generate_rays(
        jscene.cam_position, jscene.cam_rotation, jscene.cam_tan_half_fov,
        jscene.width, jscene.height, np.float32(xs.ravel()),
        np.float32(ys.ravel()))
    return np.asarray(o, np.float64), np.asarray(d, np.float64), xs, ys


def _share(oracle, render):
    q = lambda x: np.clip((x * 255).astype(int), 0, 255) / 255.0  # noqa
    return float((np.abs(q(oracle) - q(render)).max(axis=-1) <= TOL).mean())


@pytest.mark.parametrize("kind", sorted(SCENE_KW))
def test_oracle_matches_crt_tpu(tmp_path, kind):
    path = _write_scene(tmp_path / "s.crtscene",
                        make_test_scene_dict(48, 32, **SCENE_KW[kind]))
    jscene = jload_scene(str(path))
    scene = load_scene(str(path), device="cpu")
    jorc = _crt_tpu_tool("oracle_f64")
    o, d, xs, ys = _jrays(jscene)
    theirs = jorc.OracleScene(jscene).shade(o, d, 0,
                                            crt_tpu.RenderSettings())
    ours = oracle_f64.OracleScene(scene).shade(o, d, 0, RenderSettings())
    assert ours.shape == (o.shape[0], 3) and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-12)

    # the share within 2.5/255 of each package's own render
    jimg = np.asarray(crt_tpu.render_image(jscene, crt_tpu.RenderSettings()))
    img = render_image(scene).numpy()
    mine = oracle_f64.oracle_pixels(scene, RenderSettings(), xs.ravel(),
                                    ys.ravel())
    share = _share(mine, img.reshape(-1, 3))
    ref_share = _share(theirs, jimg.reshape(-1, 3))
    assert share >= ref_share and share > 0.9, (share, ref_share)


def test_oracle_main_on_the_corpus(corpus, capsys):
    root, _ = corpus
    rel = "09-03-reflective/scene4.crtscene"
    assert oracle_f64.main([str(root / "scenes" / rel),
                            "09-03-reflective-scene4", "--limit", "50",
                            "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "disputed pixels; oracle on 50" in out
    assert "oracle == ours:   1.000" in out


def test_staged_zip_files(tmp_path):
    out = tmp_path / "addon.zip"
    assert stage_blender_addon.main([str(out)]) == 0
    names = zipfile.ZipFile(out).namelist()
    top = stage_blender_addon.ADDON_ID + "/"
    assert all(n.startswith(top) for n in names)
    rel = {n[len(top):] for n in names}
    from crt_tpu_torch.ops import cuda_lib

    assert {r for r in rel if "/" not in r} == {"blender_manifest.toml",
                                               "__init__.py"}
    for f in ("crt_tpu_torch/__init__.py",
              "crt_tpu_torch/ops/cuda_lib.py",
              "crt_tpu_torch/frontend/blender/engine.py",
              "native/crt_accel.cpp", "native/crt_ppm.cpp",
              "crt_tpu_torch/io/png_unfilter.cpp",
              *(f"crt_tpu_torch/csrc/{s}"
                for s in cuda_lib.SOURCES + cuda_lib.HEADERS)):
        assert f in rel, f
    assert not any("build/" in n or "__pycache__" in n or n.endswith(".so")
                   or n.endswith(".pyc") for n in names)
    with zipfile.ZipFile(out) as z:
        manifest = tomllib.loads(z.read(top + "blender_manifest.toml")
                                 .decode())
    from crt_tpu_torch.frontend import blender

    assert manifest["id"] == "crt_tpu_torch_renderer"
    assert manifest["name"] == blender.bl_info["name"]
    assert manifest["blender_version_min"] == "4.2.0"
    assert manifest["type"] == "add-on" and manifest["permissions"]["files"]
    assert manifest["license"] and all(lic.startswith("SPDX:")
                                       for lic in manifest["license"])


def test_staged_addon_renders_from_the_zip(tmp_path):
    d = make_test_scene_dict(32, 18, num_quads=4)
    info, rect, exported = run_staged_addon(tmp_path, d, "cpu")
    root = str(tmp_path / "unpacked" / stage_blender_addon.ADDON_ID)
    assert info["package"].startswith(root + os.sep)
    assert info["addon"] == os.path.join(root, "__init__.py")
    assert info["kd_builder"] in ("native", "numpy")
    # the zip's own sources build the native library, PNG filters included
    assert info["png_unfilter"] == info["kd_builder"]
    if info["native_library"]:
        assert info["native_library"].startswith(
            os.path.join(root, "build", "crt_tpu_torch") + os.sep)
    assert info["build"] is None  # no kernel on the CPU
    ref = api.render_scene_from_dict_array(exported, "/", info["settings"],
                                           device="cpu")
    assert rect.shape == (32 * 18, 4)
    np.testing.assert_array_equal(rect, ref.reshape(-1, 4))


@pytest.mark.parametrize("tool", ["golden_check", "render_all",
                                  "render_turntable", "oracle_f64"])
def test_tools_refuse_without_a_card(tool, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("CRT_REFERENCE", str(tmp_path))
    argv = {"golden_check": [], "render_all": [str(tmp_path / "out")],
            "render_turntable": [str(tmp_path / "out"), "--frames", "1"],
            "oracle_f64": ["s.crtscene", "09-03-reflective-scene4"]}[tool]
    mod = {"golden_check": golden_check, "render_all": render_all,
           "render_turntable": render_turntable,
           "oracle_f64": oracle_f64}[tool]
    assert mod.main(argv) == 2
    assert "none is visible" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("tool", ["golden_check", "render_all"])
def test_corpus_tools_need_the_corpus(tool, monkeypatch, capsys):
    monkeypatch.delenv("CRT_REFERENCE", raising=False)
    mod = {"golden_check": golden_check, "render_all": render_all}[tool]
    assert mod.main(["--device", "cpu"] if tool == "golden_check"
                    else ["/nonexistent-outdir", "--device", "cpu"]) == 2
    assert "CRT_REFERENCE" in capsys.readouterr().err

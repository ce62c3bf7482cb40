"""crt_tpu_torch front end and scope: legacy scenes, chunking, the CLI,
the default device, the jax-free import, and what lies outside the slice.

Tolerance: images vs crt_tpu's bruteforce backend at rtol 1e-5, atol 1e-6
(test_pallas_trace.py's tolerance; XLA's CPU JIT contracts multiply-adds
into FMAs, so values differ from the port's in the last bits); chunking
and the "pallas" alias change nothing (exact).
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import crt_tpu
from crt_tpu_torch import (
    RenderSettings,
    fit_scene,
    load_scene,
    render_image,
    scene_from_dict,
)
from crt_tpu_torch.frontend import cli
from crt_tpu_torch.io.ppm import read_ppm
from crt_tpu_torch.renderer import make_tiler
from crt_tpu_torch.scene.procedural import make_test_scene, make_test_scene_dict
from torch_port_fixtures import _one_torch_thread, _release_heap  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
PREVIEWS = REPO / "docs" / "previews"


@pytest.mark.parametrize("era", ["era07", "era08"])
def test_legacy_scenes_match_crt_tpu(era):
    """Scenes that predate the materials key: 07-era (no lights either)
    shades the gray half-lambert, 08-era gets per-object diffuse materials
    from the palette."""
    data = make_test_scene_dict(40, 24)
    del data["materials"]
    if era == "era07":
        del data["lights"]
        for obj in data["objects"]:
            del obj["material_index"]
    ref = np.asarray(crt_tpu.render_image(
        crt_tpu.scene_from_dict(data, build_accel=False),
        crt_tpu.RenderSettings(backend="bruteforce")))
    scene = scene_from_dict(data, device="cpu")
    assert scene.has_materials == (era == "era08")
    np.testing.assert_allclose(render_image(scene).numpy(), ref, rtol=1e-5,
                               atol=1e-6)


def test_backends_and_chunking_agree():
    """cluster / pallas alias / bruteforce / chunked renders of one scene.
    Chunking and the alias change nothing (exact); the two intersection
    backends round t differently (rtol 1e-5 / atol 1e-6 as above)."""
    scene = make_test_scene(96, 64, num_quads=16, seed=2, device="cpu")
    base = render_image(scene)
    assert torch.equal(render_image(scene, RenderSettings(backend="pallas")),
                       base)
    assert torch.equal(
        render_image(scene, RenderSettings(chunk_pixels=2048)), base)
    assert torch.equal(
        render_image(scene, RenderSettings(chunk_pixels=2500)), base)
    brute = render_image(scene, RenderSettings(backend="bruteforce"))
    np.testing.assert_allclose(brute.numpy(), base.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_cli_writes_p3_ppm(tmp_path, capsys):
    scene_path = tmp_path / "scene.crtscene"
    scene_path.write_text(json.dumps(make_test_scene_dict(40, 24)))
    out = tmp_path / "out.ppm"
    assert cli.main([str(scene_path), str(out), "--device", "cpu",
                     "--width", "48", "--repeat", "2"]) == 0
    assert "Execution time:" in capsys.readouterr().out
    text = out.read_text()
    assert text.startswith("P3\n48 24\n255\n")
    img = read_ppm(str(out))
    assert img.shape == (24, 48, 3)
    expected = render_image(make_test_scene(48, 24, device="cpu")).numpy()
    np.testing.assert_array_equal(
        img, np.clip(np.trunc(expected * np.float32(255)), 0, 255) / 255)
    assert cli.main([str(tmp_path / "missing.crtscene"), str(out),
                     "--device", "cpu"]) == 1


def test_cli_default_scene_is_the_reference_clis(tmp_path, monkeypatch,
                                                capsys):
    """No scene argument: the reference CLI's default scene under
    $CRT_REFERENCE, written to output.ppm in the working directory, equal
    to crt_tpu's CLI given the same file by path."""
    scene_path = tmp_path / "ref" / cli.DEFAULT_SCENE
    scene_path.parent.mkdir(parents=True)
    scene_path.write_text(json.dumps(make_test_scene_dict(40, 24)))
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.setenv("CRT_REFERENCE", str(tmp_path / "ref"))
    monkeypatch.chdir(work)
    assert cli.main(["--device", "cpu"]) == 0
    assert "Execution time:" in capsys.readouterr().out
    ref_out = tmp_path / "crt_tpu.ppm"
    env = dict(os.environ, JAX_PLATFORMS="cpu", CRT_TPU_FORCE_CPU="1")
    proc = subprocess.run(
        [sys.executable, "-m", "crt_tpu.frontend.cli", str(scene_path),
         str(ref_out)], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert (work / "output.ppm").read_text() == ref_out.read_text()


def test_cli_default_scene_without_the_corpus(tmp_path, monkeypatch,
                                             capsys):
    """Without $CRT_REFERENCE the default scene is a scene that will not
    load (rc 1, crt_tpu's error line); the no-card check still comes
    first (rc 2)."""
    monkeypatch.delenv("CRT_REFERENCE", raising=False)
    monkeypatch.chdir(tmp_path)
    assert cli.main(["--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert err.startswith("Error: Could not parse scene file: ")
    assert cli.DEFAULT_SCENE in err and "CRT_REFERENCE" in err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main([]) == 2
    assert "cpu" in capsys.readouterr().err
    assert not (tmp_path / "output.ppm").exists()


def test_no_card_is_an_error_not_a_cpu_run(tmp_path, capsys, monkeypatch):
    """Without a visible card the entry points raise, and the CLI prints an
    error and returns non-zero, unless the CPU is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene_path = tmp_path / "scene.crtscene"
    scene_path.write_text(json.dumps(make_test_scene_dict(16, 8, 2)))
    out = tmp_path / "out.ppm"
    assert cli.main([str(scene_path), str(out)]) == 2
    assert cli.main([str(scene_path), str(out), "--device", "cuda"]) == 2
    captured = capsys.readouterr()
    assert "Error:" in captured.err and "cpu" in captured.err
    assert "Execution time" not in captured.out and not out.exists()
    for build in (lambda: load_scene(str(scene_path)),
                  lambda: scene_from_dict(make_test_scene_dict(16, 8, 2)),
                  lambda: make_test_scene(16, 8, 2),
                  lambda: make_tiler(8, 16)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build()
    assert load_scene(str(scene_path), device="cpu").device.type == "cpu"
    assert make_tiler(8, 16, device="cpu")[0].device.type == "cpu"


def test_import_does_not_load_jax():
    code = ("import sys, crt_tpu_torch, crt_tpu_torch.frontend.cli, "
            "crt_tpu_torch.ops.cluster_trace, crt_tpu_torch.ops.cuda_lib, "
            "crt_tpu_torch.ops.segsum, crt_tpu_torch.ops.shade_iter, "
            "crt_tpu_torch.optim, crt_tpu_torch.io.jpeg_stb, "
            "crt_tpu_torch.frontend.api, crt_tpu_torch.ops.traverse, "
            "crt_tpu_torch.scene.accel, crt_tpu_torch.scene.native_accel, "
            "crt_tpu_torch.io.native_ppm, crt_tpu_torch.utils.camera_rig, "
            "crt_tpu_torch.utils.debug, crt_tpu_torch.utils.metrics, "
            "crt_tpu_torch.utils.checks, crt_tpu_torch.utils.golden, "
            "crt_tpu_torch.utils.era, crt_tpu_torch.parallel, "
            "crt_tpu_torch.parallel.sharded, "
            "crt_tpu_torch.parallel.scene_sharded, "
            "crt_tpu_torch.parallel.multihost, "
            "crt_tpu_torch.frontend.blender, "
            "crt_tpu_torch.frontend.blender.engine, "
            "crt_tpu_torch.frontend.blender.ops, "
            "crt_tpu_torch.frontend.blender.properties, "
            "crt_tpu_torch.frontend.blender.scene_bridge, "
            "crt_tpu_torch.frontend.blender.ui, crt_tpu_torch.io.png, "
            "crt_tpu_torch.tools, crt_tpu_torch.tools.golden_check, "
            "crt_tpu_torch.tools.render_all, "
            "crt_tpu_torch.tools.render_turntable, "
            "crt_tpu_torch.tools.export_mesh_header, "
            "crt_tpu_torch.tools.oracle_f64, "
            "crt_tpu_torch.tools.stage_blender_addon; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'jaxlib', 'crt_tpu.', 'PIL.')) or m in ('crt_tpu', "
            "'PIL')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("case", ["refractive", "gi", "bitmap", "aov", "tree",
                                  "stream", "iter", "grad"])
def test_outside_the_slice_raises(case):
    scene = make_test_scene(32, 32, num_quads=4, device="cpu")
    settings = RenderSettings()
    # inside the slice now: every case
    if case == "refractive":
        # glass is inside the slice, and glass under GI
        glass = make_test_scene(32, 32, num_quads=4, with_refractive=True,
                                device="cpu")
        assert torch.isfinite(render_image(glass)).all()
        scene = glass.replace(gi_on=True)
        settings = RenderSettings(max_ray_depth=2,
                                  diffuse_reflection_ray_count=2)
    elif case == "iter":
        # the iterative wavefront is inside the slice, and its AOVs
        assert torch.isfinite(
            render_image(scene, RenderSettings(wavefront="iter"))).all()
        settings = RenderSettings(wavefront="iter", aov="depth")
    elif case == "gi":
        scene = scene_from_dict(
            make_test_scene_dict(32, 32, num_quads=4, gi_on=True),
            device="cpu")
        settings = RenderSettings(max_ray_depth=2,
                                  diffuse_reflection_ray_count=2)
    elif case == "bitmap":
        scene = scene_from_dict(
            make_test_scene_dict(32, 32, num_quads=4,
                                 floor_bitmap="12-01-textures.jpg"),
            asset_root=str(PREVIEWS), device="cpu")
        assert scene.bitmap_data.shape == (1, 360, 640, 3)
    elif case == "aov":
        settings = RenderSettings(aov="normal")
    elif case == "tree":
        # the KD-tree backend, and its AOVs
        assert torch.isfinite(render_image(
            scene, RenderSettings(backend="tree", aov="depth"))).all()
        settings = RenderSettings(backend="tree")
    elif case == "stream":
        # the streaming backend is inside the slice, and its AOVs
        assert torch.isfinite(render_image(
            scene, RenderSettings(backend="pallas_stream"))).all()
        settings = RenderSettings(backend="pallas_stream", aov="depth")
    else:
        # gradients are inside the slice, through glass and GI too, and
        # their sharded step: without a process group the mesh is one
        # device, and the step is the single-device one
        from crt_tpu_torch.parallel.sharded import make_mesh

        target = render_image(scene) * 1.1

        def sgd(ps):
            return torch.optim.SGD(ps, lr=1.0)

        meshed, _ = fit_scene(scene, target, optimizer=sgd, steps=1,
                              mesh=make_mesh())
        single, _ = fit_scene(scene, target, optimizer=sgd, steps=1)
        assert float((single["vertices"] - scene.vertices).abs().max()) > 0
        for key, value in single.items():
            torch.testing.assert_close(meshed[key], value, rtol=0, atol=0)
        glass = make_test_scene(32, 32, num_quads=4, with_refractive=True,
                                device="cpu")
        glass = glass.replace(vertices=glass.vertices.requires_grad_(True))
        assert render_image(glass).requires_grad
        scene = scene_from_dict(
            make_test_scene_dict(32, 32, num_quads=4, gi_on=True,
                                 with_refractive=True), device="cpu")
        scene = scene.replace(vertices=scene.vertices.requires_grad_(True))
        settings = RenderSettings(wavefront="iter", max_ray_depth=2,
                                  diffuse_reflection_ray_count=2)
    img = render_image(scene, settings)
    assert torch.isfinite(img).all() and float(img.detach().mean()) > 0
    if case == "grad":
        img.sum().backward()
        assert torch.isfinite(scene.vertices.grad).all()
        assert scene.vertices.grad.abs().max() > 0
    with pytest.raises(ValueError):
        render_image(make_test_scene(32, 32, num_quads=4, device="cpu"),
                     RenderSettings(backend="nope"))

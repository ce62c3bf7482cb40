"""crt_tpu_torch front end and scope: legacy scenes, chunking, the CLI,
the default device, the jax-free import, and what lies outside the slice.

Tolerance: images vs crt_tpu's bruteforce backend at rtol 1e-5, atol 1e-6
(test_pallas_trace.py's tolerance; XLA's CPU JIT contracts multiply-adds
into FMAs, so values differ from the port's in the last bits); chunking
and the "pallas" alias change nothing (exact).
"""

import json
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
from crt_tpu_torch.scene.procedural import make_test_scene, make_test_scene_dict


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs one worker per core, and torch's
    default (a thread per core in every worker) oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
                  lambda: make_test_scene(16, 8, 2)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build()
    assert load_scene(str(scene_path), device="cpu").device.type == "cpu"


def test_import_does_not_load_jax():
    code = ("import sys, crt_tpu_torch, crt_tpu_torch.frontend.cli, "
            "crt_tpu_torch.ops.cluster_trace, crt_tpu_torch.ops.cuda_lib, "
            "crt_tpu_torch.ops.segsum, crt_tpu_torch.optim; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'jaxlib', 'crt_tpu.')) or m == 'crt_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("case", ["refractive", "gi", "aov", "tree",
                                  "stream", "iter", "grad"])
def test_outside_the_slice_raises(case):
    scene = make_test_scene(32, 32, num_quads=4, device="cpu")
    settings = RenderSettings()
    if case == "refractive":
        scene = make_test_scene(32, 32, num_quads=4, with_refractive=True,
                                device="cpu")
    elif case == "gi":
        scene = scene_from_dict(
            make_test_scene_dict(32, 32, num_quads=4, gi_on=True),
            device="cpu")
    elif case == "aov":
        settings = RenderSettings(aov="normal")
    elif case == "tree":
        settings = RenderSettings(backend="tree")
    elif case == "stream":
        settings = RenderSettings(backend="pallas_stream")
    elif case == "iter":
        settings = RenderSettings(wavefront="iter")
    else:
        # gradients are inside the slice; their sharded step is not
        with pytest.raises(NotImplementedError, match="ROADMAP A13"):
            fit_scene(scene, render_image(scene), mesh=object(), steps=1)
        scene = make_test_scene(32, 32, num_quads=4, with_refractive=True,
                                device="cpu")
        scene = scene.replace(vertices=scene.vertices.requires_grad_(True))
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        render_image(scene, settings)
    with pytest.raises(ValueError):
        render_image(make_test_scene(32, 32, num_quads=4, device="cpu"),
                     RenderSettings(backend="nope"))

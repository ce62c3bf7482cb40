"""The utilities of crt_tpu_torch (``utils/``) and its native P3 writer
(``io/native_ppm.py``) vs their crt_tpu counterparts.

Tolerances: the early-era images, ``glibc_random``, ``match_stats``,
``binning_stats``, the ray accounting and the P3 bytes EXACT (NumPy copies,
integer counts, the same binning); ``buggy_compose`` bit for bit against
the reference's in-place loop; camera-rig poses rtol 1e-6 / atol 1e-6
(XLA's and torch's f32 sin / cos may differ by an ulp); the one-pixel ray
log's rays rtol 1e-5 / atol 1e-6 and colour rtol 1e-4 / atol 1e-5 (the
crt_tpu render is jitted and contracts multiply-adds); gradients rtol 1e-3
/ atol 1e-4 of the group's largest entry (test_torch_tree.py's).
"""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import crt_tpu
from crt_tpu.io import ppm as jppm
from crt_tpu.scene.procedural import make_test_scene as jmake_test_scene
from crt_tpu.utils import camera_rig as jrig
from crt_tpu.utils import checks as jchecks
from crt_tpu.utils import debug as jdebug
from crt_tpu.utils import era as jera
from crt_tpu.utils import golden as jgolden
from crt_tpu.utils import metrics as jmetrics
from crt_tpu_torch import RenderSettings, render_image
from crt_tpu_torch.io import native_ppm, ppm
from crt_tpu_torch.scene import native_accel
from crt_tpu_torch.scene.procedural import make_test_scene
from crt_tpu_torch.utils import checks, debug, era, golden, metrics
from crt_tpu_torch.utils.camera_rig import CameraRig
from torch_port_fixtures import _one_torch_thread, _release_heap  # noqa: F401


def _moves(rig, anchor):
    """One pose per move of the rig API, from a rotated start."""
    rig = rig.pan(0.4).tilt(-0.25)
    return {
        "translate_world": rig.translate_world([0.5, -1.0, 2.0]),
        "dolly": rig.dolly(-2.0),
        "truck": rig.truck(1.5),
        "pedestal": rig.pedestal(-0.75),
        "pan": rig.pan(0.3),
        "tilt": rig.tilt(-1.2),
        "roll": rig.roll(1.1),
        "pan_around": rig.pan_around(0.7, anchor),
        "tilt_around": rig.tilt_around(-0.4, anchor),
        "roll_around": rig.roll_around(2.0, anchor),
        "chain": rig.pan(0.3).tilt(-0.2).roll(1.1).dolly(3.0).truck(-1.0),
        "buggy": rig.pan(0.3, buggy_compose=True),
        "buggy_around": rig.tilt_around(0.5, anchor, buggy_compose=True),
    }


def test_camera_rig_matches_crt_tpu():
    anchor = [1.0, 0.0, -2.0]
    want = _moves(jrig.CameraRig.identity((0.0, 0.5, 5.0)), anchor)
    got = _moves(CameraRig.identity((0.0, 0.5, 5.0), device="cpu"), anchor)
    for k in want:
        np.testing.assert_allclose(got[k].position.numpy(),
                                   np.asarray(want[k].position), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got[k].rotation.numpy(),
                                   np.asarray(want[k].rotation), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    r = got["chain"].rotation.numpy()
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-5)


def test_buggy_compose_matches_cpp_inplace_loop():
    """tests/test_utils.py's check, on the port: bit for bit against the
    reference's operator*= (crt_matrix.h:45-54)."""

    def cpp_star_eq(data, rhs):
        data = np.array(data, np.float32)
        for i in range(3):
            for j in range(3):
                for k in range(3):
                    data[i, j] += data[i, k] * rhs[k, j]
        return data

    rig = CameraRig.identity(device="cpu").pan(0.4)
    for angle in (0.3, -1.2):
        m = CameraRig.identity(device="cpu").pan(angle).rotation.numpy()
        expected = cpp_star_eq(rig.rotation.numpy(), m)
        got = rig.pan(angle, buggy_compose=True).rotation.numpy()
        np.testing.assert_array_equal(got, expected)


def test_camera_rig_moves_the_view_and_differentiates():
    scene = make_test_scene(24, 16, num_quads=4, device="cpu")
    rig = CameraRig.from_scene(scene)
    assert torch.equal(rig.apply(scene).cam_position, scene.cam_position)
    img0 = render_image(scene)
    img1 = render_image(rig.truck(2.0).apply(scene))
    assert float((img0 - img1).abs().max()) > 1e-3
    x = torch.tensor(0.5, requires_grad=True)
    rig.pan(x).dolly(2.0).position.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad) and x.grad != 0


def test_camera_rig_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        CameraRig.identity()


@pytest.mark.parametrize("pixel", [(12, 8), (3, 14)])
def test_trace_pixel_matches_crt_tpu(pixel):
    x, y = pixel
    jscene = jmake_test_scene(width=24, height=16, num_quads=4,
                              with_reflective=True)
    want = jdebug.trace_pixel(jscene, x, y,
                              crt_tpu.RenderSettings(backend="bruteforce"))
    scene = make_test_scene(24, 16, num_quads=4, with_reflective=True,
                            device="cpu")
    got = debug.trace_pixel(scene, x, y, RenderSettings(backend="bruteforce"))
    assert len(got.entries) == len(want.entries) > 0
    for g, w in zip(got.entries, want.entries):
        assert g.order == w.order
        np.testing.assert_allclose(g.origin, w.origin, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g.direction, w.direction, rtol=1e-5,
                                   atol=1e-6)
        assert (np.isfinite(g.length) == np.isfinite(w.length))
        if np.isfinite(w.length):
            np.testing.assert_allclose(g.length, w.length, rtol=1e-5)
    np.testing.assert_allclose(got.color, want.color, rtol=1e-4, atol=1e-5)
    script = got.to_blender_script()
    assert script.count("\n") == want.to_blender_script().count("\n")
    assert script.startswith("bpy.ops.crt.debug_ray_add(origin=(")
    assert f"raster_coords=({x}, {y})" in script


@pytest.mark.parametrize("backend", ["cluster", "bruteforce", "tree",
                                     "pallas_stream"])
def test_trace_pixel_on_any_backend(backend):
    """One pixel on each backend: its primary ray starts at the camera and
    its colour is the full render's at that pixel."""
    scene = make_test_scene(24, 16, num_quads=4, with_reflective=True,
                            device="cpu")
    settings = RenderSettings(backend=backend)
    log = debug.trace_pixel(scene, 12, 8, settings)
    np.testing.assert_allclose(log.entries[0].origin,
                               scene.cam_position.numpy(), atol=1e-6)
    img = render_image(scene, settings).numpy()
    np.testing.assert_allclose(log.color, img[8, 12], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("reflective", [False, True])
def test_render_with_stats_matches_crt_tpu(reflective):
    kw = dict(width=32, height=16, num_quads=3, with_reflective=reflective)
    settings = dict(max_ray_depth=2)
    jimg, want = jmetrics.render_with_stats(
        jmake_test_scene(**kw), crt_tpu.RenderSettings(**settings))
    img, got = metrics.render_with_stats(make_test_scene(**kw, device="cpu"),
                                         RenderSettings(**settings))
    assert (got.num_traces, got.rays_traced, got.primary_rays) == (
        want.num_traces, want.rays_traced, want.primary_rays)
    if not reflective:
        assert got.num_traces == 2  # 1 primary + 1 merged shadow trace
    assert got.wall_seconds > 0 and got.mrays_per_second > 0
    assert set(got.as_dict()) == set(want.as_dict())
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), rtol=1e-5,
                               atol=1e-6)


def test_profile_render_writes_a_trace(tmp_path):
    scene = make_test_scene(32, 16, num_quads=3, with_reflective=False,
                            device="cpu")
    img, stats, logdir = metrics.profile_render(scene, logdir=str(tmp_path))
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"] and stats.num_traces == 2
    assert logdir == str(tmp_path) and img.shape == (16, 32, 3)


@pytest.mark.parametrize("num_quads", [3, 10])
def test_binning_stats_match_crt_tpu(num_quads):
    kw = dict(width=64, height=32, num_quads=num_quads)
    want = jmetrics.binning_stats(jmake_test_scene(**kw))
    got = metrics.binning_stats(make_test_scene(**kw, device="cpu"))
    assert got == want


def _check_scene(cls=make_test_scene, **kw):
    return cls(24, 16, num_quads=4, with_reflective=True,
               with_refractive=True, **kw)


def test_checks_pass_and_match_crt_tpu():
    settings = dict(max_ray_depth=2, backend="bruteforce")
    scene = _check_scene(device="cpu")
    img = checks.check_finite(scene, RenderSettings(**settings))
    assert torch.equal(checks.check_deterministic(
        scene, RenderSettings(**settings)), img)
    grads = checks.check_grads_finite(scene, RenderSettings(**settings))
    jscene = _check_scene(jmake_test_scene)
    jgrads = jchecks.check_grads_finite(
        jscene, crt_tpu.RenderSettings(**settings))
    assert set(grads) == set(jgrads)
    for k, jg in jgrads.items():
        jg = np.asarray(jg)
        np.testing.assert_allclose(
            grads[k].numpy(), jg, rtol=1e-3,
            atol=1e-4 * max(float(np.abs(jg).max()), 1e-30), err_msg=k)


def test_checks_catch_faults():
    scene = _check_scene(device="cpu")
    bad = scene.replace(light_intensity=torch.full_like(
        scene.light_intensity, float("nan")))
    with pytest.raises(FloatingPointError, match="nan"):
        checks.check_finite(bad, RenderSettings(max_ray_depth=2))
    with pytest.raises(AssertionError, match="non-finite gradients"):
        checks.check_grads_finite(bad, RenderSettings(max_ray_depth=2))
    calls = [0]

    def drifting(scene, settings):
        calls[0] += 1
        return torch.full((2, 2, 3), float(calls[0]))

    import crt_tpu_torch.utils.checks as mod

    real = mod.render_image
    mod.render_image = drifting
    try:
        with pytest.raises(AssertionError, match="non-deterministic"):
            checks.check_deterministic(scene)
    finally:
        mod.render_image = real


def test_golden_tables_and_match_stats_match_crt_tpu():
    for name in ("HEAD_GOLDEN_CASES", "SMOKE_CASES", "LEGACY_GOLDEN_CASES"):
        assert getattr(golden, name) == getattr(jgolden, name), name
    rng = np.random.default_rng(3)
    golden_img = np.round(rng.uniform(0, 1, (24, 40, 3)) * 255) / 255
    for scale in (0.0, 1e-3, 2e-2):
        render = np.clip(golden_img + rng.normal(0, scale, golden_img.shape),
                         -0.1, 1.2).astype(np.float32)
        render[0, 0] = [np.inf, -np.inf, 0.5]
        assert golden.match_stats(render, golden_img) == \
            jgolden.match_stats(render, golden_img)
        assert golden.match_stats(render, golden_img, tol=0.5 / 255) == \
            jgolden.match_stats(render, golden_img, tol=0.5 / 255)


def test_load_golden_without_the_corpus(monkeypatch, tmp_path):
    monkeypatch.delenv("CRT_REFERENCE", raising=False)
    with pytest.raises(FileNotFoundError, match="CRT_REFERENCE"):
        golden.load_golden("14-01-acceleration-tree-scene0")
    monkeypatch.setenv("CRT_REFERENCE", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no golden image"):
        golden.load_golden("14-01-acceleration-tree-scene0")


@pytest.mark.parametrize("case", range(len(jera.ERA_CASES)))
def test_era_cases_bit_equal(case):
    name, fn = era.ERA_CASES[case]
    jname, jfn = jera.ERA_CASES[case]
    assert name == jname
    for w, h in ((160, 90), (17, 31)):
        a, b = fn(w, h), jfn(w, h)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_era_generators_bit_equal():
    for seed in (1, 12345):
        np.testing.assert_array_equal(era.glibc_random(seed, 2000),
                                      jera.glibc_random(seed, 2000))
    np.testing.assert_array_equal(era.render_rectangle_grid(64, 48, 4),
                                  jera.render_rectangle_grid(64, 48, 4))
    np.testing.assert_array_equal(era.render_circle(300, 320, radius=90.5),
                                  jera.render_circle(300, 320, radius=90.5))
    assert math.isclose(era.ERA02_CIRCLE_RADIUS, jera.ERA02_CIRCLE_RADIUS)


def _images():
    rng = np.random.default_rng(11)
    img = rng.uniform(-0.2, 1.3, (9, 13, 3)).astype(np.float32)
    img[0, :3] = [[np.inf, -np.inf, np.nan]] * 3
    return {"random": img, "black": np.zeros((2, 3, 3), np.float32),
            "white": np.ones((1, 1, 3), np.float32)}


@pytest.mark.parametrize("name", sorted(_images()))
@pytest.mark.parametrize("maxc", [255, 1000])
def test_native_ppm_bytes_equal_python_and_crt_tpu(name, maxc):
    img = _images()[name]
    native = native_ppm.format_ppm_native(ppm.quantize(img, maxc), maxc)
    assert native == ppm.format_ppm_python(ppm.quantize(img, maxc), maxc)
    assert ppm.format_ppm(img, maxc) == native
    assert native == jppm.format_ppm(jnp.asarray(img), maxc)


def test_format_ppm_falls_back_to_python(monkeypatch):
    img = _images()["random"]
    want = ppm.format_ppm(img)

    def broken():
        raise OSError("no library")

    monkeypatch.setattr(native_accel, "library", broken)
    with pytest.raises(OSError):
        native_ppm.format_ppm_native(ppm.quantize(img), 255)
    assert ppm.format_ppm(img) == want

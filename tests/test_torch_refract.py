"""Refraction and the transmissive shadow march of crt_tpu_torch vs crt_tpu.

``refract`` against ``crt_tpu.ops.vecmath.refract`` on seeded inputs; the
glass router of ``_occlusion_masks`` (one pass of the w-occlusion kernel in
its glass-flag mode, then the bend-walk on the glass-suspect lanes, over
the live 1024-lane blocks) against the unconditional full-width march
inside the port, bit for bit, and against crt_tpu's image.

Tolerances.  ``refract``: rtol 1e-6 / atol 1e-7 on the direction (XLA's
CPU sqrt and the port's fp64-rounded one agree, the divide and the
products may round an ulp apart), the ``ok`` mask equal.  Images vs
crt_tpu: rtol 1e-5 / atol 1e-6, test_pallas_trace.py's tolerance (the JAX
render is jitted and contracts multiply-adds).  Router / narrowing vs the
full-width march inside the port: EXACT.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

import crt_tpu
from crt_tpu.ops import vecmath as jvecmath
from crt_tpu.scene.procedural import make_test_scene as jmake_test_scene
from crt_tpu_torch import RenderSettings, render_image, scene_from_dict
from crt_tpu_torch.ops import camera
from crt_tpu_torch.ops import cluster_trace as ttr
from crt_tpu_torch.ops import shade as tshade
from crt_tpu_torch.ops import vecmath
from crt_tpu_torch.renderer import make_tiler
from crt_tpu_torch.scene.procedural import make_test_scene
from crt_tpu_torch.scene.types import MATERIAL_REFRACTIVE
from crt_tpu_torch.utils import trace as tracing
from torch_port_fixtures import _one_torch_thread, _release_heap  # noqa: F401


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("case", ["entering", "exiting", "grazing"])
def test_refract_matches_crt_tpu(case):
    rng = np.random.default_rng({"entering": 0, "exiting": 1, "grazing": 2}[case])
    n = _unit(rng.normal(size=(4096, 3)))
    v = _unit(rng.normal(size=(4096, 3)))
    v = np.where((v * n).sum(-1, keepdims=True) > 0, -v, v)  # v faces n
    if case == "grazing":  # nearly tangent: steep sines, both branches
        v = _unit(v + n * (v * n).sum(-1, keepdims=True) * -0.97)
    ior = rng.uniform(1.05, 2.4, 4096).astype(np.float32)
    one = np.ones_like(ior)
    outside, inside = (ior, one) if case == "exiting" else (one, ior)
    if case == "grazing":
        outside, inside = np.where(rng.random(4096) < 0.5, (ior, one),
                                   (one, ior))
    want, want_ok = jvecmath.refract(*map(jnp.asarray,
                                          (v, n, outside, inside)))
    got, got_ok = vecmath.refract(*map(torch.from_numpy,
                                       (v, n, outside, inside)))
    want_ok = np.array(want_ok)
    np.testing.assert_array_equal(got_ok.numpy(), want_ok)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    if case != "entering":  # total internal reflection happens
        assert want_ok.any() and not want_ok.all()
    else:
        assert want_ok.all()
    # Snell: the refracted ray is unit and leaves on the far side of n
    ok = torch.from_numpy(want_ok)
    np.testing.assert_allclose(got[ok].norm(dim=-1).numpy(), 1.0, atol=1e-5)
    assert (vecmath.dot(got, torch.from_numpy(n))[ok] <= 1e-6).all()


def test_refract_gradient_is_finite():
    rng = np.random.default_rng(3)
    n = torch.from_numpy(_unit(rng.normal(size=(256, 3))))
    v = torch.from_numpy(_unit(rng.normal(size=(256, 3))))
    ior = torch.full((256,), 1.5, requires_grad=True)
    out, ok = vecmath.refract(v, n, torch.ones(256), ior)
    torch.where(ok[:, None], out, torch.zeros_like(out)).sum().backward()
    assert torch.isfinite(ior.grad).all() and ior.grad.abs().max() > 0


def _glass_scene():
    return dict(width=64, height=32, num_quads=6, with_refractive=True)


def _shadow_inputs(scene, trace):
    """Primary hit points, biased origins and an all-valid active mask."""
    rx, ry, _ = make_tiler(scene.height, scene.width, device=scene.device)
    o, d = camera.generate_rays(scene.cam_position, scene.cam_rotation,
                                scene.cam_tan_half_fov, scene.width,
                                scene.height, rx, ry)
    hit = trace(o, d)
    t = torch.where(hit.tri >= 0, hit.t, torch.zeros_like(hit.t))
    point = o + d * t[:, None]
    shadow_o = point + 1e-3 * torch.tensor([0.0, 1.0, 0.0])
    lp = scene.light_position
    act = (hit.tri >= 0)[None].expand(lp.shape[0], -1)
    return point, shadow_o, lp, act


@pytest.mark.parametrize("route", ["refr_ray_hit_w", "shadow_apex_w_glass"])
def test_glass_flag_is_a_superset_of_fp64_truth(route):
    """Both routes to the glass flag, the separate uncapped pass and the
    router (``shadow_glass``, crt_tpu's ``shadow_apex_w_glass``), mark
    every lane whose uncapped shadow ray really hits refractive geometry
    (all-pairs test in fp64 with small margins, as
    tests/test_lane_compact.py does for crt_tpu's gate)."""
    scene = make_test_scene(**_glass_scene(), device="cpu")
    trace = ttr.make_cluster_trace_fn(scene)
    point, shadow_o, lp, act = _shadow_inputs(scene, trace)
    if route == "refr_ray_hit_w":
        flag = trace.refr_ray_hit_w(point, shadow_o, lp, act, 2e-3).numpy()
    else:
        flag = trace.shadow_glass(point, shadow_o, lp, act, 2e-3)[1].numpy()

    verts = scene.vertices.numpy().astype(np.float64)
    tvi = scene.tri_vidx.numpy()
    glass = (scene.mat_type.numpy()[scene.tri_material.numpy()]
             == MATERIAL_REFRACTIVE)
    gv0, gv1, gv2 = (verts[tvi[glass, k]] for k in range(3))
    n_t = np.cross(gv1 - gv0, gv2 - gv0)
    n_t = n_t / np.maximum(np.linalg.norm(n_t, axis=-1, keepdims=True), 1e-300)
    so = shadow_o.numpy().astype(np.float64)
    pp = point.numpy().astype(np.float64)
    found = 0
    for l in range(lp.shape[0]):
        w = lp[l].numpy().astype(np.float64)[None] - pp
        nd = w @ n_t.T
        opd = (n_t * gv0).sum(-1)[None] - so @ n_t.T
        with np.errstate(divide="ignore", invalid="ignore"):
            tt = opd / nd
        hitp = so[:, None, :] + tt[..., None] * w[:, None, :]
        ok = (np.abs(nd) >= 2e-6) & (tt >= 1e-6)
        for a, b in ((gv0, gv1), (gv1, gv2), (gv2, gv0)):
            m = np.cross(n_t, b - a)
            ok &= ((hitp - a[None]) * m[None]).sum(-1) >= 1e-9
        truth = ok.any(-1) & act[l].numpy()
        found += int(truth.sum())
        missed = truth & ~flag[l]
        assert not missed.any(), f"{route} missed {missed.sum()} glass lanes"
    assert found > 0


def tunnel_scene_dict():
    """tests/test_lane_compact.py's tunnel: a tilted glass pane beyond the
    light bends extended shadow rays into a ceiling within the light
    distance, so the uncapped walk shades the floor as occluded."""
    big, z_glass = 20.0, 4.0
    return {
        "settings": {"background_color": [0, 0, 0],
                     "image_settings": {"width": 32, "height": 32}},
        "camera": {"position": [0, 0, 1.0],
                   "matrix": [1, 0, 0, 0, 1, 0, 0, 0, 1]},
        "lights": [{"position": [0, 0, 2.0], "intensity": 200}],
        "materials": [
            {"type": "diffuse", "albedo": [1, 1, 1], "smooth_shading": False},
            {"type": "refractive", "ior": 1.5, "albedo": [1, 1, 1],
             "smooth_shading": False},
        ],
        "objects": [
            {"material_index": 0,
             "vertices": [-big, -big, 0.0, big, -big, 0.0,
                          big, big, 0.0, -big, big, 0.0],
             "triangles": [0, 1, 2, 0, 2, 3]},
            {"material_index": 1,
             "vertices": [-big, -big, z_glass - big, big, -big, z_glass + big,
                          big, big, z_glass + big, -big, big, z_glass - big],
             "triangles": [0, 1, 2, 0, 2, 3]},
            {"material_index": 0,
             "vertices": [-big, -big, 5.5, big, -big, 5.5,
                          big, big, 5.5, -big, big, 5.5],
             "triangles": [0, 2, 1, 0, 3, 2]},
        ],
    }


@pytest.mark.parametrize("scene_name", ["tunnel", "quads"])
@pytest.mark.parametrize("knob", ["router", "narrowing"])
def test_router_and_narrowing_equal_the_full_width_march(monkeypatch,
                                                         scene_name, knob):
    """Switching off the router (every active lane marches, at full width)
    or only the block narrowing changes no bit of the image."""
    if scene_name == "tunnel":
        scene = scene_from_dict(tunnel_scene_dict(), device="cpu")
    else:
        scene = make_test_scene(**_glass_scene(), device="cpu")
    settings = RenderSettings(max_ray_depth=3, wavefront="iter")
    with tracing.recording() as c:
        routed = render_image(scene, settings)
    syncs = tracing.total(c, "crt.host_reads.march")
    assert syncs > 0 and torch.isfinite(routed).all()
    monkeypatch.setattr(
        tshade, "_MARCH_SPLIT" if knob == "router" else "_MARCH_NARROW",
        False)
    with tracing.recording() as c:
        plain = render_image(scene, settings)
    assert torch.equal(routed, plain)
    # the narrowing costs one host read per shadow pass (the block gather)
    assert tracing.total(c, "crt.host_reads.march") < syncs
    if scene_name == "tunnel":
        # the tunnel does shadow the floor: beyond-the-light glass counts
        lit = render_image(scene, settings.replace(compat_no_shadows=True))
        assert ((lit - routed).abs().amax(dim=-1) > 1e-6).any()


def test_tunnel_scene_matches_crt_tpu():
    data = tunnel_scene_dict()
    ref = np.asarray(crt_tpu.render_image(
        crt_tpu.scene_from_dict(data, build_accel=False),
        crt_tpu.RenderSettings(backend="bruteforce", wavefront="iter")))
    img = render_image(scene_from_dict(data, device="cpu"),
                       RenderSettings(wavefront="iter"))
    np.testing.assert_allclose(img.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_march_table_matches_the_scene():
    scene = make_test_scene(**_glass_scene(), device="cpu")
    tab = tshade.march_table(scene)
    assert tab.shape == (5, scene.num_triangles) and not tab.requires_grad
    mat = scene.tri_material.long()
    np.testing.assert_array_equal(
        tab[3].numpy(), (scene.mat_type[mat] == MATERIAL_REFRACTIVE).numpy())
    np.testing.assert_array_equal(tab[4].numpy(), scene.mat_ior[mat].numpy())
    np.testing.assert_allclose(tab[:3].norm(dim=0).numpy(), 1.0, atol=1e-6)
    js = jmake_test_scene(**_glass_scene())
    np.testing.assert_array_equal(scene.mat_type.numpy(),
                                  np.asarray(js.mat_type))
    assert scene.has_refractive == js.has_refractive is True
    assert scene.refractions_on == js.refractions_on is True

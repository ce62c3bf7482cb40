"""AOVs of crt_tpu_torch (``render_aov``, ``hit_attributes(force_all=)``)
vs crt_tpu's.

The JAX side runs in process and eagerly (``jit=False``, as in
tests/test_torch_grad.py): eager XLA contracts no multiply-add, so the
all-pairs trace takes the same triangle on the floor's shared diagonal as
the port's backends.  The scene is make_test_scene_dict's with its floor
textured by docs/previews/12-01-textures.jpg, so "albedo" samples a
bitmap.  Tolerances:
  - ``tri_id`` and the packed table: exact;
  - the other AOVs: rtol 1e-5 / atol 1e-6, the image tolerance of
    tests/test_torch_render.py (equal bit for bit when this was written);
  - the streaming backend and the iterative wavefront vs the cluster
    backend: bit for bit (the same hits, the same arithmetic);
  - the depth and albedo AOVs' gradients vs jax.grad:
    tests/test_torch_grad.py's rtol 1e-5 / atol 2e-6 of the group's
    largest entry.
"""

import functools
import pathlib

import numpy as np
import pytest
import torch

import crt_tpu
from crt_tpu.ops import shade as jshade
from crt_tpu.scene import json_loader as jloader
from crt_tpu_torch import RenderSettings, render_aov, render_image
from crt_tpu_torch import scene_from_dict
from crt_tpu_torch.ops import shade as tshade
from crt_tpu_torch.renderer import AOVS, make_trace_fn
from crt_tpu_torch.scene.procedural import make_test_scene_dict
from test_torch_grad import weights
from torch_port_fixtures import _one_torch_thread, _release_heap  # noqa: F401

PREVIEWS = pathlib.Path(__file__).resolve().parents[1] / "docs" / "previews"


def scene_dict(**kw):
    kw = dict(dict(width=64, height=48, num_quads=8), **kw)
    return make_test_scene_dict(floor_bitmap="12-01-textures.jpg", **kw)


@functools.lru_cache(maxsize=None)
def _scenes(gi=False):
    data = scene_dict(gi_on=gi)
    return (jloader.scene_from_dict(data, asset_root=str(PREVIEWS),
                                    build_accel=False),
            scene_from_dict(data, asset_root=str(PREVIEWS), device="cpu"))


@functools.lru_cache(maxsize=None)
def _crt_tpu_aov(aov):
    js, _ = _scenes()
    return np.asarray(crt_tpu.render_aov(
        js, crt_tpu.RenderSettings(backend="bruteforce"), aov, jit=False))


def test_aov_names_match_crt_tpu():
    import inspect

    src = inspect.getsource(crt_tpu.renderer._render_aov_flat)
    assert all(f'aov == "{a}"' in src for a in AOVS)
    assert len(AOVS) == src.count('aov == "')


@pytest.mark.parametrize("backend", ["cluster", "bruteforce"])
@pytest.mark.parametrize("aov", AOVS)
def test_aov_matches_crt_tpu(aov, backend):
    _, ts = _scenes()
    got = render_aov(ts, RenderSettings(backend=backend), aov)
    assert got.shape == (48, 64, 3) and got.dtype == torch.float32
    want = _crt_tpu_aov(aov)
    if aov == "tri_id":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    miss = (want == np.asarray(ts.background_color)).all(-1)
    assert 0 < miss.mean() < 1  # both hits and misses are in view


@pytest.mark.parametrize("aov", AOVS)
def test_aov_on_every_backend_and_wavefront(aov):
    """Only primary rays are traced: the streaming backend, the iterative
    wavefront and a GI scene give the cluster backend's AOV bit for bit,
    and render_image with ``settings.aov`` is render_aov."""
    _, ts = _scenes()
    base = render_aov(ts, RenderSettings(), aov)
    for st in (RenderSettings(backend="pallas_stream"),
               RenderSettings(backend="stream", wavefront="iter"),
               RenderSettings(wavefront="recursive", max_ray_depth=1)):
        assert torch.equal(render_aov(ts, st, aov), base), st
    _, gi = _scenes(gi=True)
    assert torch.equal(render_aov(gi, RenderSettings(), aov), base)
    assert torch.equal(render_image(ts, RenderSettings(aov=aov)), base)


def test_aov_defaults_and_unknown_names():
    _, ts = _scenes()
    bary = render_aov(ts, RenderSettings(), "bary")
    assert torch.equal(render_aov(ts), bary)
    assert torch.equal(render_aov(ts, RenderSettings(aov="depth")),
                       render_aov(ts, aov="depth"))
    with pytest.raises(ValueError, match="unknown aov"):
        render_aov(ts, RenderSettings(), "beauty")
    with pytest.raises(ValueError, match="unknown aov"):
        render_image(ts, RenderSettings(aov="nope"))


def test_tri_id_is_the_original_triangle_id():
    """The id is the scene's, not the cluster tables' Morton rank (which
    orders this scene's triangles otherwise)."""
    _, ts = _scenes()
    trace = make_trace_fn(ts, RenderSettings())
    assert not torch.equal(trace.rank,
                           torch.arange(ts.num_triangles,
                                        dtype=trace.rank.dtype))
    img = render_aov(ts, RenderSettings(), "tri_id")
    hit = render_aov(ts, RenderSettings(), "depth")[..., 0] > 0
    tid = (img[..., 0] * 255).round() + 256 * (img[..., 1] * 255).round()
    ref = render_aov(ts, RenderSettings(backend="bruteforce"), "tri_id")
    rtid = (ref[..., 0] * 255).round() + 256 * (ref[..., 1] * 255).round()
    assert torch.equal(tid[hit], rtid[hit])
    assert set(tid[hit].long().tolist()) >= {0, 1}  # the floor
    assert int(tid[hit].max()) >= 2  # and quads


def test_force_all_packs_and_computes_every_attribute():
    """hit_attributes(force_all=True) packs the normals and uvs whatever
    the materials need and gives crt_tpu's attributes."""
    data = make_test_scene_dict(32, 24, num_quads=4, with_reflective=False)
    for m in data["materials"]:
        m["smooth_shading"] = False
    js = jloader.scene_from_dict(data, build_accel=False)
    ts = scene_from_dict(data, device="cpu")
    assert not ts.any_smooth and 2 not in ts.texture_types_present
    small = tshade.build_packed(ts)
    full = tshade.build_packed(ts, force_all=True)
    assert full.shape[0] == small.shape[0] + 18
    np.testing.assert_array_equal(
        full.numpy(), np.asarray(jshade.build_packed(js, force_all=True)))
    from crt_tpu.ops import camera as jcamera
    from crt_tpu.ops import intersect as jintersect

    o, d = jcamera.generate_rays(js.cam_position, js.cam_rotation,
                                 js.cam_tan_half_fov, 32, 24)
    o, d = np.array(o).reshape(-1, 3), np.array(d).reshape(-1, 3)
    tri = jintersect.build_triangle_data(js.vertices, js.tri_vidx,
                                         js.mat_backface[js.tri_material])
    jhit = jintersect.closest_hit_bruteforce(tri, o, d)
    want = jshade.hit_attributes(js, o, d, jhit, force_all=True)
    from crt_tpu_torch.ops.intersect import Hit

    got = tshade.hit_attributes(
        ts, torch.from_numpy(o), torch.from_numpy(d),
        Hit(t=torch.from_numpy(np.asarray(jhit.t)),
            tri=torch.from_numpy(np.asarray(jhit.tri))), force_all=True)
    for f in ("valid", "t", "normal", "uv", "bary_u", "bary_v",
              "albedo_tex"):
        np.testing.assert_allclose(
            getattr(got, f).numpy(), np.asarray(getattr(want, f)),
            rtol=1e-5, atol=1e-6, err_msg=f)
    assert float(np.abs(np.asarray(want.uv)).max()) == 0  # no uvs given
    assert float(got.normal.abs().max()) > 0


@pytest.mark.parametrize("aov", ["depth", "albedo"])
def test_aov_grads_match_jax(aov):
    """value_and_grad of a weighted AOV sum vs jax.grad of crt_tpu's: the
    depth with respect to the vertices and the camera, the albedo with
    respect to the bitmap texels (the texture colours' backward)."""
    import jax
    import jax.numpy as jnp

    js, ts = _scenes()
    keys = (("vertices", "cam_position") if aov == "depth"
            else ("bitmap_data",))
    params = {k: getattr(ts, k).detach().clone().requires_grad_(True)
              for k in keys}
    img = render_aov(ts.replace(**params), RenderSettings(), aov)
    assert img.requires_grad
    loss = (img * torch.from_numpy(weights(tuple(img.shape)))).sum()
    loss.backward()
    st = crt_tpu.RenderSettings(backend="bruteforce")

    def jloss(p):
        a = crt_tpu.render_aov(js.replace(**p), st, aov, jit=False)
        return jnp.sum(a * jnp.asarray(weights(a.shape)))

    jv, jg = jax.value_and_grad(jloss)(
        {k: jnp.asarray(getattr(js, k)) for k in keys})
    np.testing.assert_allclose(float(loss.detach()), float(jv), rtol=1e-6)
    for k in keys:
        want = np.asarray(jg[k])
        assert np.abs(want).max() > 0, k
        np.testing.assert_allclose(params[k].grad.numpy(), want, rtol=1e-5,
                                   atol=2e-6 * float(np.abs(want).max()),
                                   err_msg=k)
    # without a tensor that requires grad, no graph
    assert not render_aov(ts, RenderSettings(), aov).requires_grad

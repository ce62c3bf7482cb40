"""Gradients of crt_tpu_torch.render_image vs jax.grad of crt_tpu's.

Both packages get the same scene (built by crt_tpu, carried across as
NumPy by ``scene_from_numpy``) and the same trainable arrays
(``params_from_numpy`` in, ``params_to_numpy(grads=True)`` out), render a
small frame and differentiate one weighted image sum with respect to six
parameter groups at once: vertices, light_intensity, light_position,
tex_color_a, cam_position, cam_rotation.  The port runs on CPU tensors
(plain versions of its kernels); the JAX side renders with ``jit=False``
as tests/test_grad_contract.py does, through its Pallas backend in
interpret mode or its bruteforce backend.

Tolerance: rtol 1e-5, atol 2e-6 times the largest entry of the reference
gradient of that group.  Eager JAX contracts no multiply-add, so the two
forwards agree to the last bits; what remains is the order in which each
backward sums a few hundred per-pixel f32 cotangents (scatter-add and
reductions there, ``index_add_`` and autograd's accumulation here), with
cancellation between pixels (observed: 2e-7 of the largest entry).  One
exception: against crt_tpu's interpret-mode Pallas backend the vertex
gradients get rtol 2e-3 / atol 1e-4 of the largest entry, the tolerance
tests/test_grad_contract.py gives that same pair of backends inside
crt_tpu.  The interpreted kernel runs jitted, XLA contracts its
multiply-adds, and pixels on the floor's shared diagonal (an exact-t tie)
go to the other of the two coplanar triangles; the port's own two backends
agree with each other and with crt_tpu's bruteforce backend.  The
finite-difference checks reuse test_grad_contract.py's scene, eps sweep
and per-group tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import crt_tpu
import crt_tpu.ops.pallas_trace as jpt
import crt_tpu.renderer as jrenderer
from crt_tpu.scene.json_loader import scene_from_dict as jscene_from_dict
from crt_tpu.scene.procedural import make_test_scene as jmake_test_scene
from crt_tpu_torch import RenderSettings, render_image
from crt_tpu_torch.ops import segsum
from crt_tpu_torch.ops import shade as tshade
from crt_tpu_torch.ops import texture as ttexture
from crt_tpu_torch.ops.cluster_tables import (
    build_cluster_tables,
    emit_rows_table,
)
from crt_tpu_torch.scene.convert import (
    params_from_numpy,
    params_to_numpy,
    scene_from_numpy,
)
from crt_tpu_torch.scene.types import SCENE_META_FIELDS, SCENE_TENSOR_FIELDS

GROUPS = ("vertices", "light_intensity", "light_position", "tex_color_a",
          "cam_position", "cam_rotation")
RTOL, ATOL_SCALE = 1e-5, 2e-6
TIE_RTOL, TIE_ATOL_SCALE = 2e-3, 1e-4  # vertices vs interpret-mode Pallas


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs one worker per core, and torch's
    default (a thread per core in every worker) oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def wall_scene_dict(width=24, height=16):
    """tests/test_grad_contract.py's scene: one huge quad filling the view
    and one light, so no pixel changes triangle under a small step."""
    return {
        "settings": {"background_color": [0, 0, 0],
                     "image_settings": {"width": width, "height": height}},
        "camera": {"matrix": [1, 0, 0, 0, 1, 0, 0, 0, 1],
                   "position": [0, 0, 3]},
        "materials": [{"type": "diffuse", "albedo": [0.7, 0.5, 0.3],
                       "smooth_shading": True}],
        "lights": [{"intensity": 800, "position": [1.0, 2.0, 2.0]}],
        "objects": [{"material_index": 0,
                     "vertices": [-50, -50, 0, 50, -50, 0, -50, 50, 0,
                                  50, 50, 0],
                     "triangles": [0, 1, 2, 2, 1, 3]}],
    }


def edge_scene_dict():
    """A smooth, edges-textured triangle at z = -1 whose corners and two
    edges pass exactly through pixel centres of an 8x8, 90-degree frame
    (centres sit at odd multiples of 1/8), over a background."""
    return {
        "settings": {"background_color": [0.1, 0.2, 0.3],
                     "image_settings": {"width": 8, "height": 8}},
        "camera": {"matrix": [1, 0, 0, 0, 1, 0, 0, 0, 1],
                   "position": [0, 0, 0]},
        "textures": [{"name": "e", "type": "edges",
                      "edge_color": [0.2, 0.8, 0.3],
                      "inner_color": [0.7, 0.7, 0.7], "edge_width": 0.1}],
        "materials": [{"type": "diffuse", "albedo": "e",
                       "smooth_shading": True}],
        "lights": [{"intensity": 50, "position": [0.5, 1.0, 1.0]}],
        "objects": [{"material_index": 0,
                     "vertices": [-0.375, -0.375, -1, 0.625, -0.375, -1,
                                  -0.375, 0.625, -1],
                     "triangles": [0, 1, 2]}],
    }


def carry(jscene):
    """The port's scene with crt_tpu's arrays, on the CPU."""
    arrays = {f: np.asarray(getattr(jscene, f)) for f in SCENE_TENSOR_FIELDS}
    meta = {f: getattr(jscene, f) for f in SCENE_META_FIELDS}
    return scene_from_numpy(arrays, meta, device="cpu")


def weights(shape):
    """Non-uniform pixel weights, so spatially varying effects register."""
    n = int(np.prod(shape))
    return (1.0 + 0.3 * np.cos(np.arange(n, dtype=np.float32))).reshape(
        shape).astype(np.float32)


def torch_value_and_grads(tscene, arrays, settings=None, square=False):
    params = params_from_numpy(arrays, device="cpu")
    img = render_image(tscene.replace(**params), settings)
    w = torch.from_numpy(weights(tuple(img.shape)))
    loss = ((img * img if square else img) * w).sum()
    loss.backward()
    return float(loss.detach()), params_to_numpy(params, grads=True)


def jax_value_and_grads(jscene, arrays, backend, square=False):
    settings = crt_tpu.RenderSettings(backend=backend)

    def loss(p):
        img = crt_tpu.render_image(jscene.replace(**p), settings, jit=False)
        w = jnp.asarray(weights(img.shape))
        return jnp.sum((img * img if square else img) * w)

    orig = jrenderer.make_trace_fn

    def patched(scn, st):
        if st.backend == "pallas":
            return jpt.make_pallas_trace_fn(scn, interpret=True)
        return orig(scn, st)

    jrenderer.make_trace_fn = patched
    try:
        value, grads = jax.value_and_grad(loss)(
            {k: jnp.asarray(v) for k, v in arrays.items()})
    finally:
        jrenderer.make_trace_fn = orig
    return float(value), {k: np.asarray(v) for k, v in grads.items()}


def assert_grads_close(got, want, ties=False):
    for k in want:
        assert np.isfinite(got[k]).all(), k
        assert got[k].shape == want[k].shape, k
        rtol, scale = RTOL, ATOL_SCALE
        if ties and k == "vertices":
            rtol, scale = TIE_RTOL, TIE_ATOL_SCALE
        np.testing.assert_allclose(
            got[k], want[k], rtol=rtol,
            atol=scale * float(np.abs(want[k]).max()), err_msg=k)


def trainable(jscene, groups=GROUPS):
    return {k: np.asarray(getattr(jscene, k)) for k in groups}


@pytest.mark.parametrize("name", ["default", "with_edges"])
@pytest.mark.parametrize("backends", [("auto", "pallas"),
                                      ("bruteforce", "bruteforce")])
def test_six_group_grads_match_jax(name, backends):
    jscene = jmake_test_scene(24, 16, num_quads=4,
                              with_edges=(name == "with_edges"))
    arrays = trainable(jscene)
    v, g = torch_value_and_grads(carry(jscene), arrays,
                                 RenderSettings(backend=backends[0]))
    jv, jg = jax_value_and_grads(jscene, arrays, backends[1])
    np.testing.assert_allclose(v, jv, rtol=1e-5)
    assert all(np.abs(jg[k]).max() > 0 for k in GROUPS)
    assert_grads_close(g, jg, ties=(backends[1] == "pallas"))


def test_cluster_and_bruteforce_grads_agree():
    """Same hit ids in, same differentiable recomputation out: the rows the
    closest-hit trace emits and the rows gathered at its ids give one
    gradient (``packed_rows_from_kernel`` vs ``packed_gather_ranked``)."""
    jscene = jmake_test_scene(24, 16, num_quads=4, with_edges=True)
    arrays = trainable(jscene)
    _, g = torch_value_and_grads(carry(jscene), arrays,
                                 RenderSettings(backend="auto"))
    _, gb = torch_value_and_grads(carry(jscene), arrays,
                                  RenderSettings(backend="bruteforce"))
    assert_grads_close(g, gb)


@pytest.mark.parametrize("path", ["kernel_rows", "ranked", "unranked"])
def test_batched_rays_read_through_the_adapters(monkeypatch, path):
    """A [2, R/2] ray batch reads the packed rows and the colour table
    through the same adapters as a flat [R] one: the segment sum runs once
    per read and the gradients are those of the flat batch."""
    from crt_tpu_torch.ops import camera
    from crt_tpu_torch.ops.intersect import Hit
    from crt_tpu_torch.renderer import make_tiler, make_trace_fn

    jscene = jmake_test_scene(24, 16, num_quads=4)
    tscene = carry(jscene)
    arrays = trainable(jscene, ("vertices", "tex_color_a"))
    sums = []
    real = segsum.segment_accumulate

    def counting(ids, g, num_segments):
        sums.append(tuple(g.shape))
        return real(ids, g, num_segments)

    monkeypatch.setattr(segsum, "segment_accumulate", counting)
    rx, ry, _ = make_tiler(tscene.height, tscene.width)
    o, d = camera.generate_rays(
        tscene.cam_position, tscene.cam_rotation, tscene.cam_tan_half_fov,
        tscene.width, tscene.height, rx, ry)
    trace = make_trace_fn(tscene, RenderSettings())
    hit, rows = trace.with_rows(o.contiguous(), d.contiguous())
    R = o.shape[0]
    w = torch.from_numpy(weights((R, 3)))

    def grads(batch):
        params = params_from_numpy(arrays, device="cpu")
        scene = tscene.replace(**params)
        attrs = tshade.hit_attributes(
            scene, o.reshape(batch + (3,)), d.reshape(batch + (3,)),
            Hit(t=hit.t.reshape(batch), tri=hit.tri.reshape(batch)),
            kernel_rows=rows if path == "kernel_rows" else None,
            rank=None if path == "unranked" else trace.rank)
        assert attrs.point.shape == batch + (3,)
        albedo = ttexture.sample_textures(
            scene, attrs.albedo_tex, attrs.uv, attrs.bary_u, attrs.bary_v)
        valid = attrs.valid[..., None]
        shaded = torch.where(valid, attrs.point * attrs.normal + albedo, 0.0)
        (shaded.reshape(R, 3) * w).sum().backward()
        return params_to_numpy(params, grads=True)

    flat = grads((R,))
    assert len(sums) == 2  # the packed rows and the colour rows
    batched = grads((2, R // 2))
    assert sums[2:] == sums[:2]
    assert (hit.tri >= 0).any() and (hit.tri < 0).any()
    for k in flat:
        assert np.abs(flat[k]).max() > 0, k
        np.testing.assert_allclose(batched[k], flat[k], rtol=1e-6,
                                   atol=1e-6 * np.abs(flat[k]).max(),
                                   err_msg=k)


def test_background_pixels_grads_match_jax():
    """Two quads over a mostly empty frame: miss lanes carry exactly zero
    cotangents and id -1, so dropping them changes nothing."""
    jscene = jmake_test_scene(32, 24, num_quads=2)
    arrays = trainable(jscene, ("vertices", "cam_position"))
    _, g = torch_value_and_grads(carry(jscene), arrays, square=True)
    _, jg = jax_value_and_grads(jscene, arrays, "bruteforce", square=True)
    assert_grads_close(g, jg)


def test_hits_on_edges_and_corners_stay_finite():
    """Pixel centres exactly on a triangle's corners and edges zero the
    barycentric cross products; their square roots must not poison the
    backward (safe_length), here or in crt_tpu."""
    jscene = jscene_from_dict(edge_scene_dict(), build_accel=False)
    arrays = trainable(jscene)
    tscene = carry(jscene)
    hit = render_image(tscene)[..., 0] != np.float32(0.1)
    assert 6 <= int(hit.sum()) < 64  # the triangle and the background
    _, g = torch_value_and_grads(tscene, arrays)
    _, jg = jax_value_and_grads(jscene, arrays, "bruteforce")
    assert_grads_close(g, jg)


FD_CASES = {
    # group: (flat indices, eps, rtol) as in tests/test_grad_contract.py
    "light_intensity": ([0], 1.0, 1e-2),
    "light_position": ([0, 1, 2], 1e-3, 1e-2),
    "tex_color_a": ([0, 1, 2], 1e-3, 1e-2),
    "vertices": (list(range(12)), 1e-3, 3e-2),
    "cam_position": ([0, 1, 2], 1e-4, 3e-2),
    "cam_rotation": ([0, 4, 8, 1], 1e-4, 3e-2),
}


@pytest.fixture(scope="module")
def wall():
    jscene = jscene_from_dict(wall_scene_dict(), build_accel=False)
    tscene = carry(jscene)
    arrays = trainable(jscene)
    _, grads = torch_value_and_grads(tscene, arrays)
    _, jgrads = jax_value_and_grads(jscene, arrays, "bruteforce")
    return tscene, arrays, grads, jgrads


def test_wall_grads_match_jax(wall):
    _, _, grads, jgrads = wall
    assert_grads_close(grads, jgrads)


@pytest.mark.parametrize("group", sorted(FD_CASES))
def test_wall_grads_match_finite_differences(wall, group):
    """Central differences with an eps sweep; each coordinate may pick its
    best step (f32 rounding noise trades against truncation error)."""
    tscene, arrays, grads, _ = wall
    indices, eps, rtol = FD_CASES[group]
    w = torch.from_numpy(weights((tscene.height, tscene.width, 3)))

    def loss(x):
        with torch.no_grad():
            img = render_image(tscene.replace(**{group: torch.from_numpy(x)}))
            return float((img * w).sum())

    x0 = arrays[group]
    for idx in indices:
        an = float(grads[group].ravel()[idx])
        errs = []
        for e in (eps, 3 * eps, 10 * eps):
            xp, xm = x0.copy(), x0.copy()
            xp.ravel()[idx] += np.float32(e)
            xm.ravel()[idx] -= np.float32(e)
            fd = (loss(xp) - loss(xm)) / (2 * e)
            errs.append((abs(an - fd), fd))
        err, fd = min(errs)
        assert err <= rtol * max(abs(an), abs(fd), 1e-3), (
            f"{group}[{idx}]: analytic={an} best fd={fd}")


def test_chunked_grads_equal_unchunked():
    """Chunks pad the wavefront with dead lanes and sum their backward
    into the same leaves: equal up to the order of that sum."""
    jscene = jmake_test_scene(48, 32, num_quads=6, seed=2)
    tscene = carry(jscene)
    arrays = trainable(jscene)
    v, g = torch_value_and_grads(tscene, arrays)
    for chunk in (1024, 1500):
        vc, gc = torch_value_and_grads(
            tscene, arrays, RenderSettings(chunk_pixels=chunk))
        np.testing.assert_allclose(vc, v, rtol=1e-6)
        assert_grads_close(gc, g)


def test_traces_see_detached_geometry():
    """Tables, emitted rows and the image of a scene whose tensors require
    grad: nothing the kernels read hangs off the autograd graph, and an
    image nobody differentiates carries no graph either."""
    jscene = jmake_test_scene(24, 16, num_quads=4)
    tscene = carry(jscene)
    params = params_from_numpy(trainable(jscene), device="cpu")
    scene = tscene.replace(**params)
    tables = build_cluster_tables(scene)
    assert not any(t.requires_grad for t in tables)
    assert not emit_rows_table(scene, tables).requires_grad
    assert render_image(scene).requires_grad
    assert not render_image(tscene).requires_grad
    with pytest.raises(ValueError, match="no gradient"):
        params_to_numpy(params, grads=True)
    np.testing.assert_array_equal(params_to_numpy(params)["vertices"],
                                  np.asarray(jscene.vertices))

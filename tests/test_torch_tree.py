"""The tree backend of crt_tpu_torch (``ops/traverse.py``) vs crt_tpu's.

- ``closest_hit_tree`` walks crt_tpu's own tree (carried across as NumPy)
  on camera rays, on seeded random rays and under an ``active`` mask,
  against crt_tpu's ``closest_hit_tree`` run in a subprocess whose XLA CPU
  target is capped below FMA (``--xla_cpu_max_isa=AVX``), as the kernel
  parity tests run it.  Tolerance: ``tri`` equal on >= 99.99 % of rays and
  ``t`` within rtol 1e-6 where ``tri`` agrees (observed: bit for bit).
- the port's tree against the port's all-pairs backend by
  tests/test_intersect.py's rule (the same misses and t, ids that differ on
  exact-t ties only);
- ``render_image(backend="tree")`` against crt_tpu's tree at 48x32, opaque
  and glass at rtol 1e-5 / atol 1e-6 (crt_tpu's render is jitted and XLA
  contracts multiply-adds), GI by test_torch_gi.py's pixel share;
- gradients against crt_tpu's (``jit=False``) at rtol 1e-3 / atol 1e-4 of
  the group's largest entry;
- the CLI's ``--backend tree``;
- the walk's wrapper (``traverse.walk``): on the CPU the plain lock-step
  walk with its counts, no kernel loaded; dtype, shape and contiguity
  refused before any build; no path on other devices.  The kernel itself
  is held to the plain walk on the card (``tests/test_torch_cuda.py``).
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
from crt_tpu.scene.procedural import make_test_scene as jmake_test_scene
from crt_tpu_torch import RenderSettings, render_image
from crt_tpu_torch.frontend import cli
from crt_tpu_torch.io.ppm import read_ppm
from crt_tpu_torch.ops import traverse
from crt_tpu_torch.ops.intersect import (
    build_triangle_data,
    closest_hit_bruteforce,
)
from crt_tpu_torch.renderer import make_trace_fn
from crt_tpu_torch.scene.convert import accel_from_numpy
from crt_tpu_torch.utils import trace as tracing
from crt_tpu_torch.scene.procedural import (
    make_big_scene,
    make_test_scene,
    make_test_scene_dict,
)
from test_torch_gi import _agree
from test_torch_grad import (
    carry,
    jax_value_and_grads,
    torch_value_and_grads,
    trainable,
)
from torch_port_fixtures import _one_torch_thread, _release_heap  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]

# (name, make_test_scene kwargs, or a make_big_scene soup)
WALK_SCENES = {
    "opaque": dict(width=64, height=32, num_quads=64, with_edges=True),
    "glass": dict(width=64, height=32, num_quads=16, with_refractive=True),
    "soup": dict(big=4096, width=64, height=32),
}
RANDOM_RAYS = 4096

# Runs in the subprocess: crt_tpu's trees and walks, saved to an .npz.
_REF_SCRIPT = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from crt_tpu import renderer
from crt_tpu.ops import camera
from crt_tpu.ops import traverse
from crt_tpu.scene.accel import build_accel_tree
from crt_tpu.scene.procedural import make_big_scene, make_test_scene
from crt_tpu.scene.types import AccelTree

FIELDS = ("node_min", "node_max", "node_children", "node_leaf_id",
          "leaf_tris", "leaf_node")
out_path, spec_path = sys.argv[1], sys.argv[2]
spec = json.load(open(spec_path))
res = {}
for name, kw in spec["scenes"].items():
    kw = dict(kw)
    if "big" in kw:
        s = make_big_scene(kw.pop("big"), build_accel=False, **kw)
    else:
        s = make_test_scene(**kw)
    accel = build_accel_tree(np.asarray(s.vertices), np.asarray(s.tri_vidx),
                             use_native=False)
    for f in FIELDS:
        res[f"{name}/accel/{f}"] = np.asarray(getattr(accel, f))
    for f in ("leaf_size", "num_nodes", "num_leaves"):
        res[f"{name}/accel/{f}"] = np.asarray(getattr(accel, f))
    res[name + "/vertices"] = np.asarray(s.vertices)
    res[name + "/tri_vidx"] = np.asarray(s.tri_vidx)
    bf = np.asarray(s.mat_backface[s.tri_material])
    res[name + "/backface"] = bf
    # the gather is built eagerly (one XLA op at a time); the walk is one
    # compiled while_loop
    tri = traverse.build_triangle_gather(s.vertices, s.tri_vidx,
                                         jnp.asarray(bf))
    walk = jax.jit(lambda o, d, a: traverse.closest_hit_tree(accel, tri, o,
                                                             d, a))
    rx, ry, _ = renderer.make_tiler(s.height, s.width)
    o, d = camera.generate_rays(s.cam_position, s.cam_rotation,
                                s.cam_tan_half_fov, s.width, s.height, rx, ry)
    rng = np.random.default_rng(7)
    lo = np.asarray(s.vertices).min(0)
    hi = np.asarray(s.vertices).max(0)
    n = spec["random_rays"]
    ro = rng.uniform(lo - 1.0, hi + 1.0, (n, 3)).astype(np.float32)
    rd = rng.standard_normal((n, 3)).astype(np.float32)
    rd[: n // 8, 0] = 0.0      # axis-parallel rays: zero components of
    rd[n // 8: n // 4, 1] = -0.0  # both signs in the slab test
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    act = rng.uniform(size=o.shape[0]) < 0.6
    for wave, (wo, wd, wa) in {
            "camera": (o, d, None),
            "random": (jnp.asarray(ro), jnp.asarray(rd), None),
            "masked": (o, d, jnp.asarray(act))}.items():
        hit = walk(wo, wd, wa)
        res[f"{name}/{wave}/o"], res[f"{name}/{wave}/d"] = wo, wd
        if wa is not None:
            res[f"{name}/{wave}/active"] = wa
        res[f"{name}/{wave}/t"], res[f"{name}/{wave}/tri"] = hit.t, hit.tri
np.savez(out_path, **{k: np.asarray(v) for k, v in res.items()})
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_tree_ref")
    (tmp / "spec.json").write_text(json.dumps(
        {"scenes": WALK_SCENES, "random_rays": RANDOM_RAYS}))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX "
                         "--xla_cpu_multi_thread_eigen=false",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", _REF_SCRIPT, str(tmp / "ref.npz"),
         str(tmp / "spec.json")],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(tmp / "ref.npz") as z:
        return dict(z)


def T(a):
    return torch.from_numpy(np.array(a))


def _walker(ref, name):
    """The port's walk over crt_tpu's tree of scene ``name``."""
    accel = accel_from_numpy(
        {k.split("/")[-1]: v for k, v in ref.items()
         if k.startswith(name + "/accel/")}, device="cpu")
    tri = traverse.build_triangle_gather(
        T(ref[name + "/vertices"]), T(ref[name + "/tri_vidx"]),
        T(ref[name + "/backface"]))
    return accel, tri


@pytest.mark.parametrize("name", sorted(WALK_SCENES))
@pytest.mark.parametrize("wave", ["camera", "random", "masked"])
def test_closest_hit_tree_matches_crt_tpu(ref, name, wave):
    accel, tri = _walker(ref, name)
    p = f"{name}/{wave}"
    act = T(ref[p + "/active"]) if wave == "masked" else None
    hit = traverse.closest_hit_tree(accel, tri, T(ref[p + "/o"]),
                                    T(ref[p + "/d"]), act)
    want_tri, want_t = ref[p + "/tri"], ref[p + "/t"]
    same = hit.tri.numpy() == want_tri
    assert same.mean() >= 0.9999, f"{(~same).sum()} of {same.size} differ"
    np.testing.assert_allclose(hit.t.numpy()[same], want_t[same], rtol=1e-6)
    assert (want_tri >= 0).any() and (want_tri < 0).any()
    if act is not None:
        assert (hit.tri.numpy()[~act.numpy()] == -1).all()


@pytest.mark.parametrize("check_every", [1, 3])
def test_condition_reads_change_no_bit(ref, monkeypatch, check_every):
    """Reading the loop condition every k iterations (and dropping the
    finished lanes then), and leaf tests in pieces, change no bit."""
    accel, tri = _walker(ref, "soup")
    o, d = T(ref["soup/camera/o"]), T(ref["soup/camera/d"])
    base = traverse.closest_hit_tree(accel, tri, o, d)
    monkeypatch.setattr(traverse, "CHECK_EVERY", check_every)
    # leaf tests of at most 100 rays at a time
    monkeypatch.setattr(traverse, "GATHER_BYTES",
                        17 * 4 * accel.leaf_size * 100)
    with tracing.recording() as c:
        hit = traverse.closest_hit_tree(accel, tri, o, d)
    assert c["crt.tree.walks"] == 1
    assert c["crt.host_reads.tree_walk"] >= 3
    assert torch.equal(hit.tri, base.tri) and torch.equal(hit.t, base.t)


@pytest.mark.parametrize("kw", [dict(num_quads=16, with_edges=True),
                                dict(num_quads=6, with_refractive=True),
                                dict(big=4096)], ids=["opaque", "glass",
                                                      "soup"])
def test_tree_matches_bruteforce(kw):
    """The port's own tree and all-pairs backends find the same hits."""
    kw = dict(kw)
    if "big" in kw:
        scene = make_big_scene(kw.pop("big"), 64, 32, device="cpu")
    else:
        scene = make_test_scene(64, 32, device="cpu", **kw)
    from crt_tpu_torch.renderer import make_tiler
    from crt_tpu_torch.ops import camera

    rx, ry, _ = make_tiler(scene.height, scene.width, device="cpu")
    o, d = camera.generate_rays(scene.cam_position, scene.cam_rotation,
                                scene.cam_tan_half_fov, scene.width,
                                scene.height, rx, ry)
    hit = make_trace_fn(scene, RenderSettings(backend="tree"))(o, d)
    tri = build_triangle_data(
        scene.vertices, scene.tri_vidx,
        scene.mat_backface[scene.tri_material.long()])
    want = closest_hit_bruteforce(tri, o, d)
    # tests/test_intersect.py's rule: the same misses, the same t, ids that
    # differ only on exact-t ties (the floor's diagonal: the all-pairs dots
    # are matrix products, rounded in another order)
    hits = want.tri >= 0
    assert torch.equal(hit.tri >= 0, hits)
    np.testing.assert_allclose(hit.t[hits].numpy(), want.t[hits].numpy(),
                               rtol=1e-5, atol=1e-6)
    assert float((hit.tri == want.tri)[hits].float().mean()) > 0.99
    assert hits.any()


def test_tree_trace_needs_the_tree():
    scene = make_test_scene(32, 32, num_quads=4, device="cpu")
    with pytest.raises(ValueError, match="no acceleration tree"):
        make_trace_fn(scene.replace(accel=None),
                      RenderSettings(backend="tree"))
    trace = make_trace_fn(scene, RenderSettings(backend="tree"))
    assert trace.rank.shape == (scene.num_triangles,)


@pytest.mark.parametrize("kw", [dict(), dict(with_refractive=True)],
                         ids=["opaque", "glass"])
def test_tree_image_matches_crt_tpu(kw):
    jscene = jmake_test_scene(48, 32, num_quads=8, **kw)
    want = np.asarray(crt_tpu.render_image(
        jscene, crt_tpu.RenderSettings(backend="tree")))
    scene = make_test_scene(48, 32, num_quads=8, device="cpu", **kw)
    got = render_image(scene, RenderSettings(backend="tree")).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # and the port's tree frame is its cluster frame
    np.testing.assert_allclose(got, render_image(scene).numpy(), rtol=1e-5,
                               atol=1e-6)


def test_tree_gi_image_matches_crt_tpu():
    settings = dict(max_ray_depth=2, diffuse_reflection_ray_count=2)
    jscene = jmake_test_scene(48, 32, num_quads=8, gi_on=True)
    want = np.asarray(crt_tpu.render_image(
        jscene, crt_tpu.RenderSettings(backend="tree", **settings)))
    scene = make_test_scene(48, 32, num_quads=8, gi_on=True, device="cpu")
    got = render_image(scene, RenderSettings(backend="tree", **settings))
    _agree(got.numpy(), want)


@pytest.mark.parametrize("kw", [dict(), dict(with_refractive=True)],
                         ids=["opaque", "glass"])
def test_tree_grads_match_crt_tpu(kw):
    jscene = jmake_test_scene(24, 16, num_quads=4, with_edges=True, **kw)
    arrays = trainable(jscene)
    tree = {f: np.asarray(getattr(jscene.accel, f))
            for f in ("node_min", "node_max", "node_children", "node_leaf_id",
                      "leaf_tris", "leaf_node", "leaf_size", "num_nodes",
                      "num_leaves")}
    v, g = torch_value_and_grads(
        carry(jscene).replace(accel=accel_from_numpy(tree, device="cpu")),
        arrays, RenderSettings(backend="tree"))
    jv, jg = jax_value_and_grads(jscene, arrays, "tree")
    np.testing.assert_allclose(v, jv, rtol=1e-5)
    for k in jg:
        assert np.isfinite(g[k]).all(), k
        np.testing.assert_allclose(
            g[k], jg[k], rtol=1e-3, atol=1e-4 * float(np.abs(jg[k]).max()),
            err_msg=k)
    assert np.abs(g["vertices"]).max() > 0


def test_cli_backend_tree(tmp_path, capsys):
    scene_path = tmp_path / "scene.crtscene"
    scene_path.write_text(json.dumps(make_test_scene_dict(40, 24)))
    out = tmp_path / "out.ppm"
    assert cli.main([str(scene_path), str(out), "--device", "cpu",
                     "--backend", "tree"]) == 0
    assert "Execution time:" in capsys.readouterr().out
    text = out.read_text()
    assert text.startswith("P3\n40 24\n255\n")
    expected = render_image(make_test_scene(40, 24, device="cpu"),
                            RenderSettings(backend="tree")).numpy()
    np.testing.assert_array_equal(
        read_ppm(str(out)),
        np.clip(np.trunc(expected * np.float32(255)), 0, 255) / 255)


def _camera(scene):
    from crt_tpu_torch.ops import camera
    from crt_tpu_torch.renderer import make_tiler

    rx, ry, _ = make_tiler(scene.height, scene.width, device="cpu")
    return camera.generate_rays(scene.cam_position, scene.cam_rotation,
                                scene.cam_tan_half_fov, scene.width,
                                scene.height, rx, ry)


def _per_ray_leaf_tests(accel, o, d):
    """Leaf tests (leaves popped whose box the ray meets) of the
    reference's per-ray stack walk, ray by ray in float32 NumPy with the
    port's slab test."""
    lo, hi = accel.node_min.numpy(), accel.node_max.numpy()
    kids, leaf = accel.node_children.numpy(), accel.node_leaf_id.numpy()
    inv = traverse._inverse(d).numpy()
    leaves = 0
    for r in range(o.shape[0]):
        oo = o[r].numpy()
        stack = [0]
        while stack:
            n = stack.pop()
            t1, t2 = (lo[n] - oo) * inv[r], (hi[n] - oo) * inv[r]
            near = max(np.minimum(t1, t2).max(), np.float32(0.0))
            if np.maximum(t1, t2).min() < near:
                continue
            if leaf[n] >= 0:
                leaves += 1
            else:
                stack += [int(c) for c in kids[n] if c >= 0]
    return leaves


def test_walk_records_its_span_and_counter():
    from torch.profiler import ProfilerActivity, profile

    scene = make_test_scene(32, 16, num_quads=16, device="cpu")
    o, d = _camera(scene)
    trace = make_trace_fn(scene, RenderSettings(backend="tree"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.recording() as c:
            trace(o, d)
    assert sum(e.name == "crt.tree.walk" for e in prof.events()) == 1
    assert c["crt.tree.leaf_lanes"] > 0
    assert c["crt.tree.walks"] == 1


@pytest.mark.parametrize("masked", [False, True])
def test_leaf_lanes_equal_a_per_ray_walk(masked):
    scene = make_test_scene(32, 16, num_quads=16, with_edges=True,
                            device="cpu")
    o, d = _camera(scene)
    act = None
    if masked:
        act = torch.from_numpy(
            np.random.default_rng(3).uniform(size=o.shape[0]) < 0.5)
    trace = make_trace_fn(scene, RenderSettings(backend="tree"))
    with tracing.recording() as c:
        trace(o, d, act)
    keep = slice(None) if act is None else act
    leaves = _per_ray_leaf_tests(scene.accel, o[keep], d[keep])
    assert c["crt.tree.leaf_lanes"] == leaves > 0


def test_tree_frame_is_bit_equal_with_tracing_on_and_off():
    from torch.profiler import ProfilerActivity, profile

    scene = make_test_scene(48, 32, num_quads=16, device="cpu")
    settings = RenderSettings(backend="tree")
    off = render_image(scene, settings)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.recording() as c:
            on = render_image(scene, settings)
    assert torch.equal(on, off)
    # the camera walk, the mirror bounces' and the shadow walks; a call
    # with no active lane walks nothing
    walks = sum(e.name == "crt.tree.walk" for e in prof.events())
    assert 2 < walks <= c["crt.tree.walks"]


def test_counting_adds_no_host_read_and_nothing_while_off():
    """The walk's host reads stay one a leaf list and one a loop
    condition (and one for an ``active`` mask); its counter is a host int,
    so the walk runs the same torch ops with tracing on and off."""
    import collections

    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[func.__name__.split(".")[0]] += 1
            return func(*args, **(kwargs or {}))

    scene = make_test_scene(32, 16, num_quads=16, device="cpu")
    o, d = _camera(scene)
    act = o[:, 0] >= 0  # every lane, through the mask
    trace = make_trace_fn(scene, RenderSettings(backend="tree"))
    with Ops() as off:
        want = trace(o, d, act)
    with tracing.recording() as c, Ops() as on:
        got = trace(o, d, act)
    assert torch.equal(got.t, want.t) and torch.equal(got.tri, want.tri)
    it = c["crt.tree.iterations"]
    assert c["crt.host_reads.tree_walk"] == 1 + it + it // traverse.CHECK_EVERY
    assert on.ops == off.ops


def _no_build(monkeypatch):
    """Fail the test if anything loads the CUDA kernels."""
    from crt_tpu_torch.ops import cuda_lib

    def load():
        raise AssertionError("the CUDA library was loaded")

    monkeypatch.setattr(cuda_lib, "load", load)


def _small_walk():
    scene = make_test_scene(32, 16, num_quads=16, device="cpu")
    o, d = _camera(scene)
    tri = traverse.build_triangle_gather(
        scene.vertices, scene.tri_vidx,
        scene.mat_backface[scene.tri_material.long()])
    return scene.accel, tri, o.contiguous(), d.contiguous()


@pytest.mark.parametrize("masked", [False, True])
def test_cpu_walk_is_the_plain_walk(monkeypatch, masked):
    """On the CPU ``walk`` takes the lock-step walk, with its counts, and
    loads no kernel."""
    _no_build(monkeypatch)
    accel, tri, o, d = _small_walk()
    act = (torch.arange(o.shape[0]) % 3 != 0) if masked else None
    with tracing.recording() as c:
        t, hit_tri = traverse.walk(accel, tri, o, d, act)
    with tracing.recording() as p:
        want_t, want_tri = traverse.closest_hit_tree_plain(accel, tri, o, d,
                                                           act)
    assert torch.equal(hit_tri, want_tri) and torch.equal(t, want_t)
    assert (hit_tri >= 0).any()
    assert c == p
    assert c["crt.tree.walks"] == 1 and c["crt.tree.iterations"] > 0
    assert c["crt.host_reads.tree_walk"] > c["crt.tree.iterations"]
    assert c["crt.launches.tree_walk"] == 0


def _bad_walk_args(fault):
    """``walk``'s arguments with one ``fault``."""
    import dataclasses

    accel, tri, o, d = _small_walk()
    act = None
    if fault == "f64_origins":
        o = o.double()
    elif fault == "wide_dirs":
        d = torch.cat([d, d[:, :1]], dim=1)
    elif fault == "strided_dirs":
        d = torch.cat([d, d], dim=1)[:, ::2]
    elif fault == "short_dirs":
        d = d[:-1]
    elif fault == "int_active":
        act = torch.ones(o.shape[0], dtype=torch.int32)
    elif fault == "short_active":
        act = torch.ones(o.shape[0] - 1, dtype=torch.bool)
    elif fault == "tri_rows":
        tri = tri[:16]
    elif fault == "tri_transposed":
        tri = tri.T
    elif fault == "int64_children":
        accel = dataclasses.replace(accel,
                                    node_children=accel.node_children.long())
    elif fault == "strided_boxes":
        accel = dataclasses.replace(
            accel, node_min=torch.cat([accel.node_min] * 2, 1)[:, ::2])
    elif fault == "flat_leaves":
        accel = dataclasses.replace(accel,
                                    leaf_tris=accel.leaf_tris.reshape(-1))
    return accel, tri, o, d, act


@pytest.mark.parametrize("fault", [
    "f64_origins", "wide_dirs", "strided_dirs", "short_dirs", "int_active",
    "short_active", "tri_rows", "tri_transposed", "int64_children",
    "strided_boxes", "flat_leaves"])
def test_walk_rejects_what_the_kernel_does_not_take(monkeypatch, fault):
    """The wrapper checks dtype, shape and contiguity before it would
    build or launch anything, on every device."""
    _no_build(monkeypatch)
    with pytest.raises(ValueError):
        traverse.walk(*_bad_walk_args(fault))


def test_walk_has_no_path_on_other_devices(monkeypatch):
    """A device that is neither the CPU nor a card raises; nothing falls
    back to the plain walk."""
    _no_build(monkeypatch)
    accel, tri, o, d = _small_walk()
    meta = accel.to("meta")
    with pytest.raises(NotImplementedError, match="no kernel"):
        traverse.walk(meta, tri.to("meta"), o.to("meta"), d.to("meta"))


def test_closest_hit_tree_takes_strided_rays():
    """The public entry flattens and copies what the wrapper would refuse:
    strided rays of any batch shape and a strided mask."""
    accel, tri, o, d = _small_walk()
    act = torch.arange(o.shape[0]) % 2 == 0
    want = traverse.closest_hit_tree(accel, tri, o, d, act)
    wide_o = torch.stack([o, o], dim=1)[:, 0].reshape(16, -1, 3)
    wide_d = torch.stack([d, d], dim=1)[:, 0].reshape(16, -1, 3)
    wide_a = torch.stack([act, act], dim=1)[:, 0].reshape(16, -1)
    assert not wide_d.is_contiguous()
    hit = traverse.closest_hit_tree(accel, tri, wide_o, wide_d, wide_a)
    assert hit.t.shape == wide_a.shape
    assert torch.equal(hit.tri.reshape(-1), want.tri)
    assert torch.equal(hit.t.reshape(-1), want.t)

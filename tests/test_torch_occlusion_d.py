"""The direction-form occlusion kernels (K5, K6) and the shadow dispatch.

``occlusion_d`` takes its plain PyTorch version on CPU tensors; here it is
held to ``_occluded_binned_compact`` (K5, through ``trace.shadow_apex`` of
``make_pallas_trace_fn(scene, interpret=True)`` and directly) and to
``occluded_pallas_flat(interpret=True)`` (K6), together with the ``apex``
mode of ``bin_rays`` that feeds K5, the order in which
``shade._occlusion_masks`` picks a shadow path, and the image the cluster
backend renders when the w form is switched off (``CRT_APEX_W=0``).

Tolerance: EXACT for lists and masks, inactive-lane conventions included
(K5 seeds nothing and masks dead tiles; K6 returns True on inactive
lanes).  The JAX side runs in a subprocess capped below FMA, as
tests/test_torch_trace_kernels.py explains, with ``CRT_APEX_W=0`` in its
environment (crt_tpu reads the flag at import).  The image: rtol 1e-5 /
atol 1e-6, tests/test_torch_render.py's tolerance.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from crt_tpu_torch import RenderSettings, render_image
from crt_tpu_torch.ops import binning as tbin
from crt_tpu_torch.ops import cluster_tables as tct
from crt_tpu_torch.ops import cluster_trace as ttr
from crt_tpu_torch.ops import shade as tshade
from crt_tpu_torch.ops.intersect import Hit
from crt_tpu_torch.scene.procedural import make_test_scene
from torch_port_fixtures import _one_torch_thread, _release_heap  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCENE = dict(width=96, height=64, num_quads=16, with_edges=True)
IMAGE_SCENE = dict(width=64, height=36)
SLACK = 0.02

# Runs in the subprocess: the JAX side, saved to an .npz.
_REF_SCRIPT = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
import crt_tpu
from crt_tpu import renderer
from crt_tpu.ops import camera, vecmath
from crt_tpu.ops import pallas_trace as pt
from crt_tpu.scene.procedural import make_test_scene

out_path, spec_path = sys.argv[1], sys.argv[2]
spec = json.load(open(spec_path))
SLACK = spec["slack"]
assert not pt._APEX_W
res = {}

s = make_test_scene(**spec["scene"])
rx, ry, _ = renderer.make_tiler(s.height, s.width)
o, d = camera.generate_rays(s.cam_position, s.cam_rotation,
                            s.cam_tan_half_fov, s.width, s.height, rx, ry)
R = o.shape[0]
tpl = R // 1024
tables = pt.build_cluster_tables(s)
trace = pt.make_pallas_trace_fn(s, interpret=True)
assert not hasattr(trace, "shadow_apex_w")
hit = trace(o, d)
valid = hit.tri >= 0
point = o + d * jnp.where(valid, hit.t, 0.0)[:, None]
shadow_o = point + jnp.asarray([[0.0, 1e-2, 0.0]], jnp.float32)
lights = s.light_position
Ll = lights.shape[0]
lv = lights[:, None, :] - point[None]
r2 = vecmath.length_squared(lv)
ldir = vecmath.safe_normalize(lv)
# light 1 lights only x > 0, and pixel tile 2 is off for both
act = jnp.stack([valid, valid & (point[:, 0] > 0)])
act = act & (jnp.arange(R) // 1024 != 2)[None]
res["shadow_o"], res["ldir"], res["r2"], res["act"] = shadow_o, ldir, r2, act
o_f = jnp.broadcast_to(shadow_o[None], (Ll, R, 3)).reshape(-1, 3)
d_f, r2_f, a_f = ldir.reshape(-1, 3), r2.reshape(-1), act.reshape(-1)
apex = jnp.repeat(lights, tpl, axis=0)


def planes(x):
    return x.reshape(-1, 1024, 3).swapaxes(1, 2)


cl, cnt = pt.bin_rays(tables, o_f, d_f, 1024, a_f, apex=apex,
                      apex_slack=SLACK)
res["apex_cl"], res["apex_cnt"] = cl[:, 0], cnt
res["k5"] = pt._occluded_binned_compact(
    tables, planes(shadow_o), planes(d_f), r2_f.reshape(-1, 1, 1024), cl,
    cnt, 1024, True, tile_mod=tpl).reshape(-1)
res["k5_e2e"] = trace.shadow_apex(shadow_o, ldir, r2, lights, act, SLACK)
res["k5_short"] = trace.shadow_apex(shadow_o[:100], ldir[:, :100],
                                    r2[:, :100], lights, act[:, :100], SLACK)

res["k6"] = pt.occluded_pallas_flat(tables, o_f, d_f, r2_f, a_f,
                                    interpret=True)
res["k6_all"] = pt.occluded_pallas_flat(tables, o_f, d_f, r2_f, None,
                                        interpret=True)
n = o_f.shape[0] - 100  # padded to a tile multiple by the factory
res["k6_e2e"] = trace.occluded_kernel(o_f[:n], d_f[:n], r2_f[:n], a_f[:n])
res["k6_e2e_all"] = trace.occluded_kernel(o_f[:n], d_f[:n], r2_f[:n])

# the image with the w form off: shadows through trace.shadow_apex (K5)
orig = renderer.make_trace_fn
renderer.make_trace_fn = lambda scn, st: pt.make_pallas_trace_fn(
    scn, interpret=True)
res["image"] = crt_tpu.render_image(
    make_test_scene(**spec["image_scene"]),
    crt_tpu.RenderSettings(backend="pallas"))
renderer.make_trace_fn = orig
np.savez(out_path, **{k: np.asarray(v) for k, v in res.items()})
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_occlusion_d_ref")
    spec = {"scene": SCENE, "image_scene": IMAGE_SCENE, "slack": SLACK}
    (tmp / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ, JAX_PLATFORMS="cpu", CRT_APEX_W="0",
               XLA_FLAGS="--xla_cpu_max_isa=AVX "
                         "--xla_cpu_multi_thread_eigen=false",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", _REF_SCRIPT, str(tmp / "ref.npz"),
         str(tmp / "spec.json")],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(tmp / "ref.npz") as z:
        return dict(z)


def T(a):
    return torch.from_numpy(np.array(a))


def eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.fixture(scope="module")
def scene():
    return make_test_scene(**SCENE, device="cpu")


@pytest.fixture(scope="module")
def tables(scene):
    return tct.build_cluster_tables(scene)


def _wave(ref, scene):
    """The flat two-light shadow wavefront of the reference run."""
    shadow_o, ldir = T(ref["shadow_o"]), T(ref["ldir"])
    r2, act = T(ref["r2"]), T(ref["act"])
    Ll, R = r2.shape
    lights = scene.light_position
    return dict(
        shadow_o=shadow_o, ldir=ldir, r2=r2, act=act, lights=lights,
        tpl=R // 1024, apex=lights.repeat_interleave(R // 1024, dim=0),
        o_f=shadow_o.expand(Ll, R, 3).reshape(-1, 3).contiguous(),
        d_f=ldir.reshape(-1, 3).contiguous(),
        r2_f=r2.reshape(-1).contiguous(), a_f=act.reshape(-1))


def test_bin_rays_apex_mode_matches_crt_tpu(ref, scene, tables):
    w = _wave(ref, scene)
    cl, cnt = tbin.bin_rays(tables, w["o_f"], w["d_f"], 1024, w["a_f"],
                            apex=w["apex"], apex_slack=SLACK)
    eq(cl, ref["apex_cl"])
    eq(cnt, ref["apex_cnt"])
    assert (cnt == 0).any() and (cnt > 0).any()
    # never looser than the generic frustum on the same wavefront
    _, gcnt = tbin.bin_rays(tables, w["o_f"], w["d_f"], 1024, w["a_f"])
    assert (cnt <= gcnt).all()


def test_occlusion_d_plain_matches_pallas(ref, scene, tables):
    """K5: direct on crt_tpu's lists (origin tiles stored once, tile_mod)
    and through the factory's shadow_apex, its generic fallback for a
    ragged R included."""
    w = _wave(ref, scene)
    cl, cnt = tbin.bin_rays(tables, w["o_f"], w["d_f"], 1024, w["a_f"],
                            apex=w["apex"], apex_slack=SLACK)
    ttr.occlusion_d_launches = 0
    occ = ttr.occlusion_d(tables, w["shadow_o"].contiguous(), w["d_f"],
                          w["r2_f"], cl, cnt, 1024, tile_mod=w["tpl"])
    assert ttr.occlusion_d_launches == 0  # CPU tensors: the plain version
    eq(occ, ref["k5"])
    # the same lanes with the origins written out per light
    full = ttr.occlusion_d(tables, w["o_f"], w["d_f"], w["r2_f"], cl, cnt)
    assert torch.equal(full, occ)
    # dead tiles are all False, inactive lanes of live tiles are not seeded
    dead = (cnt == 0).repeat_interleave(1024)
    assert not occ[dead].any()
    assert occ[~dead & ~w["a_f"]].any() and not occ[~dead & ~w["a_f"]].all()
    assert occ[w["a_f"]].any() and not occ[w["a_f"]].all()

    trace = ttr.make_cluster_trace_fn(scene)
    args = (w["shadow_o"], w["ldir"], w["r2"], w["lights"], w["act"], SLACK)
    eq(trace.shadow_apex(*args), ref["k5_e2e"])
    short = (w["shadow_o"][:100], w["ldir"][:, :100], w["r2"][:, :100],
             w["lights"], w["act"][:, :100], SLACK)
    eq(trace.shadow_apex(*short), ref["k5_short"])


def test_occlusion_d_exit_plain_matches_pallas(ref, scene, tables):
    """K6: the any-hit query over generic lists, with and without an
    active mask, direct and through the factory (ragged R, padded)."""
    w = _wave(ref, scene)
    cl, cnt = tbin.bin_rays(tables, w["o_f"], w["d_f"], 1024, w["a_f"])
    occ = ttr.occlusion_d(tables, w["o_f"], w["d_f"], w["r2_f"], cl, cnt,
                          exit=True, active=w["a_f"])
    eq(occ, ref["k6"])
    assert occ[~w["a_f"]].all()  # inactive lanes return True
    cl, cnt = tbin.bin_rays(tables, w["o_f"], w["d_f"], 1024)
    occ_all = ttr.occlusion_d(tables, w["o_f"], w["d_f"], w["r2_f"], cl, cnt,
                              exit=True)
    eq(occ_all, ref["k6_all"])

    trace = ttr.make_cluster_trace_fn(scene)
    assert not hasattr(trace, "occluded")
    n = w["o_f"].shape[0] - 100
    e2e = trace.occluded_kernel(w["o_f"][:n], w["d_f"][:n], w["r2_f"][:n],
                                w["a_f"][:n])
    eq(e2e, ref["k6_e2e"])
    eq(trace.occluded_kernel(w["o_f"][:n], w["d_f"][:n], w["r2_f"][:n]),
       ref["k6_e2e_all"])
    kernel = ttr.make_cluster_trace_fn(scene, use_occlusion_kernel=True)
    assert not hasattr(kernel, "occluded_kernel")
    assert torch.equal(kernel.occluded(w["o_f"][:n], w["d_f"][:n],
                                       w["r2_f"][:n], w["a_f"][:n]), e2e)


def test_k5_k6_and_closest_hit_agree_on_active_lanes(ref, scene):
    """Three answers to "is the light blocked": K5 on shaft lists, K6 on
    generic lists, and the closest hit with a t^2 <= r2 compare."""
    w = _wave(ref, scene)
    trace = ttr.make_cluster_trace_fn(scene)
    act = w["a_f"]
    k5 = trace.shadow_apex(w["shadow_o"], w["ldir"], w["r2"], w["lights"],
                           w["act"], SLACK).reshape(-1)
    k6 = trace.occluded_kernel(w["o_f"], w["d_f"], w["r2_f"], act)
    sh = trace(w["o_f"], w["d_f"], act)
    ch = sh.valid & (sh.t * sh.t <= w["r2_f"])
    assert torch.equal(k5[act], k6[act]) and torch.equal(k5[act], ch[act])
    # the w form answers the same question with |n.w| in its parallel test
    point = w["shadow_o"] - torch.tensor([0.0, 1e-2, 0.0])
    kw = trace.shadow_apex_w(point, w["shadow_o"], w["lights"], w["act"],
                             SLACK).reshape(-1)
    assert (kw[act] != k5[act]).float().mean() < 1e-3


def _fake_trace(calls, *offers, apex_w_result=None):
    """A trace that records which shadow path shading takes."""
    def trace(o, d, active=None):
        calls.append("trace")
        n = o.shape[:-1]
        return Hit(t=torch.full(n, float("inf")),
                   tri=torch.full(n, -1, dtype=torch.int32))

    def shadow_apex_w(point, shadow_o, lights, act, slack):
        calls.append("shadow_apex_w")
        return apex_w_result

    def occluded(o, d, r2, active=None):
        calls.append("occluded")
        return torch.zeros(r2.shape, dtype=torch.bool)

    def shadow_apex(shadow_o, ldir, r2, lights, act, slack):
        calls.append("shadow_apex")
        return torch.zeros(r2.shape, dtype=torch.bool)

    for name in offers:
        setattr(trace, name, locals()[name])
    return trace


def test_occlusion_masks_dispatch_order(scene):
    R = 64
    gen = np.random.default_rng(0)
    point = T(gen.normal(size=(R, 3)).astype(np.float32))
    normal = torch.tensor([0.0, 1.0, 0.0]).expand(R, 3)
    active = torch.ones(R, dtype=torch.bool)

    def taken(trace):
        calls.clear()
        lit, ldir, r2 = tshade._occlusion_masks(
            scene, trace, point, normal, scene.light_position, 1e-2, False,
            active)
        assert lit.shape == r2.shape == (2, R) and lit.all()
        return list(calls)

    calls = []
    every = ("shadow_apex_w", "occluded", "shadow_apex")
    blocked = torch.zeros((2, R), dtype=torch.bool)
    assert taken(_fake_trace(calls, *every, apex_w_result=blocked)) == [
        "shadow_apex_w"]
    # the w form declines (None): the any-hit query is next
    assert taken(_fake_trace(calls, *every)) == ["shadow_apex_w", "occluded"]
    assert taken(_fake_trace(calls, "occluded", "shadow_apex")) == ["occluded"]
    assert taken(_fake_trace(calls, "shadow_apex")) == ["shadow_apex"]
    assert taken(_fake_trace(calls)) == ["trace"]


def test_apex_w_switch(scene, monkeypatch):
    glass = make_test_scene(64, 32, num_quads=6, with_refractive=True,
                            device="cpu")
    on = ttr.make_cluster_trace_fn(glass)
    assert all(hasattr(on, n) for n in (
        "shadow_apex_w", "shadow_apex_w_glass", "refr_ray_hit_w",
        "shadow_apex", "occluded_kernel"))
    off = ttr.make_cluster_trace_fn(glass, apex_w=False)
    assert hasattr(off, "shadow_apex") and not any(hasattr(off, n) for n in (
        "shadow_apex_w", "shadow_apex_w_glass", "refr_ray_hit_w"))
    assert ttr._APEX_W  # CRT_APEX_W is unset here
    monkeypatch.setattr(ttr, "_APEX_W", False)
    assert not hasattr(ttr.make_cluster_trace_fn(scene), "shadow_apex_w")
    assert hasattr(ttr.make_cluster_trace_fn(scene, apex_w=True),
                   "shadow_apex_w")


def test_image_with_the_w_form_off_matches_crt_tpu(ref, monkeypatch):
    scene = make_test_scene(**IMAGE_SCENE, device="cpu")
    default = render_image(scene)
    calls = []
    real = ttr.occlusion_d

    def counting(*args, **kw):
        calls.append(kw.get("exit", False))
        return real(*args, **kw)

    monkeypatch.setattr(ttr, "_APEX_W", False)
    monkeypatch.setattr(ttr, "occlusion_d", counting)
    img = render_image(scene, RenderSettings(backend="cluster"))
    assert calls == [False] * 4  # one K5 pass per shading level
    np.testing.assert_allclose(img.numpy(), ref["image"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(img.numpy(), default.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_wrapper_checks_inputs(tables):
    L = tables.n.shape[0]
    o = torch.zeros((2048, 3))
    d = torch.zeros((2048, 3))
    r2 = torch.ones(2048)
    cl = torch.zeros((2, L), dtype=torch.int32)
    cnt = torch.zeros((2,), dtype=torch.int32)
    act = torch.arange(2048) % 2 == 0
    assert not ttr.occlusion_d(tables, o, d, r2, cl, cnt).any()
    assert torch.equal(ttr.occlusion_d(tables, o, d, r2, cl, cnt, exit=True,
                                       active=act), ~act)
    assert not ttr.occlusion_d(tables, o[:1024], d, r2, cl, cnt,
                               tile_mod=1).any()
    with pytest.raises(ValueError):
        ttr.occlusion_d(tables, o[:1024], d, r2, cl, cnt)  # no tile_mod
    with pytest.raises(ValueError):
        ttr.occlusion_d(tables, o, d, r2, cl, cnt, active=act)  # K5 + seed
    with pytest.raises(ValueError):
        ttr.occlusion_d(tables, o[:1024], d, r2, cl, cnt, tile_mod=1,
                        exit=True)
    with pytest.raises(ValueError):
        ttr.occlusion_d(tables, o, d, r2.double(), cl, cnt)
    with pytest.raises(ValueError):
        ttr.occlusion_d(tables, o, d, r2, cl, cnt, tile_rays=1000)
    with pytest.raises(ValueError):
        ttr.occlusion_d(tables, o, d, r2, cl, cnt, exit=True,
                        active=act.float())

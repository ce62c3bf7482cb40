"""The direction-form occlusion kernels (K5, K6) and the shadow dispatch.

``occlusion_d`` takes its plain PyTorch version on CPU tensors; here it is
held to ``_occluded_binned_compact`` (K5, through ``trace.shadow_apex`` of
``make_pallas_trace_fn(scene, interpret=True)`` and directly, and so
through ``ClusterTracer(shadow_kernel="d").shadow``) and to
``occluded_pallas_flat(interpret=True)`` (K6), together with the ``apex``
mode of ``bin_rays`` that feeds K5, the kernel each ``shadow_kernel``
of the cluster tracer takes for ``shade._occlusion_masks``, and the image
the cluster backend renders with the direction form (crt_tpu's
``CRT_APEX_W=0``).
Also the cases the kernels' batched walk and exits stress: lists of 58 to
150 clusters (``make_big_scene`` at 4,096 triangles, many staging
batches), the boundaries of the member test on a hand-built scene (t * t
== r2 exactly, hits at t = -0.0 and +0.0 with r2 = 0, |n.d| exactly at
PARALLEL_EPS and just below it), and K6 with every lane seeded and with
none.

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

from crt_tpu_torch import RenderSettings, render_image, scene_from_dict
from crt_tpu_torch import renderer
from crt_tpu_torch.ops import binning as tbin
from crt_tpu_torch.ops import camera, vecmath
from crt_tpu_torch.ops import cluster_tables as tct
from crt_tpu_torch.ops import cluster_trace as ttr
from crt_tpu_torch.ops import shade as tshade
from crt_tpu_torch.ops.intersect import Hit
from crt_tpu_torch.ops.tracer import Tracer
from crt_tpu_torch.renderer import make_tiler
from crt_tpu_torch.scene.procedural import make_big_scene, make_test_scene
from torch_port_fixtures import _one_torch_thread, _release_heap  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCENE = dict(width=96, height=64, num_quads=16, with_edges=True)
IMAGE_SCENE = dict(width=64, height=36)
SLACK = 0.02
BIG = (4096, 64, 32)  # make_big_scene: lists of 58-150 clusters


def big_wavefront():
    """The direction-form shadow wavefront behind the primary hits of
    make_big_scene(*BIG), built as the reference run's main one: shadow_o
    [R, 3], lights, and the flat d, r2 and active lanes (every hit)."""
    s = make_big_scene(*BIG, device="cpu")
    tables = tct.build_cluster_tables(s)
    o, d = _primary(s)
    t, tri, _ = ttr.closest_hit_plain(tables, o, d,
                                      *tbin.bin_rays(tables, o, d, 1024))
    valid = tri >= 0
    point = o + d * torch.where(valid, t, 0.0)[:, None]
    lv = s.light_position[:, None, :] - point[None]
    return dict(shadow_o=point + torch.tensor([0.0, 1e-2, 0.0]),
                lights=s.light_position,
                d_f=vecmath.safe_normalize(lv).reshape(-1, 3),
                r2_f=vecmath.length_squared(lv).reshape(-1),
                a_f=valid.expand(lv.shape[0], -1).reshape(-1))


def _primary(s):
    rx, ry, _ = make_tiler(s.height, s.width, device="cpu")
    o, d = camera.generate_rays(s.cam_position, s.cam_rotation,
                                s.cam_tan_half_fov, s.width, s.height, rx,
                                ry)
    return o.contiguous(), d.contiguous()


def boundary_case():
    """The member test's boundaries on the tie scene with B's winding
    reversed (tests/test_torch_stream_chunks.py): A (cluster 0, normal +z)
    and B (cluster 1, normal -z) overlap in z = -5.  Four tiles, each with
    the list given (``cl``, ``cnt``): 0, rays from the camera through the
    overlap, where A and B are hit at the same t, with r2 = t * t exactly
    on even lanes and the next float below it on odd ones (lists A, B);
    1 and 2, rays that start on the plane, where A's t is -0.0 and B's
    +0.0, with r2 = 0 on even lanes and 1 on odd ones (lists A alone, B
    alone); 3, rays from just above the plane with d = (0, 0, -e), |n.d|
    = e = PARALLEL_EPS on even lanes and the next float below it on odd
    ones, r2 = 4 (lists A, B).  Every third lane is inactive (K6's seed).
    Expected: blocked on every even lane of tiles 0 and 3, on no odd one,
    and on every lane of tiles 1 and 2."""
    from test_torch_stream_chunks import tie_scene_negzero

    spec, o, d = tie_scene_negzero()
    scene = scene_from_dict(spec, device="cpu")
    tables = tct.build_cluster_tables(scene)
    ids = tables.tri_id
    c_a = int(torch.nonzero(ids == 16)[0, 0])
    c_b = int(torch.nonzero(ids == 15)[0, 0])
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    even = torch.arange(1024) % 2 == 0
    both = torch.tensor([[c_a, c_b]] * 2, dtype=torch.int32)
    t, tri, _ = ttr.closest_hit_plain(tables, o[:1024], d[:1024], both[:1],
                                      torch.tensor([2], dtype=torch.int32))
    assert (tri == 16).all()
    tt = t * t
    r2_tie = torch.where(even, tt, torch.nextafter(tt, torch.zeros(())))
    r2_zero = torch.where(even, 0.0, 1.0)
    eps = torch.tensor(1e-6, dtype=torch.float32)
    ez = torch.where(even, eps, torch.nextafter(eps, torch.zeros(())))
    o_eps = o[:1024].clone()
    o_eps[:, 0] = o[1024:, 0]  # inside the overlap
    o_eps[:, 1] = o[1024:, 1]
    o_eps[:, 2] = -4.999999
    d_eps = torch.zeros((1024, 3))
    d_eps[:, 2] = -ez
    cl = torch.tensor([[c_a, c_b], [c_a, c_a], [c_b, c_b], [c_a, c_b]],
                      dtype=torch.int32)
    return dict(spec=spec,
                o=torch.cat([o[:1024], o[1024:], o[1024:], o_eps]),
                d=torch.cat([d[:1024], d[1024:], d[1024:], d_eps]),
                r2=torch.cat([r2_tie, r2_zero, r2_zero,
                              torch.full((1024,), 4.0)]),
                act=torch.arange(4096) % 3 != 0, cl=cl,
                cnt=torch.tensor([2, 1, 1, 2], dtype=torch.int32))

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
from crt_tpu.scene.json_loader import scene_from_dict
from crt_tpu.scene.procedural import make_big_scene, make_test_scene

out_path, spec_path, in_path = sys.argv[1], sys.argv[2], sys.argv[3]
spec = json.load(open(spec_path))
inp = dict(np.load(in_path))
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
# K6 with every lane seeded, and with none
res["k6_seeded"] = pt.occluded_pallas_flat(tables, o_f, d_f, r2_f,
                                           jnp.zeros_like(a_f),
                                           interpret=True)
res["k6_open"] = pt.occluded_pallas_flat(tables, o_f, d_f, r2_f,
                                         jnp.ones_like(a_f), interpret=True)

# lists longer than a staging batch: make_big_scene at 4,096 triangles
big = make_big_scene(*spec["big"], build_accel=False)
btab = pt.build_cluster_tables(big)
bso, bd_f, br2_f, ba_f, bl = (jnp.asarray(inp["big_" + k]) for k in (
    "shadow_o", "d_f", "r2_f", "a_f", "lights"))
btpl = bso.shape[0] // 1024
bo_f = jnp.tile(bso, (bl.shape[0], 1))
cl, cnt = pt.bin_rays(btab, bo_f, bd_f, 1024, ba_f,
                      apex=jnp.repeat(bl, btpl, axis=0), apex_slack=SLACK)
res["big_cnt"] = cnt
res["big_k5"] = pt._occluded_binned_compact(
    btab, planes(bso), planes(bd_f), br2_f.reshape(-1, 1, 1024), cl, cnt,
    1024, True, tile_mod=btpl).reshape(-1)
res["big_k6"] = pt.occluded_pallas_flat(btab, bo_f, bd_f, br2_f, ba_f,
                                        interpret=True)

# the member test's boundaries, on the lists given
bs = scene_from_dict(spec["boundary"], build_accel=False)
ttab = pt.build_cluster_tables(bs)
to, td, tr2, tact = (jnp.asarray(inp["bd_" + k]) for k in ("o", "d", "r2",
                                                            "act"))
res["bd_k5"] = pt._occluded_binned_compact(
    ttab, planes(to), planes(td), tr2.reshape(-1, 1, 1024),
    jnp.asarray(inp["bd_cl"])[:, None, :], jnp.asarray(inp["bd_cnt"]), 1024,
    True).reshape(-1)
res["bd_k6"] = pt.occluded_pallas_flat(ttab, to, td, tr2, tact,
                                       interpret=True)

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
    bd = boundary_case()
    spec = {"scene": SCENE, "image_scene": IMAGE_SCENE, "slack": SLACK,
            "big": BIG, "boundary": bd.pop("spec")}
    (tmp / "spec.json").write_text(json.dumps(spec))
    inputs = {"big_" + k: v.numpy() for k, v in big_wavefront().items()}
    inputs.update({"bd_" + k: v.numpy() for k, v in bd.items()})
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu", CRT_APEX_W="0",
               XLA_FLAGS="--xla_cpu_max_isa=AVX "
                         "--xla_cpu_multi_thread_eigen=false",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", _REF_SCRIPT, str(tmp / "ref.npz"),
         str(tmp / "spec.json"), str(tmp / "inputs.npz")],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(tmp / "ref.npz") as z:
        return dict(z, **inputs)


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
        point=shadow_o - torch.tensor([0.0, 1e-2, 0.0]),
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
    and through the cluster tracer's ``shadow`` with ``shadow_kernel="d"``
    (crt_tpu's ``shadow_apex``), its generic fallback for a ragged R
    included."""
    w = _wave(ref, scene)
    cl, cnt = tbin.bin_rays(tables, w["o_f"], w["d_f"], 1024, w["a_f"],
                            apex=w["apex"], apex_slack=SLACK)
    occ = ttr.occlusion_d(tables, w["shadow_o"].contiguous(), w["d_f"],
                          w["r2_f"], cl, cnt, 1024, tile_mod=w["tpl"])
    eq(occ, ref["k5"])
    # the same lanes with the origins written out per light
    full = ttr.occlusion_d(tables, w["o_f"], w["d_f"], w["r2_f"], cl, cnt)
    assert torch.equal(full, occ)
    # dead tiles are all False, inactive lanes of live tiles are not seeded
    dead = (cnt == 0).repeat_interleave(1024)
    assert not occ[dead].any()
    assert occ[~dead & ~w["a_f"]].any() and not occ[~dead & ~w["a_f"]].all()
    assert occ[w["a_f"]].any() and not occ[w["a_f"]].all()

    trace = ttr.make_cluster_trace_fn(scene, shadow_kernel="d")
    args = (w["point"], w["shadow_o"], w["lights"], w["ldir"], w["r2"],
            w["act"], SLACK)
    eq(trace.shadow(*args), ref["k5_e2e"])
    short = (w["point"][:100], w["shadow_o"][:100], w["lights"],
             w["ldir"][:, :100], w["r2"][:, :100], w["act"][:, :100], SLACK)
    eq(trace.shadow(*short), ref["k5_short"])


def test_occlusion_d_exit_plain_matches_pallas(ref, scene, tables):
    """K6: the any-hit query over generic lists, with and without an
    active mask, direct and through the tracer (ragged R, padded), and as
    the shadow pass of ``shadow_kernel="anyhit"``."""
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
    assert trace.shadow_kernel == "w"
    n = w["o_f"].shape[0] - 100
    e2e = trace.occluded(w["o_f"][:n], w["d_f"][:n], w["r2_f"][:n],
                         w["a_f"][:n])
    eq(e2e, ref["k6_e2e"])
    eq(trace.occluded(w["o_f"][:n], w["d_f"][:n], w["r2_f"][:n]),
       ref["k6_e2e_all"])
    kernel = ttr.make_cluster_trace_fn(scene, shadow_kernel="anyhit")
    eq(kernel.shadow(w["point"], w["shadow_o"], w["lights"], w["ldir"],
                     w["r2"], w["act"], SLACK).reshape(-1), ref["k6"])


def test_k5_k6_and_closest_hit_agree_on_active_lanes(ref, scene):
    """Three answers to "is the light blocked": K5 on shaft lists, K6 on
    generic lists, and the closest hit with a t^2 <= r2 compare."""
    w = _wave(ref, scene)
    trace = ttr.make_cluster_trace_fn(scene)
    act = w["a_f"]
    args = (w["point"], w["shadow_o"], w["lights"], w["ldir"], w["r2"],
            w["act"], SLACK)
    k5 = ttr.ClusterTracer(trace.tables, shadow_kernel="d").shadow(
        *args).reshape(-1)
    k6 = trace.occluded(w["o_f"], w["d_f"], w["r2_f"], act)
    sh = trace(w["o_f"], w["d_f"], act)
    ch = sh.valid & (sh.t * sh.t <= w["r2_f"])
    assert torch.equal(k5[act], k6[act]) and torch.equal(k5[act], ch[act])
    assert torch.equal(Tracer.shadow(trace, *args).reshape(-1), ch)
    # the w form answers the same question with |n.w| in its parallel test
    kw = trace.shadow(*args).reshape(-1)
    assert (kw[act] != k5[act]).float().mean() < 1e-3


class _ShadowRecorder(Tracer):
    """A tracer that records which shadow entry shading takes: the base
    class's (a closest hit, "trace") or its own ``shadow``."""

    def __init__(self, calls, own_shadow):
        self.calls, self.own_shadow = calls, own_shadow

    def __call__(self, o, d, active=None):
        self.calls.append("trace")
        n = o.shape[:-1]
        return Hit(t=torch.full(n, float("inf")),
                   tri=torch.full(n, -1, dtype=torch.int32))

    def shadow(self, point, shadow_o, lights, ldir, r2, act, slack):
        if not self.own_shadow:
            return super().shadow(point, shadow_o, lights, ldir, r2, act,
                                  slack)
        self.calls.append("shadow")
        return torch.zeros(r2.shape, dtype=torch.bool)


@pytest.mark.parametrize("R", [64, 2048])
def test_occlusion_masks_dispatch_order(scene, R, monkeypatch):
    """Shading asks the tracer for its shadow pass and nothing else; the
    cluster tracer's ``shadow_kernel`` picks K2, K5 or K6 where the
    wavefront is a flat one of whole tiles, and the closest hit where it
    is not (K6 takes any wavefront)."""
    gen = np.random.default_rng(0)
    point = T(gen.normal(size=(R, 3)).astype(np.float32))
    normal = torch.tensor([0.0, 1.0, 0.0]).expand(R, 3)
    active = torch.ones(R, dtype=torch.bool)

    def taken(trace):
        calls.clear()
        lit, ldir, r2 = tshade._occlusion_masks(
            scene, trace, point, normal, scene.light_position, 1e-2, False,
            active)
        assert lit.shape == r2.shape == (2, R)
        return list(calls)

    calls = []
    assert taken(_ShadowRecorder(calls, True)) == ["shadow"]
    assert taken(_ShadowRecorder(calls, False)) == ["trace"]

    for name in ("closest_hit", "occlusion_w", "occlusion_d"):
        def counting(*args, _name=name, _real=getattr(ttr, name), **kw):
            calls.append(_name + ("/exit" if kw.get("exit") else ""))
            return _real(*args, **kw)

        monkeypatch.setattr(ttr, name, counting)
    whole = R % 1024 == 0
    want = {"w": "occlusion_w" if whole else "closest_hit",
            "d": "occlusion_d" if whole else "closest_hit",
            "anyhit": "occlusion_d/exit"}
    lights = scene.light_position
    lv = lights[:, None, None, :] - point[None, None]
    batched = (point[None], point[None], lights, vecmath.safe_normalize(lv),
               vecmath.length_squared(lv), active.expand(2, 1, R), SLACK)
    for kind, kernel in want.items():
        tracer = ttr.make_cluster_trace_fn(scene, shadow_kernel=kind)
        assert taken(tracer) == [kernel]
        # a wavefront that is not flat ([1, R] points) takes the closest
        # hit, but in K6
        calls.clear()
        assert tracer.shadow(*batched).shape == (2, 1, R)
        assert calls == [
            "occlusion_d/exit" if kind == "anyhit" else "closest_hit"]


def test_apex_w_switch(scene):
    """The glass router exists only with the w form on a glass scene."""
    glass = make_test_scene(64, 32, num_quads=6, with_refractive=True,
                            device="cpu")
    R = 2048
    point = torch.zeros((R, 3))
    args = (point, point, glass.light_position,
            torch.ones((2, R), dtype=torch.bool), SLACK)
    on = ttr.make_cluster_trace_fn(glass)
    assert on.shadow_kernel == "w" and on.emits_rows
    assert on.shadow_glass(*args) is not None
    for kind in ("d", "anyhit"):
        off = ttr.make_cluster_trace_fn(glass, shadow_kernel=kind)
        assert off.shadow_glass(*args) is None
    assert ttr.make_cluster_trace_fn(scene).shadow_glass(*args) is None
    assert ttr.ClusterTracer(on.tables).shadow_glass(*args) is None
    with pytest.raises(ValueError):
        ttr.make_cluster_trace_fn(scene, shadow_kernel="apex")


def test_image_with_the_w_form_off_matches_crt_tpu(ref, monkeypatch):
    scene = make_test_scene(**IMAGE_SCENE, device="cpu")
    default = render_image(scene)
    calls = []
    real = ttr.occlusion_d

    def counting(*args, **kw):
        calls.append(kw.get("exit", False))
        return real(*args, **kw)

    monkeypatch.setattr(renderer, "make_trace_fn",
                        lambda scn, st: ttr.make_cluster_trace_fn(
                            scn, shadow_kernel="d"))
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


def test_k6_every_lane_seeded_and_none(ref, scene, tables):
    """K6 with every lane seeded (all True, on lists binned for no lane)
    and with none seeded (the full any-hit answer on every lane)."""
    w = _wave(ref, scene)
    for name, act in (("k6_seeded", torch.zeros_like(w["a_f"])),
                      ("k6_open", torch.ones_like(w["a_f"]))):
        cl, cnt = tbin.bin_rays(tables, w["o_f"], w["d_f"], 1024, act)
        occ = ttr.occlusion_d(tables, w["o_f"], w["d_f"], w["r2_f"], cl, cnt,
                              exit=True, active=act)
        eq(occ, ref[name])
    assert ref["k6_seeded"].all() and not ref["k6_open"].all()
    assert ref["k6_open"].any()


def test_lists_longer_than_a_batch_match_pallas(ref):
    """K5 (shaft lists, tile_mod) and K6 (generic lists, seeded) on
    make_big_scene(4096) at 64x32: lists of tens to hundreds of clusters,
    walked by the kernels in many staging batches."""
    b = {k[4:]: T(v) for k, v in ref.items() if k.startswith("big_")}
    tables = tct.build_cluster_tables(make_big_scene(*BIG, device="cpu"))
    Ll, tpl = b["lights"].shape[0], b["shadow_o"].shape[0] // 1024
    o_f = b["shadow_o"].repeat(Ll, 1)
    cl, cnt = tbin.bin_rays(tables, o_f, b["d_f"], 1024, b["a_f"],
                            apex=b["lights"].repeat_interleave(tpl, dim=0),
                            apex_slack=SLACK)
    eq(cnt, b["cnt"])
    assert int(cnt.min()) > 8 * 3  # past a batch and the staging ring
    k5 = ttr.occlusion_d(tables, b["shadow_o"], b["d_f"], b["r2_f"], cl, cnt,
                         tile_mod=tpl)
    eq(k5, b["k5"])
    gl, gcnt = tbin.bin_rays(tables, o_f, b["d_f"], 1024, b["a_f"])
    assert int(gcnt.max()) > int(cnt.max())
    k6 = ttr.occlusion_d(tables, o_f, b["d_f"], b["r2_f"], gl, gcnt,
                         exit=True, active=b["a_f"])
    eq(k6, b["k6"])
    act = b["a_f"]
    assert k5[act].any() and not k5[act].all()
    assert torch.equal(k5[act], k6[act])


@pytest.mark.parametrize("exit", [False, True])
def test_member_test_boundaries_match_pallas(ref, exit):
    """t * t == r2 exactly, t = -0.0 and +0.0 with r2 = 0, and |n.d| at
    PARALLEL_EPS: K5 on the lists given (boundary_case) and K6 on the
    generic lists, equal to crt_tpu's kernels and to the expected
    pattern."""
    bd = boundary_case()
    scene = scene_from_dict(bd["spec"], device="cpu")
    tables = tct.build_cluster_tables(scene)
    o, d, r2, act = (T(ref["bd_" + k]) for k in ("o", "d", "r2", "act"))
    if exit:
        cl, cnt = tbin.bin_rays(tables, o, d, 1024, act)
        occ = ttr.occlusion_d(tables, o, d, r2, cl, cnt, exit=True,
                              active=act)
        eq(occ, ref["bd_k6"])
        assert occ[~act].all()
    else:
        cl, cnt = T(ref["bd_cl"]), T(ref["bd_cnt"])
        occ = ttr.occlusion_d(tables, o, d, r2, cl, cnt)
        eq(occ, ref["bd_k5"])
    lane = torch.arange(4096)
    even = lane % 2 == 0
    tile = lane // 1024
    want = torch.where((tile == 1) | (tile == 2), True, even)
    mine = act if exit else torch.ones_like(act)
    assert torch.equal(occ[mine], want[mine])

"""The port's span and counter registry (``crt_tpu_torch/utils/trace.py``).

With tracing off no span enters ``record_function`` and no counter moves;
under a CPU ``torch.profiler`` a frame and a fit emit the spans of the
layers, each inside its parent; the shading pool's lane counters, and a
glass frame's march and refraction counters, equal a brute count; the
transmissive march's span holds its glass-flag pass; the image and the
fit come out bit for bit the same with tracing on and off.  The counters of the kernels' wrappers, the Phase A
pairs and the host-read sites are cases of one parametrised test each.
"""

import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from crt_tpu_torch import RenderSettings, render_aov, render_image
from crt_tpu_torch import scene_from_dict
from crt_tpu_torch.ops import (
    binning,
    camera,
    cluster_tables,
    cluster_trace,
    segsum,
    shade,
    stream_binning,
    stream_trace,
)
from crt_tpu_torch.optim import fit_scene
from crt_tpu_torch.renderer import _render_flat, make_tiler, make_trace_fn
from crt_tpu_torch.scene.procedural import (
    make_test_scene,
    make_test_scene_dict,
)
from crt_tpu_torch.scene.types import MATERIAL_REFRACTIVE
from crt_tpu_torch.utils import trace as tracing
from torch_port_fixtures import _one_torch_thread, _release_heap  # noqa: F401

GI = RenderSettings(max_ray_depth=2, diffuse_reflection_ray_count=2,
                    chunk_pixels=2048)  # two chunks of the 64 x 64 tiles


@pytest.fixture(autouse=True)
def _fresh_counters():
    tracing.reset()
    yield
    tracing.reset()


def gi_scene():
    return make_test_scene(64, 48, 8, gi_on=True, device="cpu")


def fit_two_steps(scene):
    target = torch.full((scene.height, scene.width, 3), 0.25)
    return fit_scene(scene, target, steps=2)


def profiled(fn):
    """(fn(), [(name, start, end)] of the crt. spans it recorded)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [(e.name, e.time_range.start, e.time_range.end)
                 for e in prof.events() if e.name.startswith("crt.")]


def named(events, name):
    return [(s, e) for n, s, e in events if n == name]


def inside(events, child, parents):
    """Every interval of ``child`` lies in one of a ``parents`` span's."""
    outer = [iv for p in parents for iv in named(events, p)]
    kids = named(events, child)
    return bool(kids) and all(any(ps <= cs and ce <= pe for ps, pe in outer)
                              for cs, ce in kids)


# -- tracing off -------------------------------------------------------------

def test_off_enters_no_record_function_and_counts_nothing(monkeypatch):
    def entered(name):
        raise AssertionError(f"record_function({name!r}) with tracing off")

    monkeypatch.setattr(tracing, "record_function", entered)
    assert not tracing.enabled()
    render_image(gi_scene(), GI)
    glass = make_test_scene(64, 48, 8, with_refractive=True, device="cpu")
    render_image(glass, RenderSettings(max_ray_depth=3))
    render_image(gi_scene(), RenderSettings(backend="stream"))
    render_aov(gi_scene(), RenderSettings(), "depth")
    fit_two_steps(make_test_scene(64, 48, 8, device="cpu"))
    assert tracing.counters() == {}


# -- spans -------------------------------------------------------------------

def _gi_frame():
    return render_image(gi_scene(), GI)


def _stream_frame():
    return render_image(gi_scene(), RenderSettings(backend="stream"))


def _aov_frame():
    return render_aov(gi_scene(), RenderSettings(), "depth")


def _fit():
    return fit_two_steps(make_test_scene(64, 48, 8, device="cpu"))


SPAN_CASES = {
    # case: (run, {child: parents})
    "gi": (_gi_frame, {
        "crt.tables.cluster": ["crt.frame"],
        "crt.shade": ["crt.frame"],
        **{f"crt.shade.bounce.{b}": ["crt.shade"] for b in range(3)},
        "crt.trace.primary": ["crt.shade.bounce.0"],
        "crt.trace": [f"crt.shade.bounce.{b}" for b in range(3)],
        "crt.trace.shadow": [f"crt.shade.bounce.{b}" for b in range(3)],
        "crt.binning": ["crt.trace.primary", "crt.trace",
                        "crt.trace.shadow"],
    }),
    "stream": (_stream_frame, {
        "crt.tables.cluster": ["crt.frame"],
        "crt.tables.stream": ["crt.frame"],
        "crt.shade": ["crt.frame"],
        "crt.trace.primary": ["crt.shade"],
        "crt.trace": ["crt.shade"],
        "crt.trace.shadow": ["crt.shade"],
        "crt.binning": ["crt.trace.primary", "crt.trace",
                        "crt.trace.shadow"],
    }),
    "aov": (_aov_frame, {
        "crt.tables.cluster": ["crt.frame"],
        "crt.trace.primary": ["crt.frame"],
        "crt.binning": ["crt.trace.primary"],
    }),
    "fit": (_fit, {
        "crt.frame": ["crt.fit.forward"],
        "crt.tables.cluster": ["crt.frame"],
        "crt.shade": ["crt.frame"],
        "crt.trace.primary": ["crt.shade"],
        "crt.trace": ["crt.shade"],
        "crt.trace.shadow": ["crt.shade"],
        "crt.tables.rows": ["crt.trace.primary"],
        "crt.binning": ["crt.trace.primary", "crt.trace",
                        "crt.trace.shadow"],
    }),
}


@pytest.mark.parametrize("case", sorted(SPAN_CASES))
def test_spans_nest_under_the_profiler(case):
    run, tree = SPAN_CASES[case]
    _, ev = profiled(run)
    for child, parents in tree.items():
        assert inside(ev, child, parents), (child, parents)
    assert all(n.startswith("crt.") and not n.startswith(("bench.", "cu"))
               for n, _, _ in ev)
    if case == "gi":
        # two chunks, each its own shade span with one span a bounce
        assert len(named(ev, "crt.frame")) == 1
        assert len(named(ev, "crt.shade")) == 2
        for b in range(GI.max_ray_depth + 1):
            assert len(named(ev, f"crt.shade.bounce.{b}")) == 2
        assert not named(ev, f"crt.shade.bounce.{GI.max_ray_depth + 1}")
        assert len(named(ev, "crt.trace.primary")) == 2
        # the leaf children (K = 2) trace inside bounce D - 1
        leaf = named(ev, f"crt.shade.bounce.{GI.max_ray_depth - 1}")
        traces = [s for s, _ in named(ev, "crt.trace")
                  if any(a <= s <= b for a, b in leaf)]
        assert len(traces) >= 2 * (1 + GI.diffuse_reflection_ray_count)
    if case == "fit":
        for part in ("forward", "backward", "optimizer"):
            assert len(named(ev, f"crt.fit.{part}")) == 2
        (f0, _), (b0, b1), (o0, _) = (named(ev, f"crt.fit.{p}")[0] for p in
                                      ("forward", "backward", "optimizer"))
        assert f0 < b0 and b1 <= o0


# -- the shading pool's lanes -------------------------------------------------

class CountingTrace:
    """The backend, with a brute count of the lanes of every closest hit;
    in the iterative wavefront (no glass: shadows take the backend's
    ``shadow``, which forwards to the cluster tracer's K2 pass) each
    closest hit is one ``shade_local``'s."""

    def __init__(self, fn):
        self.fn, self.lanes, self.live = fn, 0, 0

    def __call__(self, o, d, active=None):
        self.lanes += active.numel()
        self.live += int(active.sum())
        return self.fn(o, d, active)

    def __getattr__(self, attr):
        return getattr(self.fn, attr)


@pytest.mark.parametrize("case", ["gi_grow", "gi_scan", "mirror_iter"])
def test_live_lanes_equal_a_brute_count(case):
    if case == "mirror_iter":
        scene = make_test_scene(64, 48, 8, device="cpu")
        st = RenderSettings(wavefront="iter", chunk_pixels=2048)
    else:
        scene = gi_scene()
        st = GI.replace(wavefront_sched=case[3:])
    brute = CountingTrace(make_trace_fn(scene, st))
    with tracing.recording() as c:
        _render_flat(scene, st, trace_fn=brute)
    assert c["crt.shade.lanes"] == brute.lanes > 0
    assert c["crt.shade.live_lanes"] == brute.live
    assert 0 < brute.live < brute.lanes


# -- a glass frame: the march and the refractive hits --------------------------

def glass_scene():
    """The quads with glass, and one more glass sheet close before the
    camera, turned 60 degrees about y with its back face to the camera:
    rays that meet it leave the glass past the critical angle (total
    internal reflection) or, at the frame's edge, refract."""
    d = make_test_scene_dict(64, 48, 16, with_refractive=True)
    glass = next(i for i, m in enumerate(d["materials"])
                 if m["type"] == "refractive")
    u, v = np.array([0.5, 0.0, 0.866]), np.array([0.0, 1.0, 0.0])
    c = np.array([0.0, 0.5, 2.0])
    # wound so that its normal (0.866, 0, -0.5) faces away from the camera
    tri = np.stack([c - u - v, c + v, c + u - v])
    d["objects"].append({"material_index": glass,
                         "vertices": tri.reshape(-1).tolist(),
                         "triangles": [0, 1, 2]})
    return scene_from_dict(d, device="cpu")


class GlassRecount:
    """The backend, with a brute count of what the march and refraction
    counters count: the shadow lanes handed to the glass-flag pass, and
    the refractive hits of every shading trace (a ``shade_local`` of the
    iterative wavefront, a level of the recursive one's ``with_rows``)
    that refract or totally reflect, found from the hits anew."""

    def __init__(self, fn, scene, settings):
        self.fn, self.scene, self.settings = fn, scene, settings
        self.entering = self.refracted = self.tir = 0

    def _note(self, o, d, active, hit):
        a = shade.hit_attributes(self.scene, o, d, hit)
        glass = active & a.valid & (a.mat_type == MATERIAL_REFRACTIVE)
        ok = shade.refraction_geometry(d, a.normal, a.ior,
                                       self.settings.refraction_bias,
                                       a.point)[2]
        self.refracted += int((glass & ok).sum())
        self.tir += int((glass & ~ok).sum())

    def __call__(self, o, d, active=None):
        hit = self.fn(o, d, active)
        if sys._getframe(1).f_code.co_name == "shade_local":
            self._note(o, d, active, hit)
        return hit

    def with_rows(self, o, d, active=None):
        hit, rows = self.fn.with_rows(o, d, active)
        self._note(o, d, active, hit)
        return hit, rows

    def shadow_glass(self, point, shadow_o, lights, act_lr, slack):
        self.entering += int(act_lr.sum())
        with record_function("test.glass_pass"):
            return self.fn.shadow_glass(point, shadow_o, lights, act_lr,
                                        slack)

    def __getattr__(self, attr):
        return getattr(self.fn, attr)


@pytest.mark.parametrize("wavefront", ["iter", "recursive"])
def test_march_and_refraction_counters_equal_a_brute_count(wavefront,
                                                            monkeypatch):
    scene = glass_scene()
    st = RenderSettings(max_ray_depth=3, wavefront=wavefront)
    brute = GlassRecount(make_trace_fn(scene, st), scene, st)
    walking = []
    march = shade._transmissive_march

    def counted_march(*args, **kwargs):
        walking.append(int(args[6].sum()))  # act: the lanes that walk
        return march(*args, **kwargs)

    monkeypatch.setattr(shade, "_transmissive_march", counted_march)
    with tracing.recording() as c:
        _render_flat(scene, st, trace_fn=brute)
    assert c["crt.march.lanes"] == brute.entering > 0
    assert c["crt.march.walk_lanes"] == sum(walking) > 0
    assert c["crt.march.walk_lanes"] < c["crt.march.lanes"]
    assert c["crt.shade.refracted_lanes"] == brute.refracted > 0
    assert c["crt.shade.tir_lanes"] == brute.tir > 0


def test_the_march_span_holds_its_glass_flag_pass():
    scene = glass_scene()
    st = RenderSettings(max_ray_depth=3)
    brute = GlassRecount(make_trace_fn(scene, st), scene, st)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _render_flat(scene, st, trace_fn=brute)
    ev = [(e.name, e.time_range.start, e.time_range.end)
          for e in prof.events()]
    assert inside(ev, "test.glass_pass", ["crt.shade.march"])
    assert inside(ev, "crt.shade.march",
                  [f"crt.shade.bounce.{b}" for b in range(4)])
    marches = named(ev, "crt.shade.march")
    assert len(marches) == len(named(ev, "test.glass_pass"))
    # the bend-walk's traces run under the span as well
    walk = [s for s, _ in named(ev, "crt.trace")
            if any(a <= s <= b for a, b in marches)]
    assert len(walk) > len(marches)


# -- the same bits with tracing on and off ------------------------------------

def test_image_and_fit_bit_equal_with_tracing_on():
    off = render_image(gi_scene(), GI)
    (params_off, losses_off) = _fit()
    with tracing.recording():
        (on, (params_on, losses_on)), ev = profiled(
            lambda: (render_image(gi_scene(), GI), _fit()))
    assert ev and tracing.counters()["crt.shade.lanes"] > 0
    assert torch.equal(on, off)
    assert losses_on == losses_off
    assert all(torch.equal(params_on[k], params_off[k]) for k in params_off)


# -- counters: the registry itself --------------------------------------

def test_recording_nests_and_counts_into_the_outer_block():
    with tracing.recording() as outer:
        tracing.count("crt.x", 2)
        with tracing.recording() as inner:
            assert tracing.enabled()
            tracing.count("crt.x")
            tracing.count("crt.y.a", torch.tensor([True, False, True]))
            tracing.count("crt.y.b", torch.tensor(5))
        assert inner == {"crt.x": 1, "crt.y.a": 2, "crt.y.b": 5}
        for _ in range(2 * tracing._FOLD + 3):
            tracing.count("crt.z", torch.ones((), dtype=torch.int32))
    assert not tracing.enabled()
    assert outer == {"crt.x": 3, "crt.y.a": 2, "crt.y.b": 5,
                     "crt.z": 2 * tracing._FOLD + 3}
    assert tracing.total(outer, "crt.y") == 7
    assert tracing.counters() == outer
    tracing.count("crt.x")  # off: not counted
    assert tracing.counters()["crt.x"] == 3
    tracing.reset()
    assert tracing.counters() == {}


# -- counters: the kernels' wrappers on CPU tensors (the plain versions) ------

@pytest.fixture(scope="module")
def case_inputs():
    scene = make_test_scene(64, 64, 8, with_refractive=True, device="cpu")
    tables = cluster_tables.build_cluster_tables(scene)
    rows = cluster_tables.emit_rows_table(scene, tables)
    rx, ry, _ = make_tiler(scene.height, scene.width, device="cpu")
    o, d = camera.generate_rays(scene.cam_position, scene.cam_rotation,
                                scene.cam_tan_half_fov, scene.width,
                                scene.height, rx, ry)
    o, d = o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()
    hit = make_trace_fn(scene, RenderSettings())(o, d)
    point = (o + d * torch.where(hit.valid, hit.t, 1.0)[:, None]).contiguous()
    lights = scene.light_position.contiguous()
    act = hit.valid[None].expand(lights.shape[0], -1).contiguous()
    ldir = lights[:, None, :] - point[None]
    r2 = (ldir * ldir).sum(-1)
    ldir = (ldir / r2.sqrt()[..., None]).reshape(-1, 3).contiguous()
    return dict(scene=scene, tables=tables, rows=rows, o=o, d=d,
                point=point, lights=lights, act=act, ldir=ldir,
                r2=r2.reshape(-1).contiguous(),
                st=stream_trace.build_stream_tables(tables, layout="fused"))


def _k1(x, fn):
    cl, cnt = binning.bin_rays(x["tables"], x["o"], x["d"], 1024)
    return fn(x["tables"], x["o"], x["d"], cl, cnt, x["rows"])


def _k2(x, mode):
    gm, gmin, gmax = cluster_tables.glass_subset(x["scene"], x["tables"])
    kw, bin_kw = {
        "capped": ({}, {}),
        "uncapped": (dict(capped=False, member_mask=gm),
                     dict(boxes=(gmin, gmax), capped=False)),
        "glass": (dict(member_mask=gm, glass_flag=True),
                  dict(glass_boxes=(gmin, gmax))),
    }[mode]
    cl, cnt = binning.bin_apex_shared(x["tables"], x["point"], x["lights"],
                                      x["act"], 1024, 0.02, **bin_kw)
    return cluster_trace.occlusion_w(x["tables"], x["point"], x["point"],
                                     x["lights"], cl, cnt, **kw)


def _k56(x, exit):
    Ll = x["lights"].shape[0]
    o = x["point"].repeat(Ll, 1)
    if exit:
        cl, cnt = binning.bin_rays(x["tables"], o, x["ldir"], 1024)
        return cluster_trace.occlusion_d(x["tables"], o, x["ldir"], x["r2"],
                                         cl, cnt, exit=True)
    tpl = x["point"].shape[0] // 1024
    apex = x["lights"].repeat_interleave(tpl, dim=0)
    cl, cnt = binning.bin_rays(x["tables"], o, x["ldir"], 1024,
                               apex=apex, apex_slack=0.02)
    return cluster_trace.occlusion_d(x["tables"], x["point"], x["ldir"],
                                     x["r2"], cl, cnt, tile_mod=tpl)


def _stream(x, layout, occl):
    st = x["st"]
    table = stream_trace.layout_table(st, layout)
    bounds = binning.tile_bounds(x["o"], x["d"], 1024)
    pair_sc, bits, start = stream_trace.bin_stream_pairs(st, bounds)
    if occl:
        r2 = torch.full((x["o"].shape[0],), 100.0)
        seed = torch.zeros_like(r2, dtype=torch.bool)
        return stream_trace.occlusion_stream(table, x["o"], x["d"], r2, seed,
                                             pair_sc, bits, start, st.sc,
                                             layout=layout)
    return stream_trace.closest_hit_stream(table, st.tables.tri_id, x["o"],
                                           x["d"], pair_sc, bits, start,
                                           st.sc, layout=layout)


def _bin(x, mode):
    """Phase A in one mode: ``bin_rays`` (frustum, masked frustum, apex) or
    ``bin_apex_shared`` (capped, uncapped over the glass boxes, glass)."""
    if mode.startswith("shared"):
        _, gmin, gmax = cluster_tables.glass_subset(x["scene"], x["tables"])
        kw = {"shared": {},
              "shared_uncapped": dict(boxes=(gmin, gmax), capped=False),
              "shared_glass": dict(glass_boxes=(gmin, gmax))}[mode]
        return binning.bin_apex_shared(x["tables"], x["point"], x["lights"],
                                       x["act"], 1024, 0.02, **kw)
    Ll = x["lights"].shape[0]
    if mode == "apex":
        apex = x["lights"].repeat_interleave(x["point"].shape[0] // 1024, 0)
        return binning.bin_rays(x["tables"], x["point"].repeat(Ll, 1),
                                x["ldir"], 1024, x["act"].reshape(-1),
                                apex=apex, apex_slack=0.02)
    act = x["act"][0] if mode == "rays_masked" else None
    return binning.bin_rays(x["tables"], x["o"], x["d"], 1024, act)


def _stream_bin(x, mode):
    """The streaming Phase A in one mode: the camera rays' frustum, or the
    shadow rays' shaft (capped, with the per-lane test, or without)."""
    boxes = stream_trace._boxes(x["st"])
    if mode == "rays":
        return stream_binning.bin_stream(*boxes, x["o"], x["d"], 1024)
    Ll = x["lights"].shape[0]
    apex = x["lights"].repeat_interleave(x["point"].shape[0] // 1024, 0)
    kw = {"shaft_capped": dict(per_tile_cap=2), "shaft_exact": {},
          "shaft": dict(lane_exact=False)}[mode]
    return stream_binning.bin_stream(
        *boxes, x["point"].repeat(Ll, 1), x["ldir"], 1024,
        x["act"].reshape(-1), apex, 0.02, x["r2"], **kw)


def _segsum(x):
    ids = torch.tensor([0, -1, 2, 3, 7, 2], dtype=torch.int32)
    return segsum.segment_accumulate(
        ids, torch.arange(12, dtype=torch.float32).reshape(2, 6), 3)


PLAIN_CASES = {
    "closest_hit": lambda x: _k1(x, cluster_trace.closest_hit),
    "closest_hit_compact": lambda x: _k1(x, cluster_trace.closest_hit_compact),
    "closest_hit_merged": lambda x: _k1(
        x, lambda *a: cluster_trace.closest_hit_merged(*a, merge=2)),
    "live_tiles": lambda x: cluster_trace.live_tiles(binning.bin_rays(
        x["tables"], x["o"], x["d"], 1024)[1]),
    **{f"occlusion_w.{m}": (lambda x, m=m: _k2(x, m))
       for m in ("capped", "uncapped", "glass")},
    "occlusion_d.compact": lambda x: _k56(x, False),
    "occlusion_d.exit": lambda x: _k56(x, True),
    **{f"closest_hit_stream.{lay}": (lambda x, lay=lay: _stream(x, lay, False))
       for lay in stream_trace.LAYOUTS},
    **{f"occlusion_stream.{lay}": (lambda x, lay=lay: _stream(x, lay, True))
       for lay in stream_trace.LAYOUTS},
    "segsum": _segsum,
    **{f"cluster_bin.{m}": (lambda x, m=m: _bin(x, m))
       for m in ("rays", "rays_masked", "apex", "shared", "shared_uncapped",
                 "shared_glass")},
    **{f"stream_bin.{m}": (lambda x, m=m: _stream_bin(x, m))
       for m in stream_binning.MODES},
}


@pytest.mark.parametrize("case", sorted(PLAIN_CASES))
def test_plain_versions_count_no_launch(case_inputs, case):
    """On CPU tensors each wrapper takes its plain version, which launches
    and counts nothing, while the recording is on."""
    with tracing.recording() as c:
        out = PLAIN_CASES[case](case_inputs)
    assert out is not None
    assert tracing.total(c, "crt.launches") == 0
    assert tracing.enabled() is False


def test_cluster_bin_kernel_is_built(tmp_path):
    """``cluster_bin.cu`` is one of the library's sources, and its text is
    part of the build's digest: an edit to it builds the library anew."""
    import shutil

    from crt_tpu_torch.ops import cuda_lib

    assert "cluster_bin.cu" in cuda_lib.SOURCES
    assert "crt_cluster_bin(" in (cuda_lib.CSRC / "cluster_bin.cu").read_text()
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_lib.CSRC, csrc)
    before = cuda_lib._digest(csrc)
    assert before == cuda_lib._digest(cuda_lib.CSRC)
    with open(csrc / "cluster_bin.cu", "a") as f:
        f.write("\n")
    assert cuda_lib._digest(csrc) != before


@pytest.mark.parametrize("entry", ["bin_rays", "bin_apex_shared",
                                   "bin_stream"])
def test_binning_raises_where_it_has_no_kernel(case_inputs, entry):
    """A tensor on neither the CPU nor a CUDA card is refused, not binned
    by the plain version."""
    x = {k: v.to("meta") for k, v in case_inputs.items()
         if isinstance(v, torch.Tensor)}
    with pytest.raises(NotImplementedError, match=entry):
        if entry == "bin_rays":
            binning.bin_rays(case_inputs["tables"], x["o"], x["d"], 1024)
        elif entry == "bin_stream":
            stream_binning.bin_stream(
                *stream_trace._boxes(case_inputs["st"]), x["o"], x["d"], 1024)
        else:
            binning.bin_apex_shared(case_inputs["tables"], x["point"],
                                    x["lights"], x["act"], 1024, 0.02)


def test_stream_phase_a_is_looked_up_on_stream_binning(monkeypatch):
    """A streaming frame takes its Phase A through ``stream_binning``'s
    attribute at each call (where ``bench.binning`` wraps it): a wrapper
    put there sees the frame's three calls, the camera rays' frustum and
    the two phases of the shadow resolve."""
    seen = []
    real = stream_binning.bin_stream

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append(out[2].shape[0] - 1)  # the call's tiles
        return out

    monkeypatch.setattr(stream_binning, "bin_stream", spy)
    scene = make_test_scene(64, 48, 8, with_reflective=False, device="cpu")
    with tracing.recording() as c:
        render_image(scene, RenderSettings(backend="stream"))
    assert len(seen) == 3 and seen[1] == seen[2]
    assert c["crt.binning.pairs.hull"] > 0  # the complete walk's shaft


# -- counters: Phase A's pairs and the host-read sites -----------------

def test_cluster_pairs_equal_the_list_lengths(case_inputs):
    x = case_inputs
    with tracing.recording() as c:
        _, cnt = binning.bin_rays(x["tables"], x["o"], x["d"], 1024)
        _, cnt2 = binning.bin_apex_shared(x["tables"], x["point"],
                                          x["lights"], x["act"], 1024, 0.02)
    assert c["crt.binning.pairs.cluster"] == int(cnt.sum() + cnt2.sum()) > 0


class ShadowSpy:
    """The cluster backend with ``shadow_kernel``, noting the lists of
    every Phase A call it makes: the camera and mirror rays' (``bin_rays``
    without an apex) and the shadow passes' (``bin_apex_shared``, or
    ``bin_rays``' apex mode for K5), with each pass's active lanes."""

    def __init__(self, monkeypatch, scene, shadow_kernel):
        self.tracer = cluster_trace.ClusterTracer(
            cluster_tables.build_cluster_tables(scene), scene,
            shadow_kernel=shadow_kernel)
        self.rays, self.shadow, self.lanes, self.passes = [], [], 0, 0
        real_rays, real_shared = binning.bin_rays, binning.bin_apex_shared

        def bin_rays(*a, **kw):
            out = real_rays(*a, **kw)
            (self.shadow if kw.get("apex") is not None
             else self.rays).append(int(out[1].sum()))
            return out

        def bin_apex_shared(*a, **kw):
            out = real_shared(*a, **kw)
            self.shadow.append(int(out[1].sum()))
            return out

        real_pass = {"w": self.tracer._shadow_w, "d": self.tracer._shadow_d}
        active_at = {"w": 3, "d": 4}[shadow_kernel]

        def shadow_pass(*a, **kw):
            self.passes += 1
            self.lanes += int(a[active_at].sum())
            return real_pass[shadow_kernel](*a, **kw)

        monkeypatch.setattr(cluster_trace, "bin_rays", bin_rays)
        monkeypatch.setattr(cluster_trace, "bin_apex_shared", bin_apex_shared)
        monkeypatch.setattr(self.tracer, f"_shadow_{shadow_kernel}",
                            shadow_pass)


@pytest.mark.parametrize("shadow_kernel", ["w", "d"])
def test_shadow_pairs_and_lanes_equal_the_shadow_lists(monkeypatch,
                                                       shadow_kernel):
    """``crt.shadow.pairs`` is the shadow lists' ``counts.sum()`` and
    ``crt.shadow.lanes`` their passes' active lanes; the camera, mirror
    and shadow lists together stay ``crt.binning.pairs.cluster``."""
    scene = make_test_scene(64, 48, 8, device="cpu")
    spy = ShadowSpy(monkeypatch, scene, shadow_kernel)
    with tracing.recording() as c:
        _render_flat(scene, RenderSettings(max_ray_depth=3),
                     trace_fn=spy.tracer)
    assert spy.passes >= 2 and len(spy.shadow) == spy.passes
    assert c["crt.shadow.pairs"] == sum(spy.shadow) > 0
    assert c["crt.shadow.lanes"] == spy.lanes > 0
    assert c["crt.binning.pairs.cluster"] == sum(spy.rays) + sum(spy.shadow)


def test_a_cluster_frame_opens_one_shadow_span_a_shadow_pass(monkeypatch):
    """Each opaque shadow pass runs in a ``crt.trace.shadow`` span of its
    own, its Phase A inside, and nothing else opens one."""
    scene = make_test_scene(64, 48, 8, device="cpu")
    spy = ShadowSpy(monkeypatch, scene, "w")
    real = spy.tracer._shadow_w

    def marked(*a, **kw):
        with record_function("test.shadow_pass"):
            return real(*a, **kw)

    monkeypatch.setattr(spy.tracer, "_shadow_w", marked)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _render_flat(scene, RenderSettings(max_ray_depth=3),
                     trace_fn=spy.tracer)
    ev = [(e.name, e.time_range.start, e.time_range.end)
          for e in prof.events()]
    spans = named(ev, "crt.trace.shadow")
    assert len(spans) == spy.passes == len(named(ev, "test.shadow_pass"))
    assert inside(ev, "test.shadow_pass", ["crt.trace.shadow"])
    inner = [s for s, _ in named(ev, "crt.binning")
             if any(a <= s <= b for a, b in spans)]
    assert len(inner) == spy.passes


def _march(_):
    glass = make_test_scene(64, 48, 8, with_refractive=True, device="cpu")
    render_image(glass, RenderSettings(max_ray_depth=3))
    # the pool's bounces past the camera rays' take their live lanes
    return {"crt.host_reads.march.any": None,
            "crt.host_reads.march.blocks": None,
            "crt.host_reads.shade_compact": 3}


def _stream_frame_reads(_):
    scene = make_test_scene(64, 48, 8, with_reflective=False, device="cpu")
    render_image(scene, RenderSettings(backend="stream", stream_shadow_k=2))
    # one pair list for the camera rays, one for phase 1, two for phase 2
    return {"crt.host_reads.stream_nonzero": 4}


def _tree(_):
    scene = scene_from_dict(make_test_scene_dict(64, 48, 8),
                            build_accel=True, device="cpu")
    render_image(scene, RenderSettings(backend="tree", max_ray_depth=1))
    return {"crt.host_reads.tree_walk": None}


def _fit_reads(_):
    fit_two_steps(make_test_scene(64, 48, 8, device="cpu"))
    return {"crt.host_reads.fit_loss": 2}


def _gi_reads(_):
    render_image(gi_scene(), GI)
    # the frame's salt and each GI child's stream salt, and the pool's
    # pad direction, are host values copied to the device; each bounce
    # past the camera rays' reads its live lanes, in each of two chunks
    return {"crt.host_reads.rng_salt": None, "crt.host_reads.pool_pad": None,
            "crt.host_reads.shade_compact": 2 * GI.max_ray_depth}


READ_CASES = {"march": _march, "stream": _stream_frame_reads, "tree": _tree,
              "fit": _fit_reads, "gi": _gi_reads}


@pytest.mark.parametrize("case", sorted(READ_CASES))
def test_host_read_sites_count(case):
    """Each site counts its reads under its own name, and only it."""
    with tracing.recording() as c:
        want = READ_CASES[case](None)
    reads = {k: v for k, v in c.items() if k.startswith("crt.host_reads.")}
    assert set(reads) == set(want)
    for k, n in want.items():
        assert reads[k] == n if n is not None else reads[k] > 0
    if case == "tree":
        assert c["crt.tree.walks"] > 0 and c["crt.tree.iterations"] > 0
    if case == "march":
        assert c["crt.march.traces"] > 0
    if case == "stream":
        assert c["crt.binning.pairs.supercluster"] > 0

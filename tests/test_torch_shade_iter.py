"""The refractive slice of crt_tpu_torch end to end vs crt_tpu.render_image:
the iterative bank wavefront (both schedules), the recursive tree that is
its oracle, the live-tile compacted bounces, the bounces shaded on their
live lanes only, chunking, and the pool's bookkeeping.

The port renders on CPU tensors through its cluster backend (binning, the
plain versions of the kernels, the glass router); crt_tpu renders through
its default CPU backend (all-pairs intersection, no router), so the two
also differ in which code decides a hit.

Tolerances.  Images vs crt_tpu: rtol 1e-5 / atol 1e-6, test_pallas_trace.py's
tolerance (the JAX render is jitted, XLA contracts multiply-adds into FMAs,
and ``pow`` need not round alike).  Inside the port: ``compact_bounces``
EXACT (the compacted kernel is the plain kernel bit for bit); iterative vs
recursive and scan vs grow atol 2e-6 (tests/test_shade_iter.py's: the same
paths summed in another f32 order); chunked vs unchunked EXACT (a chunk is
a set of whole tiles); a bounce shaded on its live lanes vs full-width
EXACT, images and gradients (every step is per lane and the trace's
per-ray result does not depend on the rays that share its tile).
``_place_children`` vs crt_tpu's: EXACT.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

import crt_tpu
from crt_tpu.ops import shade_iter as jshade_iter
from crt_tpu.scene.procedural import make_test_scene as jmake_test_scene
from crt_tpu_torch import RenderSettings, render_image
from crt_tpu_torch.ops import camera
from crt_tpu_torch.ops import cluster_trace as ttr
from crt_tpu_torch.ops import shade_iter
from crt_tpu_torch.renderer import (
    make_tiler,
    make_trace_fn,
    use_iterative_wavefront,
)
from crt_tpu_torch.scene.procedural import make_test_scene
from crt_tpu_torch.utils import trace as tracing
from torch_port_fixtures import _one_torch_thread, _release_heap  # noqa: F401

GLASS = dict(width=96, height=64, num_quads=8, with_refractive=True)


CASES = {
    "default": dict(),
    "recursive": dict(wavefront="recursive"),
    "grow": dict(wavefront_sched="grow"),
    "head_compat": dict(head_compat=True),
    "depth5": dict(max_ray_depth=5),
    "depth1": dict(max_ray_depth=1),
    "chunked": dict(chunk_pixels=2048),
    "iter_depth1": dict(max_ray_depth=1, wavefront="iter"),
    "bruteforce": dict(backend="bruteforce"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_refractive_image_matches_crt_tpu(case):
    kw = CASES[case]
    ref = np.asarray(crt_tpu.render_image(jmake_test_scene(**GLASS),
                                          crt_tpu.RenderSettings(**kw)))
    img = render_image(make_test_scene(**GLASS, device="cpu"),
                       RenderSettings(**kw))
    assert img.shape == (64, 96, 3) and img.dtype == torch.float32
    np.testing.assert_allclose(img.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("wavefront", ["iter", "recursive"])
def test_refractions_off_glass_is_black(wavefront):
    kw = dict(wavefront=wavefront)
    ref = np.asarray(crt_tpu.render_image(
        jmake_test_scene(**GLASS).replace(refractions_on=False),
        crt_tpu.RenderSettings(**kw)))
    scene = make_test_scene(**GLASS, device="cpu").replace(
        refractions_on=False)
    img = render_image(scene, RenderSettings(**kw))
    np.testing.assert_allclose(img.numpy(), ref, rtol=1e-5, atol=1e-6)
    lit = render_image(make_test_scene(**GLASS, device="cpu"),
                       RenderSettings(**kw))
    dark = (img == 0).all(dim=-1) & (lit != 0).any(dim=-1)
    assert dark.sum() > 50  # the glass the primary rays see turned black


def test_mirror_scene_through_the_iterative_wavefront():
    """A scene without glass forced through the pool (2 banks)."""
    kw = dict(width=64, height=36, num_quads=8)
    ref = np.asarray(crt_tpu.render_image(
        jmake_test_scene(**kw), crt_tpu.RenderSettings(wavefront="iter")))
    scene = make_test_scene(**kw, device="cpu")
    img = render_image(scene, RenderSettings(wavefront="iter"))
    np.testing.assert_allclose(img.numpy(), ref, rtol=1e-5, atol=1e-6)
    rec = render_image(scene, RenderSettings(wavefront="recursive"))
    np.testing.assert_allclose(img.numpy(), rec.numpy(), rtol=0, atol=2e-6)


def test_variants_agree_inside_the_port():
    scene = make_test_scene(**GLASS, device="cpu")
    base = render_image(scene)
    compact = render_image(scene, RenderSettings(compact_bounces=True))
    assert torch.equal(compact, base)
    for chunk in (2048, 2500):
        assert torch.equal(
            render_image(scene, RenderSettings(chunk_pixels=chunk)), base)
    for kw in (dict(wavefront="recursive"), dict(wavefront_sched="grow"),
               dict(wavefront="recursive", compact_bounces=True)):
        other = render_image(scene, RenderSettings(**kw))
        np.testing.assert_allclose(other.numpy(), base.numpy(), rtol=0,
                                   atol=2e-6)


def test_compact_bounces_go_through_the_compacted_kernel(monkeypatch):
    """``compact_bounces`` reaches ``closest_hit_compact`` for every masked
    trace (the pool's bounces and the march), and only then."""
    scene = make_test_scene(64, 32, num_quads=6, with_refractive=True,
                            device="cpu")
    calls = {"k1": 0, "k4": 0}
    real_k1, real_k4 = ttr.closest_hit, ttr.closest_hit_compact

    def k1(*a, **k):
        calls["k1"] += 1
        return real_k1(*a, **k)

    def k4(*a, **k):
        calls["k4"] += 1
        return real_k4(*a, **k)

    monkeypatch.setattr(ttr, "closest_hit", k1)
    monkeypatch.setattr(ttr, "closest_hit_compact", k4)
    render_image(scene)
    plain_calls = dict(calls)
    assert plain_calls["k4"] == 0 and plain_calls["k1"] >= 4
    calls.update(k1=0, k4=0)
    render_image(scene, RenderSettings(compact_bounces=True))
    assert calls == {"k1": 0, "k4": plain_calls["k1"]}


def _primary(scene):
    rx, ry, _ = make_tiler(scene.height, scene.width, device=scene.device)
    o, d = camera.generate_rays(scene.cam_position, scene.cam_rotation,
                                scene.cam_tan_half_fov, scene.width,
                                scene.height, rx, ry)
    return o.contiguous(), d


@pytest.mark.parametrize("sched", ["scan", "grow"])
def test_drops_none_at_default_banks_and_some_when_starved(sched):
    scene = make_test_scene(32, 32, num_quads=8, with_refractive=True,
                            device="cpu")
    st = RenderSettings(wavefront="iter", wavefront_sched=sched)
    trace = make_trace_fn(scene, st)
    o, d = _primary(scene)
    full, dropped = shade_iter.shade_wavefront_iter_with_stats(
        scene, st, trace, o, d)
    assert int(dropped) == 0 and dropped.dtype == torch.int32
    starved, dropped = shade_iter.shade_wavefront_iter_with_stats(
        scene, st, trace, o, d, banks=1 if sched == "scan" else 2)
    if sched == "scan":
        # one bank: every Fresnel pair loses its reflection ray
        assert int(dropped) > 0
        assert not torch.equal(starved, full)
    else:
        # the grow schedule folds the leaves in: never more drops than scan
        _, scan_drops = shade_iter.shade_wavefront_iter_with_stats(
            scene, st.replace(wavefront_sched="scan"), trace, o, d, banks=2)
        assert int(dropped) <= int(scan_drops)


def test_auto_policy_and_default_banks_match_crt_tpu():
    from crt_tpu.renderer import use_iterative_wavefront as juse

    for kw in (dict(num_quads=2, with_refractive=True),
               dict(num_quads=2, with_reflective=False), dict(num_quads=2)):
        js, ts = jmake_test_scene(**kw), make_test_scene(**kw, device="cpu")
        for skw in (dict(), dict(max_ray_depth=1), dict(max_ray_depth=2),
                    dict(max_ray_depth=5), dict(wavefront="iter"),
                    dict(wavefront="recursive"), dict(wavefront_banks=5)):
            assert (use_iterative_wavefront(ts, RenderSettings(**skw))
                    == juse(js, crt_tpu.RenderSettings(**skw))), (kw, skw)
            assert (shade_iter.default_banks(ts, RenderSettings(**skw))
                    == jshade_iter.default_banks(
                        js, crt_tpu.RenderSettings(**skw))), (kw, skw)
    refr = make_test_scene(num_quads=2, with_refractive=True, device="cpu")
    assert use_iterative_wavefront(refr, RenderSettings())
    assert not use_iterative_wavefront(refr, RenderSettings(max_ray_depth=1))
    assert not use_iterative_wavefront(refr.replace(refractions_on=False),
                                       RenderSettings())
    assert shade_iter.default_banks(refr, RenderSettings()) == 8


@pytest.mark.parametrize("banks", [(4, 4), (2, 6), (8, 8)])
def test_place_children_matches_crt_tpu(banks):
    """Seeded pools: the same children land in the same slots, the same
    number is dropped; source and destination bank counts may differ."""
    bi, bj = banks
    R = 257
    rng = np.random.default_rng(bi * 10 + bj)
    dead = rng.random((bj, R)) < 0.4
    cand_act = rng.random((bi, R)) < 0.5
    olds = [rng.normal(size=(bj, R, 3)).astype(np.float32) for _ in range(3)]
    cands = [rng.normal(size=(bi, R, 3)).astype(np.float32) for _ in range(3)]
    jout, jdead, jplaced, jdrop = jshade_iter._place_children(
        [jnp.asarray(x) for x in olds], jnp.asarray(dead),
        jnp.asarray(cand_act), [jnp.asarray(x) for x in cands],
        jnp.zeros((), jnp.int32))
    tout, tdead, tplaced, tdrop = shade_iter._place_children(
        [torch.from_numpy(x) for x in olds], torch.from_numpy(dead),
        torch.from_numpy(cand_act), [torch.from_numpy(x) for x in cands],
        torch.zeros((), dtype=torch.int32))
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tdead.numpy(), np.asarray(jdead))
    np.testing.assert_array_equal(tplaced.numpy(), np.asarray(jplaced))
    assert int(tdrop) == int(jdrop) > 0
    assert tplaced.any()


def test_inactive_lanes_and_banks_argument():
    """Lanes switched off (chunk padding) cost nothing and change nothing
    on the live ones; ``banks`` overrides the default."""
    scene = make_test_scene(64, 32, num_quads=6, with_refractive=True,
                            device="cpu")
    st = RenderSettings()
    trace = make_trace_fn(scene, st)
    o, d = _primary(scene)
    full = shade_iter.shade_wavefront_iter(scene, st, trace, o, d)
    act = torch.arange(o.shape[0]) < 1024
    part = shade_iter.shade_wavefront_iter(scene, st, trace, o, d, act)
    assert torch.equal(part[:1024], full[:1024])
    assert (part[1024:] == 0).all()
    wide = shade_iter.shade_wavefront_iter(scene, st, trace, o, d, banks=12)
    assert torch.equal(wide, full)


# scene keywords, settings, gi_salt, chunks
LIVE_LANE_CASES = {
    "gi_grow": (dict(gi_on=True), dict(max_ray_depth=3,
                                       diffuse_reflection_ray_count=2),
                None, 1),
    "gi_grow_salted": (dict(gi_on=True),
                       dict(max_ray_depth=3, diffuse_reflection_ray_count=2),
                       5, 1),
    "gi_scan": (dict(gi_on=True),
                dict(max_ray_depth=2, diffuse_reflection_ray_count=2,
                     wavefront_sched="scan"), None, 1),
    "glass_scan_depth3": (dict(with_refractive=True),
                          dict(max_ray_depth=3), None, 1),
    "gi_chunked": (dict(gi_on=True),
                   dict(max_ray_depth=2, diffuse_reflection_ray_count=2,
                        chunk_pixels=2048), None, 2),
}


def compaction(monkeypatch, on: bool):
    """Force every bounce past the primary one onto its live lanes (on)
    or full-width (off)."""
    monkeypatch.setattr(shade_iter, "_COMPACT_MAX_LIVE", 1.0 if on else -1.0)


@pytest.mark.parametrize("backend", ["cluster", "bruteforce"])
@pytest.mark.parametrize("case", sorted(LIVE_LANE_CASES))
def test_live_lane_bounces_bit_equal_full_width(monkeypatch, case, backend):
    """A bounce shaded on its gathered live lanes and scattered back gives
    the full-width image bit for bit; the primary bounce never compacts,
    every other one does when forced."""
    scene_kw, kw, salt, chunks = LIVE_LANE_CASES[case]
    scene = make_test_scene(64, 48, num_quads=6, device="cpu", **scene_kw)
    st = RenderSettings(backend=backend, **kw)
    assert use_iterative_wavefront(scene, st)
    out = {}
    for on in (True, False):
        compaction(monkeypatch, on)
        with tracing.recording() as c:
            out[on] = render_image(scene, st, gi_salt=salt)
        bounces = chunks * (st.max_ray_depth + 1)
        assert c["crt.shade.bounces"] == bounces
        assert c["crt.shade.compacted_bounces"] == (
            bounces - chunks if on else 0)
        assert c["crt.host_reads.shade_compact"] == bounces - chunks
        lanes = c["crt.shade.lanes"], c["crt.shade.live_lanes"]
        assert 0 < lanes[1] < lanes[0]
        if on:
            compact_lanes = lanes
    assert compact_lanes[1] == lanes[1] and compact_lanes[0] < lanes[0]
    assert float(out[True].abs().max()) > 0
    assert torch.equal(out[True], out[False])


def test_live_lanes_engage_at_the_default_share_on_gi_grow():
    """The GI pool's leaf and last bounces are mostly dead: at the
    module's threshold they take their live lanes (bounce 1, its two
    banks mostly live, stays full-width), the lanes shaded are mostly
    live, and the image is the full-width one."""
    scene = make_test_scene(64, 48, num_quads=6, gi_on=True, device="cpu")
    st = RenderSettings(max_ray_depth=3, diffuse_reflection_ray_count=2)
    with tracing.recording() as c:
        img = render_image(scene, st)
    assert c["crt.shade.bounces"] == 4
    assert c["crt.shade.compacted_bounces"] == 2
    assert 2 * c["crt.shade.live_lanes"] > c["crt.shade.lanes"]
    with pytest.MonkeyPatch.context() as mp:
        compaction(mp, False)
        with tracing.recording() as full:
            assert torch.equal(img, render_image(scene, st))
    assert 4 * full["crt.shade.live_lanes"] < full["crt.shade.lanes"]


def test_a_bounce_without_live_lanes_still_runs(monkeypatch):
    """With every camera lane off, each later bounce gathers no lane and
    shades one tile of dead lanes: the colours stay 0, as full-width."""
    scene = make_test_scene(64, 32, num_quads=6, gi_on=True, device="cpu")
    st = RenderSettings(max_ray_depth=2, diffuse_reflection_ray_count=2)
    trace = make_trace_fn(scene, st)
    o, d = _primary(scene)
    rx, ry, _ = make_tiler(scene.height, scene.width, device="cpu")
    dead = torch.zeros(o.shape[0], dtype=torch.bool)
    with tracing.recording() as c:
        color, dropped = shade_iter.shade_wavefront_iter_with_stats(
            scene, st, trace, o, d, dead, raster_x=rx, raster_y=ry)
    assert c["crt.shade.compacted_bounces"] == 2
    assert c["crt.shade.lanes"] == o.shape[0] + 2 * 1024 * (1 + 1)
    assert c["crt.shade.live_lanes"] == 0
    assert not color.any() and int(dropped) == 0

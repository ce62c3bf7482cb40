"""Diffuse GI of crt_tpu_torch vs crt_tpu: the PCG32 streams, the images of
both wavefronts, the pool against the recursive tree, progressive passes
and gradients.

The JAX side renders through its bruteforce backend (XLA, no Pallas kernel
is reached), in process.  Tolerances:
  - rng: bit for bit (uint32 draws, states and increments).
  - images: >= 99.5 % of pixels within rtol 1e-4 / atol 1e-5.  XLA's and
    torch's f32 sin / cos need not agree to the bit, so a hemisphere
    direction may differ by an ulp and take another triangle at an edge,
    which moves that pixel; every other pixel agrees to f32 rounding.
  - the bank pool against the recursive tree: they draw different (forked
    vs depth-first) samples, so they are compared as distributions, by
    the z-scores of tests/test_gi_oracle.py.
  - gradients vs jax.grad: rtol 1e-4 / atol 1e-4 of the group's largest
    entry (test_torch_grad.py's tolerance for crt_tpu's compiled bounce
    body), and vs central differences test_torch_grad.py's FD tolerances.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import crt_tpu
from crt_tpu.ops import rng as jrng
from crt_tpu.ops import shade_iter as jshade_iter
from crt_tpu.renderer import use_iterative_wavefront as juse_iter
from crt_tpu.scene.json_loader import scene_from_dict as jscene_from_dict
from crt_tpu.scene.procedural import make_test_scene as jmake_test_scene
from crt_tpu_torch import RenderSettings, render_image, render_progressive
from crt_tpu_torch.frontend import cli
from crt_tpu_torch.ops import rng as trng
from crt_tpu_torch.ops import shade_iter
from crt_tpu_torch.renderer import use_iterative_wavefront
from crt_tpu_torch.scene.procedural import make_test_scene
from test_rng import RefPCG32, ref_make_pcg
from test_torch_grad import (
    FD_CASES,
    ITER_ATOL_SCALE,
    ITER_RTOL,
    carry,
    torch_value_and_grads,
    trainable,
    weights,
)
from torch_port_fixtures import _one_torch_thread, _release_heap  # noqa: F401

PIXEL_SHARE = 0.995


def _uint64(state):
    """A crt_tpu PCGState (16-bit-limb planes) as uint64 (state, inc)."""
    def join(hi, lo):
        return ((np.asarray(hi).astype(np.uint64) << np.uint64(32))
                | np.asarray(lo).astype(np.uint64))
    return (join(state.state_hi, state.state_lo),
            join(state.inc_hi, state.inc_lo))


def _t64(state):
    return tuple(p.numpy().view(np.uint64) for p in state)


def _rasters(n, seed):
    rs = np.random.default_rng(seed)
    x = rs.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    y = rs.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    x[:3], y[:3] = [0, 1919, 0xFFFFFFFF], [0, 1079, 0xFFFFFFFF]
    return x, y


@pytest.mark.parametrize("case", ["sequence", "masked", "derive", "salt"])
def test_rng_matches_crt_tpu(case):
    """Seeding, draws (masked advancement), forks and salted streams equal
    crt_tpu.ops.rng's bits."""
    x, y = _rasters(512, 1)
    js = jrng.make_pcg(jnp.asarray(x), jnp.asarray(y))
    ts = trng.make_pcg(torch.from_numpy(x.astype(np.int64)),
                       torch.from_numpy(y.astype(np.int64)))
    act = np.random.default_rng(2).random(512) < 0.5
    for i in range(16):
        a = act if (case == "masked" and i % 2) else None
        jv, js = jrng.uniform(js, None if a is None else jnp.asarray(a))
        tv, ts = trng.uniform(ts, None if a is None else torch.from_numpy(a))
        np.testing.assert_array_equal(tv.numpy().view(np.uint32),
                                      np.asarray(jv).view(np.uint32))
        if case == "derive" and i in (3, 9):
            js, ts = jrng.derive(js, i + 1), trng.derive(ts, i + 1)
        if case == "salt" and i in (4, 11):
            salt = 0 if i == 4 else 0xFFFFFFFF
            js = jrng.salt_stream(js, jnp.uint32(salt))
            ts = trng.salt_stream(ts, torch.tensor(salt))
        for a, b in zip(_uint64(js), _t64(ts)):
            np.testing.assert_array_equal(b, a)


def test_rng_matches_the_reference_sequence():
    """tests/test_rng.py's pure-Python port of crt_random.h, draw by draw,
    a masked draw keeping its lane's state."""
    xs = np.array([0, 1, 827, 1919, 123456], np.int64)
    ys = np.array([0, 2, 410, 1079, 654321], np.int64)
    state = trng.make_pcg(torch.from_numpy(xs), torch.from_numpy(ys))
    refs = [ref_make_pcg(int(x), int(y)) for x, y in zip(xs, ys)]
    active = [True, False, True, True, False]
    for draw in range(20):
        masked = draw % 3 == 1
        vals, state = trng.uniform(
            state, torch.tensor(active) if masked else None)
        # a held lane draws from its state but keeps it
        expect = np.array([
            (r.uniform() if a or not masked
             else RefPCG32(r.state, r.inc).uniform())
            for r, a in zip(refs, active)], np.float32)
        np.testing.assert_array_equal(vals.numpy(), expect, err_msg=draw)


def test_default_banks_and_policy_under_gi_match_crt_tpu():
    for kw in (dict(num_quads=2), dict(num_quads=2, with_refractive=True)):
        js = jmake_test_scene(**kw).replace(gi_on=True)
        ts = make_test_scene(**kw, gi_on=True, device="cpu")
        for skw in (dict(), dict(diffuse_reflection_ray_count=1),
                    dict(diffuse_reflection_ray_count=3, max_ray_depth=2),
                    dict(wavefront="recursive"), dict(wavefront_banks=5)):
            st, jst = RenderSettings(**skw), crt_tpu.RenderSettings(**skw)
            assert use_iterative_wavefront(ts, st) == juse_iter(js, jst)
            assert (shade_iter.default_banks(ts, st)
                    == jshade_iter.default_banks(js, jst)), (kw, skw)
    assert shade_iter.default_banks(
        make_test_scene(num_quads=2, gi_on=True, device="cpu"),
        RenderSettings()) == 64


@pytest.mark.parametrize("case", ["gi_k3_d3", "gi_k2_d2", "glass_grow",
                                  "glass_scan"])
def test_chunks_follow_the_widest_pool_level(monkeypatch, case):
    """pool_width is the most banks the pool holds (grow: grow_f^(D - 1),
    the leaves inline; scan: every bank), and _render_flat cuts the frame
    into chunks of ITER_POOL_LANES / pool_width pixels, whose image is
    the single chunk's bit for bit."""
    from crt_tpu_torch import renderer

    scene_kw, kw, want = {
        "gi_k3_d3": (dict(gi_on=True), dict(diffuse_reflection_ray_count=3,
                                            max_ray_depth=3), 9),
        "gi_k2_d2": (dict(gi_on=True), dict(diffuse_reflection_ray_count=2,
                                            max_ray_depth=2), 2),
        "glass_grow": (dict(with_refractive=True),
                       dict(wavefront="iter", wavefront_sched="grow"), 4),
        "glass_scan": (dict(with_refractive=True), dict(wavefront="iter"),
                       8),
    }[case]
    scene = make_test_scene(64, 48, num_quads=4, device="cpu", **scene_kw)
    st = RenderSettings(backend="bruteforce", **kw)
    assert shade_iter.pool_width(scene, st) == want
    widest, chunks = [0], [0]
    place, shade = shade_iter._place_children, renderer.shade_wavefront_iter

    def counted_place(pool_fields, *args):
        widest[0] = max(widest[0], pool_fields[0].shape[0])
        return place(pool_fields, *args)

    def counted_shade(*args, **kwargs):
        chunks[0] += 1
        return shade(*args, **kwargs)

    monkeypatch.setattr(shade_iter, "_place_children", counted_place)
    whole = render_image(scene, st)
    assert widest[0] == want
    monkeypatch.setattr(renderer, "shade_wavefront_iter", counted_shade)
    # 4,096 padded rays: two chunks of 2,048 pixels
    monkeypatch.setattr(renderer, "ITER_POOL_LANES", 2048 * want)
    assert torch.equal(render_image(scene, st), whole)
    assert chunks[0] == 2


@pytest.mark.parametrize("case", ["gi", "glass"])
def test_backward_chunks_are_checkpointed(monkeypatch, case):
    """Without remat_shading, a frame that builds a graph in several chunks
    shades each chunk under a checkpoint and again in the backward: the
    same chunks as the frame without a graph (its image bit for bit), and
    gradients equal to the one-chunk gradients within rtol 1e-3 / atol
    1e-4 of the group's largest entry, chip_smoke.py's [gi] tolerance
    (the chunks add the per-pixel terms in another order)."""
    from crt_tpu_torch import renderer

    scene_kw, st = {
        "gi": (dict(gi_on=True), RenderSettings(
            max_ray_depth=2, diffuse_reflection_ray_count=2)),
        "glass": (dict(with_refractive=True), RenderSettings()),
    }[case]
    scene = make_test_scene(64, 64, num_quads=4, device="cpu", **scene_kw)
    keys = ("vertices", "light_intensity", "cam_position")

    def grads(settings):
        params = {k: getattr(scene, k).detach().clone().requires_grad_(True)
                  for k in keys}
        img = render_image(scene.replace(**params), settings)
        img.sum().backward()
        return img.detach(), {k: p.grad for k, p in params.items()}

    whole_img, whole = grads(st.replace(chunk_pixels=1 << 20))
    calls, shade = [0], renderer.shade_wavefront_iter

    def counted_shade(*args, **kwargs):
        calls[0] += 1
        return shade(*args, **kwargs)

    monkeypatch.setattr(renderer, "shade_wavefront_iter", counted_shade)
    # 4,096 rays: four chunks of 1,024 pixels
    monkeypatch.setattr(renderer, "ITER_POOL_LANES",
                        1024 * shade_iter.pool_width(scene, st))
    img = render_image(scene, st)
    assert calls[0] == 4
    calls[0] = 0
    graph_img, chunked = grads(st)
    assert calls[0] == 8  # four in the forward, four again in the backward
    assert torch.equal(graph_img, img) and torch.equal(img, whole_img)
    for k in keys:
        scale = float(whole[k].abs().max())
        assert scale > 0, k
        torch.testing.assert_close(chunked[k], whole[k], rtol=1e-3,
                                   atol=1e-4 * scale, msg=k)
    calls[0] = 0
    grads(st.replace(remat_shading=True))  # its bounces are checkpointed
    assert calls[0] == 4


def test_place_children_moves_rng_planes_as_crt_tpu():
    """Children with their forked streams land where crt_tpu puts them."""
    bi, bj, R = 4, 16, 131
    rs = np.random.default_rng(7)
    dead = rs.random((bj, R)) < 0.6
    cand_act = rs.random((bi, R)) < 0.5
    old = rs.integers(0, 2**63, size=(2, bj, R), dtype=np.int64)
    cand = rs.integers(0, 2**63, size=(2, bi, R), dtype=np.int64)
    vec = [rs.normal(size=(n, R, 3)).astype(np.float32) for n in (bj, bi)]

    def planes(x):  # int64 -> crt_tpu's four uint32 planes
        u = x.view(np.uint64)
        return [jnp.asarray((u[k] >> np.uint64(s)).astype(np.uint32))
                for k in (0, 1) for s in (32, 0)]

    jout, _, _, jdrop = jshade_iter._place_children(
        [jnp.asarray(vec[0])] + planes(old), jnp.asarray(dead),
        jnp.asarray(cand_act), [jnp.asarray(vec[1])] + planes(cand),
        jnp.zeros((), jnp.int32))
    tout, _, _, tdrop = shade_iter._place_children(
        [torch.from_numpy(vec[0])] + [torch.from_numpy(p) for p in old],
        torch.from_numpy(dead), torch.from_numpy(cand_act),
        [torch.from_numpy(vec[1])] + [torch.from_numpy(p) for p in cand],
        torch.zeros((), dtype=torch.int32))
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    for k in (0, 1):
        hi, lo = (np.asarray(jout[1 + 2 * k + j]).astype(np.uint64)
                  for j in (0, 1))
        np.testing.assert_array_equal(tout[1 + k].numpy().view(np.uint64),
                                      (hi << np.uint64(32)) | lo)
    assert int(tdrop) == int(jdrop)


def _agree(got, want):
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(-1)
    assert float(close.mean()) >= PIXEL_SHARE, (
        f"{close.mean():.4f} of pixels agree, max |diff| "
        f"{np.abs(got - want).max()}")


def _gi_case(case):
    """(scene, settings kwargs, salt) of an image case: K = 2, depth 2."""
    glass = case == "iter_glass"
    kw = dict(max_ray_depth=2, diffuse_reflection_ray_count=2,
              wavefront="recursive" if case == "recursive" else "auto")
    return (dict(width=48, height=32, num_quads=8, with_refractive=glass),
            kw, 5 if case == "iter_salted" else None)


@functools.lru_cache(maxsize=None)
def _crt_tpu_image(case):
    scene_kw, kw, salt = _gi_case(case)
    return np.asarray(crt_tpu.render_image(
        jmake_test_scene(**scene_kw).replace(gi_on=True),
        crt_tpu.RenderSettings(backend="bruteforce", **kw),
        gi_salt=None if salt is None else jnp.uint32(salt)))


@pytest.mark.parametrize("backend", ["cluster", "bruteforce", "pallas_stream"])
@pytest.mark.parametrize("case", ["iter_glass", "recursive", "iter_salted"])
def test_gi_image_matches_crt_tpu(case, backend):
    """The GI image (K = 2, depth 2) through each of the port's backends vs
    crt_tpu's on the same seeded scene: the bank pool with glass, the
    recursive tree, and a salted pass of the pool."""
    scene_kw, kw, salt = _gi_case(case)
    got = render_image(make_test_scene(**scene_kw, gi_on=True, device="cpu"),
                       RenderSettings(backend=backend, **kw),
                       gi_salt=salt).numpy()
    _agree(got, _crt_tpu_image(case))
    assert got.mean() > 0.05


def test_gi_iter_unbiased_vs_recursive_zscores():
    """The bank pool's forked streams against the recursive tree's
    depth-first draws (tests/test_gi_oracle.py:270): N salted frames per
    wavefront; the per-pixel difference of means within 6 combined sigma
    almost everywhere, and the grand means within 2 %."""
    scene = make_test_scene(32, 24, num_quads=4, gi_on=True, device="cpu")
    N = 24
    common = dict(backend="bruteforce", max_ray_depth=2,
                  diffuse_reflection_ray_count=2)
    rec, it = [], []
    for k in range(N):
        rec.append(render_image(scene, RenderSettings(
            wavefront="recursive", **common), gi_salt=k).double().numpy())
        it.append(render_image(scene, RenderSettings(
            wavefront="iter", **common), gi_salt=k).double().numpy())
    rec, it = np.stack(rec), np.stack(it)
    var = rec.var(0, ddof=1) + it.var(0, ddof=1)
    se = np.sqrt(var / N + 1e-6**2)
    z = np.abs(rec.mean(0) - it.mean(0)) / se
    assert float((z > 6.0).mean()) < 0.002, z.max()
    np.testing.assert_allclose(rec.mean(), it.mean(), rtol=2e-2)
    assert var.max() > 0  # the samples do vary


@pytest.fixture(scope="module")
def gi_scene():
    """tests/test_progressive.py's scene and settings."""
    scene = make_test_scene(24, 16, num_quads=4, with_reflective=False,
                            gi_on=True, device="cpu")
    return scene, RenderSettings(backend="bruteforce", max_ray_depth=1,
                                 diffuse_reflection_ray_count=2)


def test_progressive_pass0_bit_exact(gi_scene):
    scene, st = gi_scene
    assert torch.equal(render_progressive(scene, st, passes=1),
                       render_image(scene, st))


def test_progressive_salted_passes_decorrelate(gi_scene):
    scene, st = gi_scene
    a, b, c = (render_image(scene, st, gi_salt=s) for s in range(3))
    assert not torch.equal(a, b) and not torch.equal(b, c)
    assert torch.equal(b, render_image(scene, st, gi_salt=1))


def test_progressive_is_mean_of_salted_passes(gi_scene):
    scene, st = gi_scene
    imgs = torch.stack([render_image(scene, st, gi_salt=p)
                        for p in range(3)])
    seen = []
    prog = render_progressive(scene, st, passes=3,
                              callback=lambda p, m: seen.append(p))
    torch.testing.assert_close(prog, imgs.mean(0), rtol=0, atol=1e-6)
    assert seen == [0, 1, 2]


def test_progressive_checkpoint_resume(gi_scene, tmp_path):
    scene, st = gi_scene
    ckpt = str(tmp_path / "prog")
    partial = render_progressive(scene, st, passes=2, checkpoint_dir=ckpt,
                                 checkpoint_every=1)
    assert partial is not None
    seen = []
    resumed = render_progressive(scene, st, passes=4, checkpoint_dir=ckpt,
                                 checkpoint_every=1,
                                 callback=lambda p, m: seen.append(p))
    assert seen == [2, 3]  # passes 0 and 1 came from the checkpoint
    torch.testing.assert_close(
        resumed, render_progressive(scene, st, passes=4), rtol=0, atol=1e-6)


def test_progressive_unsalted_render_unchanged(gi_scene):
    """gi_salt=None and salt 0 render the same bits."""
    scene, st = gi_scene
    assert torch.equal(render_image(scene, st),
                       render_image(scene, st, gi_salt=0))


GI_GROUPS = ("vertices", "light_intensity", "cam_position")


@pytest.mark.parametrize("wavefront", ["auto", "recursive"])
def test_gi_grads_match_jax(wavefront):
    """value_and_grad of a weighted GI image sum (K = 2, depth 1) vs
    jax.grad of crt_tpu's render: the samples are constants, the gradient
    flows through the traced children as through mirror bounces."""
    jscene = jmake_test_scene(16, 12, num_quads=4).replace(gi_on=True)
    arrays = trainable(jscene, GI_GROUPS)
    kw = dict(max_ray_depth=1, diffuse_reflection_ray_count=2,
              wavefront=wavefront)
    v, g = torch_value_and_grads(carry(jscene), arrays, RenderSettings(**kw))
    jst = crt_tpu.RenderSettings(backend="bruteforce", **kw)

    @jax.jit
    def loss(p):
        img = crt_tpu.render_image(jscene.replace(**p), jst, jit=False)
        return jnp.sum(img * jnp.asarray(weights(img.shape)))

    jv, jg = jax.value_and_grad(loss)(
        {k: jnp.asarray(x) for k, x in arrays.items()})
    jg = {k: np.asarray(x) for k, x in jg.items()}
    np.testing.assert_allclose(v, float(jv), rtol=1e-5)
    for k in GI_GROUPS:
        assert np.isfinite(g[k]).all() and np.abs(jg[k]).max() > 0, k
        np.testing.assert_allclose(
            g[k], jg[k], rtol=ITER_RTOL,
            atol=ITER_ATOL_SCALE * float(np.abs(jg[k]).max()), err_msg=k)


@pytest.mark.parametrize("remat", [False, True])
def test_gi_grads_with_live_lane_bounces(monkeypatch, remat):
    """The GI gradient (K = 2, depth 2) with every bounce past the camera
    rays' shaded on its live lanes vs full-width, with and without
    ``remat_shading``: the image and the gradients bit for bit
    (``index_select`` / ``index_copy`` on distinct lanes pass each lane's
    cotangent on unchanged, and a dead lane's is 0)."""
    scene = make_test_scene(64, 48, num_quads=4, gi_on=True, device="cpu")
    st = RenderSettings(max_ray_depth=2, diffuse_reflection_ray_count=2,
                        remat_shading=remat)
    w = torch.from_numpy(weights((scene.height, scene.width, 3)))
    out = {}
    for share in (1.0, -1.0):
        monkeypatch.setattr(shade_iter, "_COMPACT_MAX_LIVE", share)
        params = {k: getattr(scene, k).detach().clone().requires_grad_(True)
                  for k in GI_GROUPS}
        img = render_image(scene.replace(**params), st)
        (img * w).sum().backward()
        out[share] = img.detach(), {k: p.grad for k, p in params.items()}
    assert torch.equal(out[1.0][0], out[-1.0][0])
    for k in GI_GROUPS:
        got, want = out[1.0][1][k], out[-1.0][1][k]
        assert float(want.abs().max()) > 0, k
        assert torch.equal(got, want), k


def gi_walls_scene_dict():
    """A back wall filling the view and a floor below it, both far larger
    than the view, GI on, one light.  The crease and the quads' diagonals
    lie outside the view, so every primary hit and all but a sliver of the
    GI hits (the wall's downward samples land on the floor) lie far from
    an edge, and a small step moves no hit to another triangle."""
    return {
        "settings": {"background_color": [0, 0, 0], "gi_on": True,
                     "image_settings": {"width": 16, "height": 12}},
        "camera": {"matrix": [1, 0, 0, 0, 1, 0, 0, 0, 1],
                   "position": [0, 0, 3]},
        "materials": [{"type": "diffuse", "albedo": [0.7, 0.5, 0.3],
                       "smooth_shading": False},
                      {"type": "diffuse", "albedo": [0.3, 0.6, 0.4],
                       "smooth_shading": False}],
        "lights": [{"intensity": 800, "position": [1.0, 2.0, 2.0]}],
        "objects": [{"material_index": 0,
                     "vertices": [-50, -47, -1, 61, -47, -1, -50, 53, -1,
                                  61, 53, -1],
                     "triangles": [0, 1, 2, 2, 1, 3]},
                    {"material_index": 1,
                     "vertices": [-53, -5, -43, -53, -5, 57, 61, -5, -43,
                                  61, -5, 57],
                     "triangles": [0, 1, 2, 2, 1, 3]}],
    }


@pytest.mark.parametrize("group", ["light_intensity", "light_position",
                                   "vertices"])
def test_gi_grads_match_finite_differences(group):
    """Central differences with test_torch_grad.py's eps sweep on the GI
    walls (K = 2, depth 1): each coordinate may pick its best step."""
    jscene = jscene_from_dict(gi_walls_scene_dict(), build_accel=False)
    assert jscene.gi_on
    tscene = carry(jscene)
    arrays = trainable(jscene, (group,))
    st = RenderSettings(backend="bruteforce", max_ray_depth=1,
                        diffuse_reflection_ray_count=2)
    _, grads = torch_value_and_grads(tscene, arrays, st)
    indices, eps, rtol = FD_CASES[group]
    if group == "vertices":  # the z of the wall corners in view, the floor y
        indices = [2, 5, 8, 13, 16, 19, 22]
    w = torch.from_numpy(weights((tscene.height, tscene.width, 3)))

    def loss(x):
        with torch.no_grad():
            img = render_image(
                tscene.replace(**{group: torch.from_numpy(x)}), st)
            return float((img * w).sum())

    x0 = arrays[group]
    checked = 0
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
        checked += abs(an) > 1e-3
    assert checked > 0


def test_cli_gi_rays(tmp_path):
    """--gi-rays sets the samples a diffuse hit: the CLI's PPM is the
    render at that K, and differs from the default K's."""
    import json

    from crt_tpu_torch.io.ppm import write_ppm
    from crt_tpu_torch.scene.json_loader import load_scene
    from crt_tpu_torch.scene.procedural import make_test_scene_dict

    path = tmp_path / "gi.crtscene"
    path.write_text(json.dumps(make_test_scene_dict(32, 24, num_quads=4,
                                                    gi_on=True)))
    out = tmp_path / "gi.ppm"
    assert cli.main([str(path), str(out), "--gi-rays", "1", "--device",
                     "cpu"]) == 0
    scene = load_scene(str(path), device="cpu")
    for k, equal in ((1, True), (4, False)):
        write_ppm(render_image(scene, RenderSettings(
            diffuse_reflection_ray_count=k)).numpy(), str(tmp_path / "r.ppm"))
        assert ((tmp_path / "r.ppm").read_text() == out.read_text()) == equal

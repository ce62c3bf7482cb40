"""crt_tpu_torch cluster tables and Phase A binning vs crt_tpu.pallas_trace.

Tolerances: EXACT everywhere.  The tables and the binning are the same fp32
op sequences as crt_tpu's (3-term sums left to right, correctly rounded
square roots), and the JAX side runs eagerly, one XLA op per call, so XLA
contracts no multiply-add into an FMA.  Cluster lists must be identical
entry for entry: the walk order decides exact-t ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crt_tpu import renderer as jrenderer
from crt_tpu.ops import camera as jcamera
from crt_tpu.ops import intersect as jintersect
from crt_tpu.ops import pallas_trace as jpt
from crt_tpu.scene.procedural import make_test_scene as jmake_test_scene
from crt_tpu_torch.ops import binning as tbin
from crt_tpu_torch.ops import cluster_tables as tct
from crt_tpu_torch.scene.procedural import make_test_scene


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs one worker per core, and torch's
    default (a thread per core in every worker) oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SCENES = {
    "default": dict(width=64, height=36, num_quads=8),
    "edges": dict(width=96, height=64, num_quads=16, with_edges=True),
}


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", params=sorted(SCENES))
def wavefronts(request):
    """Both scenes plus primary / bounce / shadow wavefronts as NumPy."""
    kw = SCENES[request.param]
    js, ts = jmake_test_scene(**kw), make_test_scene(**kw, device="cpu")
    rx, ry, _ = jrenderer.make_tiler(js.height, js.width)
    o, d = jcamera.generate_rays(js.cam_position, js.cam_rotation,
                                 js.cam_tan_half_fov, js.width, js.height,
                                 rx, ry)
    o, d = np.asarray(o), np.asarray(d)
    td = jintersect.build_triangle_data(
        js.vertices, js.tri_vidx, js.mat_backface[js.tri_material])
    hit = jintersect.closest_hit_bruteforce(td, jnp.asarray(o), jnp.asarray(d))
    tri, t = np.asarray(hit.tri), np.asarray(hit.t)
    valid = tri >= 0
    point = (o + d * np.where(valid, t, 0.0)[:, None]).astype(np.float32)
    n = np.zeros_like(point)
    n[:, 1] = 1.0
    bounce_o = (point + 1e-2 * n).astype(np.float32)
    bounce_d = (d * np.array([1, -1, 1], np.float32)).astype(np.float32)
    bounce_act = valid & (np.arange(len(o)) % 4 != 0)
    shadow_o = (point + 1e-2 * n).astype(np.float32)
    lights = np.asarray(js.light_position)
    shadow_act = np.stack([valid, valid & (point[:, 0] > 0)])
    return dict(js=js, ts=ts, o=o, d=d, bounce=(bounce_o, bounce_d, bounce_act),
                shadow=(shadow_o, lights, shadow_act))


def test_morton_order_bit_equal():
    pts = np.random.default_rng(1).normal(size=(500, 3)).astype(np.float32)
    pts[:40] = pts[0]  # equal codes: the stable order must agree too
    np.testing.assert_array_equal(
        tct.morton_order(T(pts)).numpy(),
        np.asarray(jpt.morton_order(jnp.asarray(pts))),
    )


def test_cluster_tables_and_rows_bit_equal(wavefronts):
    js, ts = wavefronts["js"], wavefronts["ts"]
    jt, tt = jpt.build_cluster_tables(js), tct.build_cluster_tables(ts)
    for f in jpt.ClusterTables._fields:
        a, b = np.asarray(getattr(jt, f)), getattr(tt, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    np.testing.assert_array_equal(
        tct.emit_rows_table(ts, tt).numpy(),
        np.asarray(jpt.emit_rows_table(js, jt)),
    )


def _assert_lists_equal(jout, tout):
    jcl, jcnt = np.asarray(jout[0])[:, 0], np.asarray(jout[1])
    tcl, tcnt = tout[0].numpy(), tout[1].numpy()
    np.testing.assert_array_equal(tcnt, jcnt)
    np.testing.assert_array_equal(tcl, jcl)


@pytest.mark.parametrize("wave", ["primary", "primary_active", "bounce"])
def test_bin_rays_identical(wavefronts, wave):
    js, ts = wavefronts["js"], wavefronts["ts"]
    jt, tt = jpt.build_cluster_tables(js), tct.build_cluster_tables(ts)
    if wave == "bounce":
        o, d, act = wavefronts["bounce"]
    else:
        o, d = wavefronts["o"], wavefronts["d"]
        act = None if wave == "primary" else np.ones(len(o), bool)
    jout = jpt.bin_rays(jt, jnp.asarray(o), jnp.asarray(d), 1024,
                        None if act is None else jnp.asarray(act))
    tout = tbin.bin_rays(tt, T(o), T(d), 1024,
                         None if act is None else T(act))
    _assert_lists_equal(jout, tout)
    assert tout[1].sum() > 0


@pytest.mark.parametrize("slack", [0.0, 2e-2])
def test_bin_apex_shared_identical(wavefronts, slack):
    js, ts = wavefronts["js"], wavefronts["ts"]
    jt, tt = jpt.build_cluster_tables(js), tct.build_cluster_tables(ts)
    so, lights, act = wavefronts["shadow"]
    jout = jpt.bin_apex_shared(jt, jnp.asarray(so), jnp.asarray(lights),
                               jnp.asarray(act), 1024, slack)
    tout = tbin.bin_apex_shared(tt, T(so), T(lights), T(act), 1024, slack)
    _assert_lists_equal(jout, tout)
    # some tiles are culled to an empty list, some are not
    assert (tout[1] == 0).any() and (tout[1] > 0).any()


@pytest.mark.parametrize("t_lo_clamp", [True, False])
def test_frustum_box_mask_both_branches(t_lo_clamp):
    rng = np.random.default_rng(7)
    o_lo = rng.uniform(-5, 5, (64, 3)).astype(np.float32)
    o_hi = (o_lo + rng.uniform(0, 2, (64, 3))).astype(np.float32)
    d_lo = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    d_hi = (d_lo + rng.uniform(0, 0.5, (64, 3))).astype(np.float32)
    bmin = rng.uniform(-8, 8, (40, 3)).astype(np.float32)
    bmax = (bmin + rng.uniform(0, 3, (40, 3))).astype(np.float32)
    cap = np.float32(1.0 + 1e-4)
    for t_cap in (None, cap):
        a = np.asarray(jpt._frustum_box_mask(
            *map(jnp.asarray, (o_lo, o_hi, d_lo, d_hi, bmin, bmax)),
            t_cap=None if t_cap is None else jnp.float32(t_cap),
            t_lo_clamp=t_lo_clamp))
        b = tbin._frustum_box_mask(
            *map(T, (o_lo, o_hi, d_lo, d_hi, bmin, bmax)),
            t_cap=None if t_cap is None else float(t_cap),
            t_lo_clamp=t_lo_clamp).numpy()
        np.testing.assert_array_equal(b, a)
        assert a.any() and not a.all()


def test_cone_and_wedge_masks_identical():
    rng = np.random.default_rng(11)
    apex = rng.uniform(-5, 5, (32, 3)).astype(np.float32)
    w_lo = rng.uniform(-6, 6, (32, 3)).astype(np.float32)
    w_hi = (w_lo + rng.uniform(0, 1.5, (32, 3))).astype(np.float32)
    cl_min = rng.uniform(-8, 8, (50, 3)).astype(np.float32)
    cl_max = (cl_min + rng.uniform(0, 2, (50, 3))).astype(np.float32)
    s = np.float32(2e-2)
    for jf, tf in ((jpt._apex_cone_mask, tbin._apex_cone_mask),
                   (jpt._apex_wedge_mask, tbin._apex_wedge_mask)):
        a = np.asarray(jf(*map(jnp.asarray, (apex, w_lo, w_hi, cl_min,
                                             cl_max)), jnp.float32(s)))
        b = tf(*map(T, (apex, w_lo, w_hi, cl_min, cl_max)), float(s)).numpy()
        np.testing.assert_array_equal(b, a)
        assert a.any() and not a.all()


def test_full_line_slab_negative_t_regression():
    """The four-corner branch keeps a beyond-the-light box a real shadow
    ray reaches (the 11-01-scene8 counterexample of crt_tpu's
    test_shadow_binning.py); the capped branch still culls it."""
    apex = T(np.float32([[-9.0, 16.0, 0.0]]))
    o_lo = T(np.float32([[-14.999211, 19.18162, -14.990004]]))
    o_hi = T(np.float32([[-8.026135, 19.996952, -1.5759029]]))
    s = float(np.float32(2e-2))
    w_lo, w_hi = (o_lo - s) - apex, (o_hi + s) - apex
    bmin = T(np.float32([[-10.77794, 1.17625, 7.105974]]))
    bmax = T(np.float32([[-4.336956, 5.924379, 14.02273]]))
    cap = float(np.float32(1.0 + 1e-4))
    ok = tbin._frustum_box_mask(apex, apex, w_lo, w_hi, bmin - 2 * s,
                                bmax + 2 * s, t_cap=cap, t_lo_clamp=False)
    assert bool(ok[0, 0])
    capped = tbin._frustum_box_mask(apex, apex, w_lo, w_hi, bmin - 2 * s,
                                    bmax + 2 * s, t_cap=cap)
    assert not bool(capped[0, 0])

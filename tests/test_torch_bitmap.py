"""Bitmap textures of crt_tpu_torch vs crt_tpu: the copy of the JPEG
decoder, the loader, ``sample_textures``, images and the gradient into
``bitmap_data``.

The JAX side runs in process and eagerly (``jit=False``, as in
tests/test_torch_grad.py): eager XLA contracts no multiply-add, so both
sides round every op alike and a texel index, an integer function of one
f32 product ``u * w``, comes out the same.  Tolerances:
  - the decoder: byte for byte; the loader's packed arrays: exact;
  - ``sample_textures`` on the same inputs: bit for bit;
  - images: rtol 1e-5 / atol 1e-6 (equal bit for bit when this was
    written); GI images by pixel share, as tests/test_torch_gi.py;
  - the gradient into ``bitmap_data`` and the vertices vs jax.grad:
    tests/test_torch_grad.py's rtol 1e-5 / atol 2e-6 of the group's
    largest entry (the backward sums per-pixel cotangents in another
    order);
  - vs central differences: a texel read is linear in ``bitmap_data``,
    and so is this scene's image in a floor texel (no GI: no path reads
    the floor twice), so the quotient is exact up to the f32 rounding of
    the image: rtol 1e-3.
"""

import functools
import pathlib
import shutil
import sys

import numpy as np
import pytest
import torch

import crt_tpu
from crt_tpu.io import jpeg_stb as jjpeg
from crt_tpu.ops.texture import sample_textures as jsample_textures
from crt_tpu.scene import json_loader as jloader
from crt_tpu_torch import RenderSettings, load_scene, render_image
from crt_tpu_torch import scene_from_dict
from crt_tpu_torch.io import jpeg_stb as tjpeg
from crt_tpu_torch.ops import segsum
from crt_tpu_torch.ops.texture import sample_textures
from crt_tpu_torch.scene import json_loader as tloader
from crt_tpu_torch.scene.procedural import make_test_scene_dict
from test_torch_grad import jax_value_and_grads, weights
from torch_port_fixtures import _one_torch_thread, _release_heap  # noqa: F401

PREVIEWS = pathlib.Path(__file__).resolve().parents[1] / "docs" / "previews"
JPEGS = sorted(p.name for p in PREVIEWS.glob("*.jpg"))
BITMAP = "12-01-textures.jpg"  # 640x360, baseline
KEYS = ("bitmap_data", "vertices")


def bitmap_scene_dict(**kw):
    """make_test_scene_dict's scene, its floor textured by BITMAP."""
    kw = dict(dict(width=64, height=48, num_quads=8), **kw)
    return make_test_scene_dict(floor_bitmap=BITMAP, **kw)


def both_scenes(data, root=PREVIEWS):
    return (jloader.scene_from_dict(data, asset_root=str(root),
                                    build_accel=False),
            scene_from_dict(data, asset_root=str(root), device="cpu"))


def test_the_previews_are_there():
    assert len(JPEGS) == 9, JPEGS


@pytest.mark.parametrize("name", JPEGS)
def test_jpeg_copy_matches_crt_tpu(name):
    path = str(PREVIEWS / name)
    got = tjpeg.decode_file(path)
    assert got.dtype == np.uint8 and got.ndim == 3 and got.shape[2] == 3
    np.testing.assert_array_equal(got, jjpeg.decode_file(path))


def _pil_jpeg(path, **kw):
    from PIL import Image

    rs = np.random.default_rng(4)
    img = rs.integers(0, 256, (24, 40, 3), dtype=np.uint8)
    Image.fromarray(img).save(path, format="JPEG", **kw)


def test_progressive_jpeg_falls_back_to_pil(tmp_path):
    """A progressive file is refused by both decoders and loaded through
    PIL by both loaders, to the same texels."""
    path = tmp_path / "prog.jpg"
    _pil_jpeg(path, progressive=True, quality=90)
    for mod in (tjpeg, jjpeg):
        with pytest.raises(mod.UnsupportedJPEG):
            mod.decode_file(str(path))
    got = tloader._load_bitmap(str(path))
    assert got.dtype == np.float32 and got.shape == (24, 40, 3)
    np.testing.assert_array_equal(got, jloader._load_bitmap(str(path)))


def test_truncated_jpeg_as_crt_tpu(tmp_path):
    """As tests/test_jpeg_stb.py holds crt_tpu's decoder: a file cut in
    its header raises CorruptJPEG, one cut in its entropy data decodes
    (zero-fed) to the same texels as crt_tpu's."""
    data = (PREVIEWS / BITMAP).read_bytes()
    for mod in (tjpeg, jjpeg):
        with pytest.raises(mod.CorruptJPEG):
            mod.decode(data[:2])
    path = tmp_path / "cut.jpg"
    path.write_bytes(data[:len(data) // 2])
    got = tjpeg.decode_file(str(path))
    assert got.shape == (360, 640, 3)
    np.testing.assert_array_equal(got, jjpeg.decode_file(str(path)))


def test_missing_pil_names_the_file(tmp_path, monkeypatch):
    """PIL is imported only for a file that neither the baseline JPEG
    decoder nor io/png.py takes; where it is missing, the ImportError names
    that file, and a baseline JPEG and a PNG still load."""
    from PIL import Image

    img = np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3) * 9
    bmp, png = tmp_path / "t.bmp", tmp_path / "t.png"
    Image.fromarray(img).save(bmp)
    Image.fromarray(img).save(png)
    assert "PIL" not in vars(tloader)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="t.bmp"):
        tloader._load_bitmap(str(bmp))
    assert tloader._load_bitmap(str(PREVIEWS / BITMAP)).shape == (360, 640, 3)
    np.testing.assert_array_equal(tloader._load_bitmap(str(png)),
                                  img.astype(np.float32) / 255.0)


def test_loader_packs_bitmaps_as_crt_tpu(tmp_path):
    """Two bitmaps of different sizes (a PNG through io/png.py, a JPEG
    through the decoder, its file_path with a leading "/"), packed into [B, Hmax,
    Wmax, 3] with their sizes, the texture table pointing at them."""
    from PIL import Image

    Image.fromarray(np.array([[[255, 0, 0], [0, 255, 0]],
                              [[0, 0, 255], [255, 255, 0]]], np.uint8)
                    ).save(tmp_path / "t.png")
    shutil.copy(PREVIEWS / BITMAP, tmp_path / BITMAP)
    data = bitmap_scene_dict()
    data["textures"] = [
        {"name": "small", "type": "bitmap", "file_path": "t.png"},
        {"name": "floor_bitmap", "type": "bitmap",
         "file_path": "/" + BITMAP},
    ]
    data["materials"][1]["albedo"] = "small"
    js, ts = both_scenes(data, tmp_path)
    assert ts.bitmap_data.shape == (2, 360, 640, 3)
    for f in ("bitmap_data", "bitmap_size", "tex_bitmap", "tex_type",
              "mat_albedo_tex"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    assert ts.texture_types_present == js.texture_types_present


def test_load_scene_reads_bitmaps_beside_the_file(tmp_path):
    import json

    shutil.copy(PREVIEWS / BITMAP, tmp_path / BITMAP)
    path = tmp_path / "scene.crtscene"
    path.write_text(json.dumps(bitmap_scene_dict(width=32, height=32)))
    scene = load_scene(str(path), device="cpu")
    assert scene.bitmap_data.shape == (1, 360, 640, 3)
    img = render_image(scene)
    assert torch.isfinite(img).all() and float(img.mean()) > 0


def _sample_cases(case):
    """(scene dict, asset root, tex_idx, uv, bary_u, bary_v) of a
    sample_textures case."""
    if case == "semantics":
        # tests/test_texture_semantics.py's 2x2 bitmap: x = int(u * w) % w,
        # y = int((1 - v) * h) % h at the quadrant centres, the edges, one
        # wrap and a negative u (clipped)
        uv = [(0.25, 0.75), (0.75, 0.75), (0.25, 0.25), (0.75, 0.25),
              (0.0, 1.0), (0.5, 0.5), (1.0, 0.0), (0.999, 0.001),
              (1.25, 1.75), (-0.25, 0.5)]
        uv = np.asarray([[u, v, 0.0] for u, v in uv], np.float32)
        tex = np.zeros(len(uv), np.int32)
        z = np.zeros(len(uv), np.float32)
        return None, tex, uv, z, z
    rs = np.random.default_rng(11)
    n = 4096
    uv = rs.uniform(-0.5, 4.5, (n, 3)).astype(np.float32)
    uv[:64, :2] = rs.integers(0, 9, (64, 2)) / np.float32(2)  # on edges
    tex = rs.integers(0, 3, n).astype(np.int32)  # bitmap, albedo, albedo
    bu, bv = (rs.uniform(0, 0.5, n).astype(np.float32) for _ in range(2))
    return bitmap_scene_dict(), tex, uv, bu, bv


@pytest.mark.parametrize("case", ["semantics", "random"])
def test_sample_textures_bitmap_bit_exact(case, tmp_path):
    """sample_textures on bitmaps equals crt_tpu's bit for bit on the same
    uv: C truncation, C modulo clipped to the bitmap, the V flip."""
    data, tex, uv, bu, bv = _sample_cases(case)
    root = PREVIEWS
    if data is None:
        from PIL import Image

        Image.fromarray(np.array([[[255, 0, 0], [0, 255, 0]],
                                  [[0, 0, 255], [255, 255, 0]]], np.uint8)
                        ).save(tmp_path / "t.png")
        data = bitmap_scene_dict()
        data["textures"] = [{"name": "b", "type": "bitmap",
                             "file_path": "t.png"}]
        data["materials"][0]["albedo"] = "b"
        root = tmp_path
    js, ts = both_scenes(data, root)
    want = np.asarray(jsample_textures(js, tex, uv, bu, bv))
    got = sample_textures(ts, torch.from_numpy(tex), torch.from_numpy(uv),
                          torch.from_numpy(bu), torch.from_numpy(bv))
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "semantics":
        img = ts.bitmap_data[0, :2, :2].numpy()
        np.testing.assert_array_equal(got[:4].numpy(),
                                      img[[0, 0, 1, 1], [0, 1, 0, 1]])


@functools.lru_cache(maxsize=None)
def _crt_tpu_image(case):
    kw = dict(gi_on=True) if case == "gi" else {}
    js, _ = both_scenes(bitmap_scene_dict(**kw))
    st = dict(max_ray_depth=1, diffuse_reflection_ray_count=2) \
        if case == "gi" else {}
    return np.asarray(crt_tpu.render_image(
        js, crt_tpu.RenderSettings(backend="bruteforce", **st), jit=False))


@pytest.mark.parametrize("case", ["cluster", "bruteforce", "stream",
                                  "recursive_iter", "gi"])
def test_bitmap_image_matches_crt_tpu(case):
    """The bitmap-floored scene through every backend and both wavefronts
    vs crt_tpu's image.  Under GI the pixel share of tests/test_torch_gi.py
    (>= 99.5 % within rtol 1e-4 / atol 1e-5): XLA's and torch's f32 sin /
    cos may turn a hemisphere ray by an ulp."""
    ref = _crt_tpu_image("gi" if case == "gi" else "plain")
    _, ts = both_scenes(bitmap_scene_dict(gi_on=case == "gi"))
    if case == "gi":
        img = render_image(ts, RenderSettings(
            max_ray_depth=1, diffuse_reflection_ray_count=2)).numpy()
        close = np.isclose(img, ref, rtol=1e-4, atol=1e-5).all(-1)
        assert close.mean() >= 0.995, close.mean()
        return
    st = {"cluster": RenderSettings(), "stream":
          RenderSettings(backend="pallas_stream"),
          "bruteforce": RenderSettings(backend="bruteforce"),
          "recursive_iter": RenderSettings(wavefront="iter")}[case]
    img = render_image(ts, st).numpy()
    np.testing.assert_allclose(img, ref, rtol=1e-5, atol=1e-6)
    # the texture is seen: the floor shows many texels
    assert len(np.unique(img.reshape(-1, 3), axis=0)) > 500


def _torch_grads(ts, settings=None):
    params = {k: getattr(ts, k).detach().clone().requires_grad_(True)
              for k in KEYS}
    img = render_image(ts.replace(**params), settings)
    loss = (img * torch.from_numpy(weights(tuple(img.shape)))).sum()
    loss.backward()
    return float(loss.detach()), {k: p.grad.numpy() for k, p in
                                  params.items()}


def test_bitmap_grad_matches_jax():
    js, ts = both_scenes(bitmap_scene_dict())
    v, g = _torch_grads(ts)
    jv, jg = jax_value_and_grads(
        js, {k: np.asarray(getattr(js, k)) for k in KEYS}, "bruteforce")
    np.testing.assert_allclose(v, jv, rtol=1e-6)
    for k in KEYS:
        assert np.abs(jg[k]).max() > 0, k
        np.testing.assert_allclose(g[k], jg[k], rtol=1e-5,
                                   atol=2e-6 * float(np.abs(jg[k]).max()),
                                   err_msg=k)
    # the texels read carry the gradient, the rest none
    assert 100 < int((np.abs(g["bitmap_data"]).sum(-1) > 0).sum()) < 230400


def test_bitmap_grad_matches_finite_differences():
    _, ts = both_scenes(bitmap_scene_dict())
    _, g = _torch_grads(ts)
    g = g["bitmap_data"].reshape(-1)
    w = torch.from_numpy(weights((ts.height, ts.width, 3))).double()
    x0 = ts.bitmap_data.detach()

    def loss(x):
        with torch.no_grad():
            img = render_image(ts.replace(bitmap_data=x))
        return float((img.double() * w).sum())

    order = np.argsort(-np.abs(g))
    picks = list(order[:6]) + list(order[-2:])  # the largest, two zeros
    eps = 0.25
    for idx in picks:
        xp, xm = x0.clone(), x0.clone()
        xp.view(-1)[idx] += eps
        xm.view(-1)[idx] -= eps
        fd = (loss(xp) - loss(xm)) / (2 * eps)
        assert abs(fd - g[idx]) <= 1e-3 * max(abs(g[idx]), 1e-3), (
            idx, g[idx], fd)


def test_bitmap_backward_is_the_segment_sum(monkeypatch):
    """The gradient into bitmap_data goes through segment_accumulate over
    the flattened texel ids (one call per shading level, T = B x Hmax x
    Wmax), with -1 on every ray that reads no texel (misses, dead lanes,
    the quads' flat textures), and not through index_put_."""
    _, ts = both_scenes(bitmap_scene_dict())
    calls, real = [], segsum.segment_accumulate

    def recording(ids, g, num_segments):
        calls.append((ids.clone(), num_segments))
        return real(ids, g, num_segments)

    monkeypatch.setattr(segsum, "segment_accumulate", recording)
    _, g = _torch_grads(ts)
    texel = [ids for ids, T in calls if T == 360 * 640]
    assert len(texel) == 4  # depth 3: four shading levels
    depth0 = texel[-1]  # the backward runs the levels deepest first
    live = depth0 >= 0
    assert 0 < int(live.sum()) < depth0.numel()
    assert int(depth0.max()) < 360 * 640
    # the primary rays that read a texel are the floor's two triangles'
    # hits (the tiles' padding rays too)
    from crt_tpu_torch.ops.camera import generate_rays
    from crt_tpu_torch.renderer import make_tiler, make_trace_fn

    rx, ry, _ = make_tiler(ts.height, ts.width, device="cpu")
    o, d = generate_rays(ts.cam_position, ts.cam_rotation,
                         ts.cam_tan_half_fov, ts.width, ts.height, rx, ry)
    tri = make_trace_fn(ts, RenderSettings())(o.contiguous(), d, None).tri
    assert torch.equal(live, (tri == 0) | (tri == 1))

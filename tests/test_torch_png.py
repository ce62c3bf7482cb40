"""crt_tpu_torch/io/png.py: PNG decode held to PIL, encode, and the two
readers that no longer need PIL (``utils/golden.load_golden`` and the
loader's PNG bitmaps).

Decode must give the bytes of PIL's ``Image.open(p).convert("RGB")``, how
crt_tpu reads goldens and PNG textures, exactly.  The files come from two
writers: the raw writer of ``png_raw.py`` (every colour type x bit depth
x row filter x interlace, each IDAT split into several chunks, ``tRNS``
on the interlaced files of types 0, 2 and 3, and a short ``PLTE`` that
some indices run past) and PIL itself (every mode it writes, with the
filters it chooses).  Every decode case runs through both ways of
undoing the row filters: the C++ pass (``native``, built by g++) and the
NumPy one (``numpy``).
"""

import io
import json
import shutil
import struct
import sys
import warnings
import zlib

import numpy as np
import pytest
from PIL import Image

from crt_tpu.scene.json_loader import scene_from_dict as jscene_from_dict
from crt_tpu_torch.io import png
from crt_tpu_torch.scene.json_loader import scene_from_dict
from crt_tpu_torch.scene.procedural import make_test_scene_dict
from crt_tpu_torch.utils import golden
from png_raw import chunk, raw_png
from torch_port_fixtures import _one_torch_thread, _release_heap  # noqa: F401

# colour type -> (channels, bit depths the standard allows)
DEPTHS = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
          4: (2, (8, 16)), 6: (4, (8, 16))}
CASES = [(c, b) for c, (_, depths) in DEPTHS.items() for b in depths]
FILTERS = [0, 1, 2, 3, 4, "mixed"]
W, H = 13, 11  # odd sizes: partial Adam7 passes, sub-byte row padding
BACKENDS = ["native", "numpy"]


def _pil_rgb(data):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("filt", FILTERS)
@pytest.mark.parametrize("colour,depth", CASES)
def test_decode_matches_pil(colour, depth, filt, interlace, backend):
    ch = DEPTHS[colour][0]
    rng = np.random.default_rng(colour * 100 + depth)
    top = (1 << depth) - 1
    samples = rng.integers(0, top + 1, (H, W, ch)).astype(np.uint16)
    samples[0, :, :] = top  # extremes and a smooth run for the predictors
    samples[1, :, :] = 0
    samples[2] = (np.arange(W)[:, None] * top // (W - 1)).astype(np.uint16)
    palette = trns = None
    if colour == 3:
        # a palette shorter than the index range: the last indices run
        # past PLTE (PIL reads them black)
        n = max(1, min(256, 1 << depth) - 2)
        palette = rng.integers(0, 256, (n, 3)).astype(np.uint8)
        if interlace:
            trns = bytes(rng.integers(0, 256, n // 2 + 1).astype(np.uint8))
    elif colour in (0, 2) and interlace:
        trns = struct.pack(f">{ch}H", *samples[3, 3, :ch].tolist())
    data = raw_png(samples, colour, depth, filt, interlace, palette, trns)
    got = png.decode(data, backend=backend)
    assert got.dtype == np.uint8 and got.shape == (H, W, 3)
    np.testing.assert_array_equal(got, _pil_rgb(data))


PIL_MODES = [("1", {}), ("L", {}), ("LA", {}), ("RGB", {}), ("RGBA", {}),
             ("I;16", {}), ("P", {"bits": 1}), ("P", {"bits": 2}),
             ("P", {"bits": 4}), ("P", {}), ("RGB", {"optimize": True})]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode,opts", PIL_MODES,
                         ids=[f"{m}{o}" for m, o in PIL_MODES])
def test_decode_pil_written(mode, opts, backend):
    """PIL's own files: it picks the row filters (adaptively for 8-bit
    images), the palette size and the 16-bit grey layout."""
    rng = np.random.default_rng(7)
    h, w = 37, 53
    base = np.cumsum(rng.integers(0, 9, (h, w, 4)), axis=1) % 256
    if mode == "I;16":
        im = Image.frombytes("I;16", (w, h),
                             (base[..., 0] * 300).astype("<u2").tobytes())
    elif mode == "P":
        levels = 1 << opts.get("bits", 8)
        im = Image.fromarray((base[..., 0] % levels).astype(np.uint8),
                             "L").convert("P")
        im.putpalette(rng.integers(0, 256, 3 * levels).astype(
            np.uint8).tobytes())
    else:
        src = "L" if mode == "1" else mode
        arr = base[..., :len(src)]
        arr = arr.astype(np.uint8)
        im = Image.fromarray(arr[..., 0] if len(src) == 1 else arr, src)
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, "PNG", **opts)
    data = buf.getvalue()
    np.testing.assert_array_equal(png.decode(data, backend=backend),
                                  _pil_rgb(data))


def test_decode_1080p_wide_mixed_filters():
    """A 1920-wide RGB file with filters 0-4 in turn, as an adaptive
    writer's 1080p golden: both backends give PIL's bytes."""
    rng = np.random.default_rng(19)
    img = (np.cumsum(rng.integers(0, 9, (40, 1920, 3)), axis=1)
           % 256).astype(np.uint16)
    data = raw_png(img, 2, 8, "mixed", 0, idat_size=1 << 16)
    want = _pil_rgb(data)
    np.testing.assert_array_equal(want, img)
    for backend in BACKENDS:
        np.testing.assert_array_equal(png.decode(data, backend=backend),
                                      want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_rejects_a_bad_filter_byte(backend):
    """A filter byte of 7 on the fourth row, after rows that decode."""
    rows = np.zeros((6, 1 + 3 * 4), np.uint8)
    rows[:, 0] = [1, 2, 3, 7, 4, 0]
    data = (png.SIGNATURE + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", 4, 6, 8, 2, 0, 0, 0)) + chunk(
        b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b""))
    with pytest.raises(png.PNGError, match="unknown row filter 7"):
        png.decode(data, backend=backend)


def test_native_backend_where_gxx_exists():
    """Where g++ builds the native library, as here, decode takes the C++
    row filters by default."""
    assert shutil.which("g++"), "this test needs g++, which builds the " \
        "native helpers"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert png.unfilter_backend() == "native"
    with pytest.raises(ValueError):
        png.decode(png.encode(np.zeros((2, 2, 3), np.uint8)), backend="c")


def test_numpy_fallback_warns_once(monkeypatch):
    """Where the library will not build, decode falls back to NumPy and
    says so once, with the compiler's message."""
    from crt_tpu_torch.scene import native_accel

    def fail():
        raise RuntimeError("g++ failed (1):\nno compiler here")

    monkeypatch.setattr(native_accel, "library", fail)
    monkeypatch.setattr(png, "_native", None)
    img = np.arange(6 * 5 * 3, dtype=np.uint8).reshape(6, 5, 3)
    data = raw_png(img.astype(np.uint16), 2, 8, "mixed", 0)
    with pytest.warns(RuntimeWarning, match="no compiler here"):
        np.testing.assert_array_equal(png.decode(data), img)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert png.unfilter_backend() == "numpy"
        np.testing.assert_array_equal(png.decode(data), img)
    with pytest.raises(RuntimeError):
        png.decode(data, backend="native")


def test_encode_round_trip_and_pil_reads_it(tmp_path):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (27, 41, 3)).astype(np.uint8)
    path = tmp_path / "x.png"
    png.write_png(img, path)
    np.testing.assert_array_equal(png.read_png(path), img)
    with Image.open(path) as im:
        assert im.mode == "RGB" and im.size == (41, 27)
        np.testing.assert_array_equal(np.asarray(im), img)
    with pytest.raises(ValueError):
        png.encode(img.astype(np.float32))


@pytest.mark.parametrize("fault", ["crc", "truncated", "signature",
                                   "filter"])
def test_decode_rejects_corrupt_files(fault):
    img = np.arange(5 * 4 * 3, dtype=np.uint8).reshape(5, 4, 3)
    data = bytearray(png.encode(img))
    if fault == "crc":
        data[-20] ^= 1  # a byte inside the IDAT chunk
    elif fault == "truncated":
        data = data[:-30]
    elif fault == "signature":
        data[1] = ord("Q")
    else:  # a filter byte of 5 inside the compressed rows
        rows = np.zeros((5, 13), np.uint8)
        rows[:, 0] = 5
        data = (png.SIGNATURE + chunk(b"IHDR", struct.pack(
            ">IIBBBBB", 4, 5, 8, 2, 0, 0, 0)) + chunk(
            b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b""))
    with pytest.raises(png.PNGError):
        png.decode(bytes(data))


def _block_pil(m):
    """Make PIL unimportable under the monkeypatch context ``m``, as on a
    machine without it."""
    for name in [k for k in sys.modules if k == "PIL" or k.startswith("PIL.")]:
        m.delitem(sys.modules, name)
    m.setitem(sys.modules, "PIL", None)


def test_load_golden_without_pil(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    img = np.cumsum(rng.integers(0, 7, (24, 40, 3)), axis=0).astype(np.uint8)
    (tmp_path / "results" / "png").mkdir(parents=True)
    path = tmp_path / "results" / "png" / "case.png"
    Image.fromarray(img).save(path)  # PIL's adaptive filters
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB"), np.float32) / 255.0
    monkeypatch.setenv("CRT_REFERENCE", str(tmp_path))
    with monkeypatch.context() as m:
        _block_pil(m)
        with pytest.raises(ImportError):
            import PIL  # noqa: F401
        got = golden.load_golden("case")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["rgb_adaptive", "palette", "grey16",
                                  "interlaced"])
def test_png_bitmap_without_pil(tmp_path, monkeypatch, kind):
    """A .crtscene with a PNG bitmap texture: the port, with PIL blocked,
    loads the same bitmap_data as crt_tpu's loader (which reads it with
    PIL)."""
    rng = np.random.default_rng(11)
    tex = np.cumsum(rng.integers(0, 9, (19, 23, 3)), axis=1).astype(np.uint8)
    path = tmp_path / "tex.png"
    if kind == "rgb_adaptive":
        Image.fromarray(tex).save(path)
    elif kind == "palette":
        Image.fromarray(tex).convert("P").save(path, bits=4)
    elif kind == "grey16":
        samples = (tex[..., :1].astype(np.uint16) * 3)
        path.write_bytes(raw_png(samples, 0, 16, "mixed", 0))
    else:
        path.write_bytes(raw_png(tex.astype(np.uint16), 2, 8, 4, 1))
    d = make_test_scene_dict(24, 16, num_quads=2, floor_bitmap="tex.png")
    ref = np.asarray(jscene_from_dict(json.loads(json.dumps(d)),
                                      asset_root=str(tmp_path)).bitmap_data)
    with monkeypatch.context() as m:
        _block_pil(m)
        scene = scene_from_dict(d, asset_root=str(tmp_path), device="cpu")
    np.testing.assert_array_equal(scene.bitmap_data.numpy(), ref)

"""PNG decode and encode with the standard library and NumPy (no PIL).

``decode`` gives ``uint8 [H, W, 3]`` with the bytes that PIL's
``Image.open(p).convert("RGB")`` gives, which is how crt_tpu reads a
golden image and a PNG bitmap texture.  It reads every colour type (0
grey, 2 RGB, 3 palette, 4 grey + alpha, 6 RGBA) at every bit depth the
standard allows for it, all five row filters, Adam7 interlacing and any
number of ``IDAT`` chunks, and checks every chunk's CRC.  Alpha and
``tRNS`` are dropped.  The conversions are PIL's:

- grey at 1, 2 and 4 bits is scaled to 8 bits (x 255, x 85, x 17);
- 16-bit grey is clamped to 255 (PIL reads it as ``I;16``), where every
  other 16-bit sample keeps its high byte;
- a palette index past the end of ``PLTE`` reads black (PIL pads the
  palette with zeros).

The row filters are undone in C++ (``png_unfilter.cpp``, in the library
``scene/native_accel.py`` builds with g++ at first use).  Where that
library will not build, a NumPy version gives the same bytes, and the
first decode says so with a warning that carries g++'s message;
``unfilter_backend()`` tells which one runs.

``encode`` writes ``uint8 [H, W, 3]`` as 8-bit RGB, filter 0, one
``IDAT``.
"""

from __future__ import annotations

import struct
import subprocess
import warnings
import zlib

import numpy as np

__all__ = ["PNGError", "decode", "read_png", "encode", "write_png",
           "unfilter_backend"]

SIGNATURE = b"\x89PNG\r\n\x1a\n"

# colour type -> (samples a pixel, allowed bit depths)
_COLOUR_TYPES = {
    0: (1, (1, 2, 4, 8, 16)),
    2: (3, (8, 16)),
    3: (1, (1, 2, 4, 8)),
    4: (2, (8, 16)),
    6: (4, (8, 16)),
}

# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


class PNGError(ValueError):
    """The data is not a PNG file this decoder can read."""


def _chunks(data: bytes):
    """Yield (type, payload) of every chunk, checking lengths and CRCs."""
    if data[:8] != SIGNATURE:
        raise PNGError("not a PNG file (bad signature)")
    pos = 8
    while pos < len(data):
        if pos + 12 > len(data):
            raise PNGError("truncated chunk header")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise PNGError(f"truncated {ctype!r} chunk")
        payload = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(ctype + payload) != crc:
            raise PNGError(f"CRC mismatch in {ctype!r} chunk")
        yield ctype, payload
        if ctype == b"IEND":
            return
        pos = end + 4
    raise PNGError("no IEND chunk")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


# the native row filters: None before the first decode, the C entry point
# once loaded, False where the library will not build
_native = None


def _native_unfilter():
    """The C entry point ``crt_png_unfilter``, or None (warned once) where
    the native library will not build."""
    global _native
    if _native is None:
        from crt_tpu_torch.scene import native_accel

        try:
            _native = native_accel.library().crt_png_unfilter
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            warnings.warn(f"PNG row filters fall back to NumPy: the native "
                          f"library will not build: {e}", RuntimeWarning,
                          stacklevel=3)
            _native = False
    return _native or None


def unfilter_backend() -> str:
    """``"native"`` where the C++ row filters load (building them at first
    use), else ``"numpy"``."""
    return "native" if _native_unfilter() else "numpy"


def _unfilter(raw: np.ndarray, bpp: int, backend: str) -> np.ndarray:
    """Undo the row filters of one (sub-)image: ``raw`` is uint8 [H, 1 +
    L], each row its filter byte and L filtered bytes; ``bpp`` the bytes a
    complete pixel (1 below 8 bits).  Returns uint8 [H, L]."""
    if backend == "numpy":
        return _unfilter_numpy(raw, bpp)
    fn = _native_unfilter()
    if fn is None:
        raise RuntimeError("the native PNG row filters will not build")
    raw = np.ascontiguousarray(raw)
    h, l1 = raw.shape
    out = np.empty((h, l1 - 1), np.uint8)
    bad = fn(raw.ctypes.data, h, l1 - 1, bpp, out.ctypes.data)
    if bad:
        raise PNGError(f"unknown row filter {bad}")
    return out


def _unfilter_numpy(raw: np.ndarray, bpp: int) -> np.ndarray:
    """The plain version of ``_unfilter``, the same bytes.

    A byte depends on its left, upper and upper-left neighbours, so the
    pixels of an anti-diagonal (row + column constant) are independent:
    the rows are undone together, one diagonal at a time, each with its
    own filter (H + L / bpp steps of NumPy work instead of H * L / bpp
    Python steps)."""
    h, l1 = raw.shape
    filters = raw[:, 0]
    if int(filters.max()) > 4:
        raise PNGError(f"unknown row filter {int(filters.max())}")
    if not filters.any():  # filter 0 (None) on every row
        return raw[:, 1:]
    n = (l1 - 1) // bpp
    src = raw[:, 1:].reshape(h * n, bpp).astype(np.int16)
    # flat [(H + 1) * (n + 1), bpp]: a row and a pixel of zeros above and
    # left of the image
    w1 = n + 1
    out = np.zeros(((h + 1) * w1, bpp), np.int16)
    zero = np.zeros(bpp, np.int16)
    for d in range(h + n - 1):
        r = np.arange(max(0, d - n + 1), min(h - 1, d) + 1)
        j = d - r
        k = (r + 1) * w1 + j + 1
        a, b, c = out[k - 1], out[k - w1], out[k - w1 - 1]
        pred = np.choose(filters[r, None],
                         (zero, a, b, (a + b) >> 1, _paeth(a, b, c)))
        out[k] = (src[r * n + j] + pred) & 0xFF
    return out.reshape(h + 1, w1, bpp)[1:, 1:].reshape(h, n * bpp).astype(
        np.uint8)


def _samples(rows: np.ndarray, width: int, depth: int,
             channels: int) -> np.ndarray:
    """Unfiltered rows uint8 [H, L] -> samples [H, W, channels] (uint16
    at 16 bits, else uint8; sub-byte samples unpacked, not scaled)."""
    h = rows.shape[0]
    if depth == 16:
        s = rows.reshape(h, -1, 2).astype(np.uint16)
        s = (s[..., 0] << 8) | s[..., 1]
    elif depth == 8:
        s = rows
    else:
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        s = (bits * weights).sum(axis=-1, dtype=np.uint8)
    return s[:, :width * channels].reshape(h, width, channels)


def _to_rgb(s: np.ndarray, colour: int, depth: int,
            palette: np.ndarray | None) -> np.ndarray:
    """Samples -> uint8 RGB as PIL's ``convert("RGB")``."""
    if colour == 3:
        if palette is None:
            raise PNGError("palette image without PLTE")
        table = np.zeros((256, 3), np.uint8)  # past PLTE: black, as PIL
        table[:len(palette)] = palette
        return table[s[..., 0]]
    if depth == 16:
        # PIL keeps the high byte, except for grey, which it reads as I;16
        # and clamps on the way to 8 bits.
        s = np.minimum(s, 255) if colour == 0 else s >> 8
    elif depth < 8:
        s = s * (255 // ((1 << depth) - 1))
    s = s.astype(np.uint8)
    if colour in (0, 4):
        return np.repeat(s[..., :1], 3, axis=-1)
    return np.ascontiguousarray(s[..., :3])


def decode(data: bytes, *, backend: str | None = None) -> np.ndarray:
    """A PNG file's bytes -> uint8 [H, W, 3] RGB, as PIL's
    ``convert("RGB")``.  Raises ``PNGError`` on a malformed file.
    ``backend`` undoes the row filters: ``"native"``, ``"numpy"`` or None
    (``unfilter_backend()``'s)."""
    if backend is None:
        backend = unfilter_backend()
    elif backend not in ("native", "numpy"):
        raise ValueError(f"unknown backend {backend!r}")
    header = None
    palette = None
    idat = []
    for ctype, payload in _chunks(data):
        if ctype == b"IHDR":
            if len(payload) != 13:
                raise PNGError("bad IHDR length")
            header = struct.unpack(">IIBBBBB", payload)
        elif ctype == b"PLTE":
            if len(payload) % 3 or not 3 <= len(payload) <= 768:
                raise PNGError("bad PLTE length")
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(payload)
    if header is None:
        raise PNGError("no IHDR chunk")
    if not idat:
        raise PNGError("no IDAT chunk")
    width, height, depth, colour, comp, filt, interlace = header
    if colour not in _COLOUR_TYPES or depth not in _COLOUR_TYPES[colour][1]:
        raise PNGError(f"bad colour type {colour} / bit depth {depth}")
    if comp != 0 or filt != 0 or interlace not in (0, 1):
        raise PNGError("unknown compression, filter or interlace method")
    if width == 0 or height == 0:
        raise PNGError("empty image")
    channels = _COLOUR_TYPES[colour][0]
    try:
        stream = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise PNGError(f"corrupt image data: {e}") from e
    bits = depth * channels
    bpp = max(1, bits // 8)

    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    samples = np.zeros((height, width, channels),
                       np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw = (width - x0 + dx - 1) // dx if width > x0 else 0
        ph = (height - y0 + dy - 1) // dy if height > y0 else 0
        if pw == 0 or ph == 0:
            continue  # an empty pass has no rows, not even filter bytes
        row = 1 + (pw * bits + 7) // 8
        size = ph * row
        if pos + size > len(stream):
            raise PNGError("image data too short")
        raw = np.frombuffer(stream, np.uint8, size, pos).reshape(ph, row)
        pos += size
        rows = _unfilter(raw, bpp, backend)
        samples[y0::dy, x0::dx] = _samples(rows, pw, depth, channels)
    return _to_rgb(samples, colour, depth, palette)


def read_png(path) -> np.ndarray:
    """Decode the PNG file at ``path`` -> uint8 [H, W, 3]."""
    with open(path, "rb") as f:
        return decode(f.read())


def _chunk(ctype: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def encode(image) -> bytes:
    """uint8 [H, W, 3] -> the bytes of an 8-bit RGB PNG (filter 0, one
    IDAT)."""
    img = np.asarray(image)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected uint8 [H, W, 3], got {img.dtype} "
                         f"{list(img.shape)}")
    h, w, _ = img.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)  # filter byte 0 a row
    rows[:, 1:] = img.reshape(h, 3 * w)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _chunk(b"IEND", b""))


def write_png(image, path) -> None:
    """Write uint8 [H, W, 3] to ``path`` as an 8-bit RGB PNG."""
    data = encode(image)
    with open(path, "wb") as f:
        f.write(data)

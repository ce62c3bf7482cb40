"""A PNG writer that sets every field by hand: colour type, bit depth,
row filters, Adam7 interlacing, PLTE / tRNS and the IDAT split.

Writes what PIL never does (filters it does not choose, short palettes,
tiny IDAT chunks), for ``tests/test_torch_png.py`` and for
``chip_smoke.py``'s timing of a decode with every row filter.  Needs
numpy and ``crt_tpu_torch.io.png`` only.
"""

import struct
import zlib

import numpy as np

from crt_tpu_torch.io import png

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def chunk(ctype, payload):
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(rows, bpp, filters):
    """Filter unfiltered rows uint8 [h, L] with filters[i] on row i."""
    x = rows.astype(np.int32)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    pred = {0: 0 * x, 1: a, 2: b, 3: (a + b) >> 1, 4: _paeth(a, b, c)}
    out = np.stack([(x[i] - pred[f][i]) & 0xFF for i, f in enumerate(filters)])
    return np.concatenate(
        [np.asarray(filters, np.uint8)[:, None], out.astype(np.uint8)], axis=1)


def _pack(samples, depth):
    """Samples [h, w * channels] -> packed row bytes [h, L]."""
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    pad = -samples.shape[1] % per
    s = np.pad(samples, ((0, 0), (0, pad))).reshape(h, -1, per)
    shifts = depth * np.arange(per - 1, -1, -1)
    return (s.astype(np.uint16) << shifts).sum(-1).astype(np.uint8)


def raw_png(samples, colour, depth, filt, interlace, palette=None,
            trns=None, idat_size=7):
    """A PNG of samples [H, W, channels] written here, byte by byte: row
    filter ``filt`` (0-4) on every row, or ``"mixed"`` (filters 0-4 in
    turn), the compressed rows split into IDAT chunks of ``idat_size``
    bytes."""
    h, w, ch = samples.shape
    bpp = max(1, depth * ch // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    stream = b""
    row_no = 0
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _pack(sub.reshape(sub.shape[0], -1), depth)
        if filt == "mixed":
            filters = [(row_no + i) % 5 for i in range(rows.shape[0])]
        else:
            filters = [filt] * rows.shape[0]
        row_no += rows.shape[0]
        stream += _filter_rows(rows, bpp, filters).tobytes()
    z = zlib.compress(stream)
    out = png.SIGNATURE + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, colour, 0, 0, interlace))
    if palette is not None:
        out += chunk(b"PLTE", palette.tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    for i in range(0, len(z), idat_size):  # several IDAT chunks
        out += chunk(b"IDAT", z[i:i + idat_size])
    return out + chunk(b"IEND", b"")

"""stb_image-exact baseline JPEG decoder (pure NumPy / Python).

A copy of ``crt_tpu/io/jpeg_stb.py``, kept here because importing any
``crt_tpu`` module imports JAX, which the port's machine does not have;
the decoder itself is NumPy only and decodes the same bytes.

The reference decodes textures with ``stbi_load(..., STBI_rgb)``
(its ``src/core/crt_image_stbi.cpp:16-40``).  PIL (libjpeg-turbo)
differs from stb_image by ±1-2 codes around block edges — different integer
IDCT rounding and YCbCr fixed-point math — which is the documented residual
on the 12-01-scene3 golden (~0.5 % of pixels, all on the dragon JPEG).

This module reproduces stb_image.h's *baseline* JPEG integer pipeline
bit-for-bit:

- Huffman decode + dequantization with the coefficient ``(short)`` cast
  (stbi__jpeg_decode_block);
- the fixed-point IDCT ``stbi__idct_block`` / ``STBI__IDCT_1D`` with its
  ``stbi__f2f`` constants (computed here in float32 exactly as the C
  macro does) and the two rounding passes (``>>10`` with +512, ``>>17``
  with +65536 and the +128 bias folded in).  The all-zero-AC column
  shortcut in the C code is numerically identical to the full 1-D pass
  (the +512 rounding term vanishes under ``>>10`` for a lone DC), so the
  vectorized full pass used here is bit-exact;
- stb's "fancy" 2x chroma upsampling (stbi__resample_row_h_2 / _v_2 /
  _hv_2, nearest for other factors) driven by the same line0/line1/ystep
  state machine as stbi__load_jpeg_image;
- ``stbi__YCbCr_to_RGB_row``'s fixed-point color conversion, including
  its ``& 0xffff0000`` truncation quirk on the Cb green term (replicated
  with two's-complement int32 arithmetic).

Progressive (SOF2), 12-bit, CMYK and arithmetic-coded files raise
:class:`UnsupportedJPEG`; callers fall back to PIL for those.
"""

from __future__ import annotations

import numpy as np

__all__ = ["decode", "decode_file", "UnsupportedJPEG", "CorruptJPEG"]


class UnsupportedJPEG(Exception):
    """Valid JPEG feature outside stb's baseline path we replicate."""


class CorruptJPEG(Exception):
    """Malformed stream."""


def _f2f(x: float) -> int:
    # stbi__f2f: ((int) (((x) * 4096 + 0.5))) with x a float literal —
    # the product runs in float32, the +0.5 in double, the cast truncates
    # toward zero.
    return int(float(np.float32(x) * np.float32(4096.0)) + 0.5)


# STBI__IDCT_1D constants.
_C0541 = _f2f(0.5411961)
_CM184 = _f2f(-1.847759065)
_C0765 = _f2f(0.765366865)
_C1175 = _f2f(1.175875602)
_C0298 = _f2f(0.298631336)
_C2053 = _f2f(2.053119869)
_C3072 = _f2f(3.072711026)
_C1501 = _f2f(1.501321110)
_CM089 = _f2f(-0.899976223)
_CM256 = _f2f(-2.562915447)
_CM196 = _f2f(-1.961570560)
_CM039 = _f2f(-0.390180644)

# stbi__float2fixed: (((int) ((x) * 4096.0f + 0.5f)) << 8)
_YR_CR = _f2f(1.40200) << 8
_YG_CR = _f2f(0.71414) << 8
_YG_CB = _f2f(0.34414) << 8
_YB_CB = _f2f(1.77200) << 8

# stbi__jpeg_dezigzag, padded with 63s so corrupt streams sample in-range.
_DEZIGZAG = np.array(
    [
        0, 1, 8, 16, 9, 2, 3, 10,
        17, 24, 32, 25, 18, 11, 4, 5,
        12, 19, 26, 33, 40, 48, 41, 34,
        27, 20, 13, 6, 7, 14, 21, 28,
        35, 42, 49, 56, 57, 50, 43, 36,
        29, 22, 15, 23, 30, 37, 44, 51,
        58, 59, 52, 45, 38, 31, 39, 46,
        53, 60, 61, 54, 47, 55, 62, 63,
    ]
    + [63] * 15,
    np.int32,
).tolist()


class _Huff:
    """Canonical Huffman table with a 16-bit peek LUT (plain lists —
    Python list indexing beats NumPy scalar indexing in the decode loop)."""

    __slots__ = ("sym", "ln")

    def __init__(self, counts, values):
        sym = np.zeros(1 << 16, np.uint8)
        ln = np.zeros(1 << 16, np.uint8)
        code = 0
        vi = 0
        for l in range(1, 17):
            for _ in range(counts[l - 1]):
                if vi >= len(values):
                    raise CorruptJPEG("bad DHT")
                start = code << (16 - l)
                span = 1 << (16 - l)
                ln[start : start + span] = l
                sym[start : start + span] = values[vi]
                vi += 1
                code += 1
            if code > (1 << l):
                raise CorruptJPEG("bad DHT code counts")
            code <<= 1
        self.sym = sym.tolist()
        self.ln = ln.tolist()


class _Bits:
    """MSB-first bit reader over a destuffed entropy segment; feeds zero
    bytes past the end (stb's ``nomore`` behavior)."""

    __slots__ = ("data", "n", "pos", "buf", "cnt")

    def __init__(self, data: bytes):
        self.data = data
        self.n = len(data)
        self.pos = 0
        self.buf = 0
        self.cnt = 0

    def _fill(self, want: int) -> None:
        data, n, pos, buf, cnt = self.data, self.n, self.pos, self.buf, self.cnt
        while cnt < want:
            b = data[pos] if pos < n else 0
            pos += 1
            buf = ((buf << 8) | b) & 0xFFFFFFFF
            cnt += 8
        self.pos, self.buf, self.cnt = pos, buf, cnt

    def peek16(self) -> int:
        if self.cnt < 16:
            self._fill(16)
        return (self.buf >> (self.cnt - 16)) & 0xFFFF

    def get(self, k: int) -> int:
        if self.cnt < k:
            self._fill(k)
        self.cnt -= k
        return (self.buf >> self.cnt) & ((1 << k) - 1)


def _decode_sym(bits: _Bits, h: _Huff) -> int:
    c = bits.peek16()
    l = h.ln[c]
    if l == 0:
        raise CorruptJPEG("bad huffman code")
    bits.cnt -= l
    return h.sym[c]


def _extend_receive(bits: _Bits, s: int) -> int:
    v = bits.get(s)
    if v < (1 << (s - 1)):
        v -= (1 << s) - 1
    return v


def _idct_1d(s0, s1, s2, s3, s4, s5, s6, s7):
    """STBI__IDCT_1D on int64 arrays. Returns (x0, x1, x2, x3, t0r, t1r,
    t2r, t3r) matching the macro's outputs."""
    p2 = s2
    p3 = s6
    p1 = (p2 + p3) * _C0541
    t2 = p1 + p3 * _CM184
    t3 = p1 + p2 * _C0765
    p2 = s0
    p3 = s4
    t0 = (p2 + p3) << 12
    t1 = (p2 - p3) << 12
    x0 = t0 + t3
    x3 = t0 - t3
    x1 = t1 + t2
    x2 = t1 - t2
    t0 = s7
    t1 = s5
    t2 = s3
    t3 = s1
    p3 = t0 + t2
    p4 = t1 + t3
    p1 = t0 + t3
    p2 = t1 + t2
    p5 = (p3 + p4) * _C1175
    t0 = t0 * _C0298
    t1 = t1 * _C2053
    t2 = t2 * _C3072
    t3 = t3 * _C1501
    p1 = p5 + p1 * _CM089
    p2 = p5 + p2 * _CM256
    p3 = p3 * _CM196
    p4 = p4 * _CM039
    t3 = t3 + p1 + p4
    t2 = t2 + p2 + p3
    t1 = t1 + p2 + p4
    t0 = t0 + p1 + p3
    return x0, x1, x2, x3, t0, t1, t2, t3


def _idct_blocks(coef: np.ndarray) -> np.ndarray:
    """stbi__idct_block over [N, 64] int16 coefficient blocks → [N, 8, 8]
    uint8 samples (the +128 level shift folded into the rounding, as stb
    does)."""
    d = coef.reshape(-1, 8, 8).astype(np.int64)
    # Column pass: s_k = d[:, k, c] for the 8 columns c at once.
    x0, x1, x2, x3, t0, t1, t2, t3 = _idct_1d(
        d[:, 0], d[:, 1], d[:, 2], d[:, 3], d[:, 4], d[:, 5], d[:, 6], d[:, 7]
    )
    x0 += 512
    x1 += 512
    x2 += 512
    x3 += 512
    v = np.empty_like(d)
    v[:, 0] = (x0 + t3) >> 10
    v[:, 7] = (x0 - t3) >> 10
    v[:, 1] = (x1 + t2) >> 10
    v[:, 6] = (x1 - t2) >> 10
    v[:, 2] = (x2 + t1) >> 10
    v[:, 5] = (x2 - t1) >> 10
    v[:, 3] = (x3 + t0) >> 10
    v[:, 4] = (x3 - t0) >> 10
    # Row pass: s_k = v[:, r, k] for all 8 rows r at once.
    x0, x1, x2, x3, t0, t1, t2, t3 = _idct_1d(
        v[..., 0], v[..., 1], v[..., 2], v[..., 3],
        v[..., 4], v[..., 5], v[..., 6], v[..., 7],
    )
    bias = 65536 + (128 << 17)
    x0 += bias
    x1 += bias
    x2 += bias
    x3 += bias
    o = np.empty_like(v)
    o[..., 0] = (x0 + t3) >> 17
    o[..., 7] = (x0 - t3) >> 17
    o[..., 1] = (x1 + t2) >> 17
    o[..., 6] = (x1 - t2) >> 17
    o[..., 2] = (x2 + t1) >> 17
    o[..., 5] = (x2 - t1) >> 17
    o[..., 3] = (x3 + t0) >> 17
    o[..., 4] = (x3 - t0) >> 17
    return np.clip(o, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Resampling (stbi__resample_row_*). All take full low-res rows as int32
# NumPy arrays of length w and return uint8 arrays of length w*hs (v_2: w).


def _div4(x):
    return (x >> 2).astype(np.uint8)


def _div16(x):
    return (x >> 4).astype(np.uint8)


def _resample_identity(near, far, w, hs):
    return near.astype(np.uint8)


def _resample_v2(near, far, w, hs):
    return _div4(3 * near + far + 2)


def _resample_h2(near, far, w, hs):
    inp = near
    if w == 1:
        return np.full(2, inp[0], np.uint8)
    out = np.empty(w * 2, np.int32)
    out[0] = inp[0]
    out[1] = (inp[0] * 3 + inp[1] + 2) >> 2
    n = 3 * inp[1:-1] + 2
    out[2:-2:2] = (n + inp[:-2]) >> 2
    out[3:-1:2] = (n + inp[2:]) >> 2
    out[-2] = (inp[-2] + 3 * inp[-1] + 2) >> 2
    out[-1] = inp[-1]
    return out.astype(np.uint8)


def _resample_hv2(near, far, w, hs):
    if w == 1:
        v = (3 * int(near[0]) + int(far[0]) + 2) >> 2
        return np.full(2, v, np.uint8)
    t = 3 * near + far  # t1 sequence
    out = np.empty(w * 2, np.int32)
    out[0] = (t[0] + 2) >> 2
    out[1:-1:2] = (3 * t[:-1] + t[1:] + 8) >> 4
    out[2::2] = (3 * t[1:] + t[:-1] + 8) >> 4
    out[-1] = (t[-1] + 2) >> 2
    return out.astype(np.uint8)


def _resample_generic(near, far, w, hs):
    return np.repeat(near, hs).astype(np.uint8)


# ---------------------------------------------------------------------------


class _Component:
    __slots__ = (
        "cid", "h", "v", "tq", "td", "ta", "dc_pred",
        "x", "y", "bx", "by", "coef", "plane",
    )


def _parse_entropy(data: bytes, pos: int):
    """Destuff the entropy-coded segment starting at ``pos``; split at RST
    markers. Returns (segments, resume_pos) where resume_pos points at the
    0xFF of the terminating (non-RST) marker."""
    segs = []
    cur = bytearray()
    n = len(data)
    i = pos
    while i < n:
        b = data[i]
        if b != 0xFF:
            cur.append(b)
            i += 1
            continue
        if i + 1 >= n:
            break
        m = data[i + 1]
        if m == 0x00:
            cur.append(0xFF)
            i += 2
        elif m == 0xFF:
            i += 1  # fill byte, stay on the second 0xFF
        elif 0xD0 <= m <= 0xD7:
            segs.append(bytes(cur))
            cur = bytearray()
            i += 2
        else:
            break
    segs.append(bytes(cur))
    return segs, i


def decode(data: bytes) -> np.ndarray:
    """Decode a baseline JPEG to [H, W, 3] uint8, bit-exact vs
    ``stbi_load(..., STBI_rgb)``."""
    if len(data) < 4 or data[0] != 0xFF or data[1] != 0xD8:
        raise CorruptJPEG("no SOI")

    huff_dc: dict[int, _Huff] = {}
    huff_ac: dict[int, _Huff] = {}
    dequant: dict[int, np.ndarray] = {}
    comps: list[_Component] = []
    img_x = img_y = 0
    restart_interval = 0
    app14_transform = -1
    h_max = v_max = 1
    mcu_x = mcu_y = 0
    n = len(data)
    i = 2

    def frame_parsed() -> bool:
        return bool(comps)

    while i < n:
        if data[i] != 0xFF:
            raise CorruptJPEG("expected marker")
        while i < n and data[i] == 0xFF:
            i += 1
        if i >= n:
            break
        m = data[i]
        i += 1
        if m == 0xD9:  # EOI
            break
        if m == 0x01 or 0xD0 <= m <= 0xD7:
            continue
        if i + 2 > n:
            raise CorruptJPEG("truncated segment")
        L = (data[i] << 8) | data[i + 1]
        seg = data[i + 2 : i + L]
        i += L

        if m == 0xDB:  # DQT
            o = 0
            while o < len(seg):
                pq = seg[o] >> 4
                tq = seg[o] & 15
                o += 1
                if pq == 0:
                    tbl = np.frombuffer(seg[o : o + 64], np.uint8).astype(np.int32)
                    o += 64
                elif pq == 1:
                    tbl = (
                        np.frombuffer(seg[o : o + 128], np.uint8)
                        .astype(np.int32)
                        .reshape(64, 2)
                    )
                    tbl = (tbl[:, 0] << 8) | tbl[:, 1]
                    o += 128
                else:
                    raise CorruptJPEG("bad DQT precision")
                # stb stores dequant in zigzag order and indexes it by zig —
                # equivalently: natural-order table indexed naturally.
                nat = np.zeros(64, np.int32)
                nat[_DEZIGZAG[:64]] = tbl
                dequant[tq] = nat
        elif m == 0xC4:  # DHT
            o = 0
            while o < len(seg):
                tc = seg[o] >> 4
                th = seg[o] & 15
                counts = list(seg[o + 1 : o + 17])
                total = sum(counts)
                values = list(seg[o + 17 : o + 17 + total])
                o += 17 + total
                t = _Huff(counts, values)
                if tc == 0:
                    huff_dc[th] = t
                else:
                    huff_ac[th] = t
        elif m == 0xDD:  # DRI
            restart_interval = (seg[0] << 8) | seg[1]
        elif m in (0xC0, 0xC1):  # SOF0 / SOF1 (baseline / ext. sequential)
            if frame_parsed():
                raise CorruptJPEG("multiple SOF")
            if seg[0] != 8:
                raise UnsupportedJPEG("only 8-bit precision")
            img_y = (seg[1] << 8) | seg[2]
            img_x = (seg[3] << 8) | seg[4]
            nc = seg[5]
            if nc not in (1, 3):
                raise UnsupportedJPEG(f"{nc}-component JPEG")
            o = 6
            for _ in range(nc):
                c = _Component()
                c.cid = seg[o]
                c.h = seg[o + 1] >> 4
                c.v = seg[o + 1] & 15
                c.tq = seg[o + 2]
                c.dc_pred = 0
                if not (1 <= c.h <= 4 and 1 <= c.v <= 4):
                    raise CorruptJPEG("bad sampling factors")
                comps.append(c)
                o += 3
            h_max = max(c.h for c in comps)
            v_max = max(c.v for c in comps)
            mcu_x = (img_x + h_max * 8 - 1) // (h_max * 8)
            mcu_y = (img_y + v_max * 8 - 1) // (v_max * 8)
            for c in comps:
                c.x = (img_x * c.h + h_max - 1) // h_max
                c.y = (img_y * c.v + v_max - 1) // v_max
                c.bx = mcu_x * c.h
                c.by = mcu_y * c.v
                c.coef = np.zeros((c.by * c.bx, 64), np.int16)
        elif m == 0xC2:
            raise UnsupportedJPEG("progressive JPEG")
        elif m in (0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF):
            raise UnsupportedJPEG(f"SOF{m & 15} coding")
        elif m == 0xEE and len(seg) >= 12 and seg[:5] == b"Adobe":
            app14_transform = seg[11]
        elif m == 0xDA:  # SOS
            if not frame_parsed():
                raise CorruptJPEG("SOS before SOF")
            ns = seg[0]
            scan_comps = []
            o = 1
            for _ in range(ns):
                cid = seg[o]
                td = seg[o + 1] >> 4
                ta = seg[o + 1] & 15
                o += 2
                for c in comps:
                    if c.cid == cid:
                        c.td, c.ta = td, ta
                        scan_comps.append(c)
                        break
                else:
                    raise CorruptJPEG("SOS references unknown component")
            segs, i = _parse_entropy(data, i)
            _decode_scan(
                segs, scan_comps, huff_dc, huff_ac, dequant,
                restart_interval, mcu_x, mcu_y,
            )
        # else: APPn / COM / unknown — skipped via the length field.

    if not frame_parsed():
        raise CorruptJPEG("no SOF")

    # IDCT every component's blocks into its padded plane.
    for c in comps:
        blocks = _idct_blocks(c.coef)  # [by*bx, 8, 8]
        c.plane = (
            blocks.reshape(c.by, c.bx, 8, 8)
            .transpose(0, 2, 1, 3)
            .reshape(c.by * 8, c.bx * 8)
        )
        c.coef = None

    if len(comps) == 1:
        g = comps[0].plane[:img_y, :img_x]
        return np.repeat(g[..., None], 3, axis=2)

    rows = [_resample_component(c, img_x, img_y, h_max, v_max) for c in comps]
    # stb treats 3-component ids 'R','G','B' (or Adobe transform=0) as RGB.
    ids = tuple(c.cid for c in comps)
    if ids == (0x52, 0x47, 0x42) or app14_transform == 0:
        return np.stack([r[:, :img_x] for r in rows], axis=2)
    return _ycbcr_to_rgb(rows[0], rows[1], rows[2], img_x)


def _decode_scan(segs, scan_comps, huff_dc, huff_ac, dequant,
                 restart_interval, mcu_x, mcu_y):
    """Baseline entropy decode of one scan into comp.coef (dequantized,
    int16-cast, natural order) — stbi__parse_entropy_coded_data."""
    dezig = _DEZIGZAG
    interleaved = len(scan_comps) > 1

    if interleaved:
        units = []  # (comp, plane_block_index) per MCU in decode order
        total_mcus = mcu_x * mcu_y
    else:
        c = scan_comps[0]
        sbx, sby = (c.x + 7) >> 3, (c.y + 7) >> 3
        total_mcus = sbx * sby

    todo = restart_interval if restart_interval else 1 << 62
    seg_idx = 0
    bits = _Bits(segs[0])
    tabs: dict[int, tuple] = {}
    for c in scan_comps:
        c.dc_pred = 0
        hdc = huff_dc.get(c.td)
        hac = huff_ac.get(c.ta)
        dq = dequant.get(c.tq)
        if hdc is None or hac is None or dq is None:
            raise CorruptJPEG("missing table")
        tabs[id(c)] = (hdc, hac, dq.tolist())

    mcu = 0
    while mcu < total_mcus:
        if interleaved:
            mj, mi = divmod(mcu, mcu_x)
            work = []
            for c in scan_comps:
                for y in range(c.v):
                    for x in range(c.h):
                        work.append((c, (mj * c.v + y) * c.bx + (mi * c.h + x)))
        else:
            c = scan_comps[0]
            sj, si = divmod(mcu, sbx)
            work = [(c, sj * c.bx + si)]

        for c, bidx in work:
            hdc, hac, dqs = tabs[id(c)]
            block = [0] * 64
            t = _decode_sym(bits, hdc)
            diff = _extend_receive(bits, t) if t else 0
            c.dc_pred += diff
            block[0] = c.dc_pred * dqs[0]
            k = 1
            while k < 64:
                rs = _decode_sym(bits, hac)
                s = rs & 15
                if s == 0:
                    if rs != 0xF0:
                        break
                    k += 16
                else:
                    k += rs >> 4
                    zig = dezig[k]
                    k += 1
                    block[zig] = _extend_receive(bits, s) * dqs[zig]
            arr = np.asarray(block, np.int64).astype(np.int16)  # (short) cast
            c.coef[bidx] = arr

        mcu += 1
        todo -= 1
        if todo <= 0 and mcu < total_mcus:
            # Restart: new entropy segment, fresh bit state and DC preds.
            seg_idx += 1
            if seg_idx < len(segs):
                bits = _Bits(segs[seg_idx])
            else:
                bits = _Bits(b"")
            for c in scan_comps:
                c.dc_pred = 0
            todo = restart_interval if restart_interval else 1 << 62


def _resample_component(c: _Component, img_x, img_y, h_max, v_max):
    """stbi__load_jpeg_image's per-component resample driver → uint8
    [img_y, w_lores*hs] (callers crop columns to img_x)."""
    hs = h_max // c.h
    vs = v_max // c.v
    w_lores = (img_x + hs - 1) // hs
    if hs == 1 and vs == 1:
        return c.plane[:img_y]
    if hs == 1 and vs == 2:
        fn = _resample_v2
    elif hs == 2 and vs == 1:
        fn = _resample_h2
    elif hs == 2 and vs == 2:
        fn = _resample_hv2
    else:
        fn = _resample_generic
    plane = c.plane.astype(np.int32)
    out = np.empty((img_y, w_lores * hs if hs > 1 else w_lores), np.uint8)
    line0 = line1 = 0
    ypos = 0
    half = vs >> 1
    ystep = half  # stb inits ystep = vs >> 1 (centers the triangle filter)
    for j in range(img_y):
        y_bot = ystep >= half
        near = plane[line1 if y_bot else line0, :w_lores]
        far = plane[line0 if y_bot else line1, :w_lores]
        out[j] = fn(near, far, w_lores, hs)
        ystep += 1
        if ystep >= vs:
            ystep = 0
            line0 = line1
            ypos += 1
            if ypos < c.y:
                line1 += 1
    return out


def _ycbcr_to_rgb(y, cb, cr, img_x):
    """stbi__YCbCr_to_RGB_row over the whole image (int32 two's-complement
    arithmetic, including the `& 0xffff0000` quirk on the Cb green term)."""
    y = y[:, :img_x].astype(np.int32)
    cb = cb[:, :img_x].astype(np.int32) - 128
    cr = cr[:, :img_x].astype(np.int32) - 128
    y_fixed = (y << 20) + (1 << 19)
    r = y_fixed + cr * _YR_CR
    g = y_fixed + cr * np.int32(-_YG_CR) + ((cb * np.int32(-_YG_CB)) & np.int32(-0x10000))
    b = y_fixed + cb * _YB_CB
    r >>= 20
    g >>= 20
    b >>= 20
    return np.clip(np.stack([r, g, b], axis=2), 0, 255).astype(np.uint8)


def decode_file(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())

"""Early-course-era procedural images (tasks 02-03), reconstructed exactly.

A NumPy copy of ``crt_tpu/utils/era.py`` (importing crt_tpu imports JAX).

The reference's tasks 02-06 predate the `.crtscene` format: their goldens
(results/png/02-*.png, 03-*.png, 05-*.png, 06-*.png) were produced by code
at course tags whose source is not in the snapshot, with no scene files.
Three of them are pure deterministic functions of the image size and are
reconstructed here BIT-EXACTLY (verified per-pixel in tests/test_era.py):

  - 03-01 camera-rays: color = (normalize(sx, sy, -1) + 1) / 2 over the
    raster->NDC->screen mapping of crt_camera.cpp:15-26 — the 16x9 and 1x1
    renders predate the aspect-ratio fix (x is NOT aspect-scaled), the
    9x16 render has it.  100.0000 % of pixels reproduce exactly in f32.
  - 02-02 circle: inside iff (x - W/2)^2 + (y - H/2)^2 < 150^2 over
    integer pixel indices; fg (58,118,25)/255, bg (183,183,183)/255.
    Bit-exact.

  - 02-01 rectangle-grid: the tag binary never calls
    srand(), so the glibc rand() stream is fully determined (implicit seed
    1, TYPE_3 additive-feedback generator).  Archaeology against that
    stream pinned the generator bit-exactly: row-major pixels, THREE
    rand() draws per pixel in R,G,B order; per channel v = rand() % 341,
    then min(v, 255) on the block's "free" channels and max(v - 255, 0)
    on the others; the 4x4 blocks cycle the 6 masks
    {R},{G},{RG},{B},{RB},{GB} in row-major block order (i % 6).
    100.0000 % of pixels reproduce exactly (tests/test_era.py).

NOT reconstructable (documented for the corpus table):
  - 05-* / 06-*: rendered from mesh data compiled into the tag binaries
    (the blender_crt_tools_addon.py C++-header export), absent from the
    snapshot.
"""

from __future__ import annotations

import numpy as np

ERA02_CIRCLE_RADIUS = 150.0
ERA02_CIRCLE_FG = (58, 118, 25)
ERA02_CIRCLE_BG = (183, 183, 183)


def render_camera_rays(width: int, height: int,
                       aspect: bool = True) -> np.ndarray:
    """The 03-01 camera-ray direction visualization -> [H, W, 3] f32.

    ``aspect=False`` reproduces the pre-aspect-fix 16x9/1x1 renders.
    All arithmetic in f32 to match the reference's float pipeline
    (the 1x1 golden has pixels whose floor() flips under f64).
    """
    w32, h32 = np.float32(width), np.float32(height)
    x = ((np.arange(width, dtype=np.float32) + np.float32(0.5)) / w32
         ) * 2 - 1
    y = 1 - ((np.arange(height, dtype=np.float32) + np.float32(0.5)) / h32
             ) * 2
    if aspect:
        x = x * (w32 / h32)
    d = np.stack(
        [
            np.broadcast_to(x[None, :], (height, width)),
            np.broadcast_to(y[:, None], (height, width)),
            -np.ones((height, width), np.float32),
        ],
        axis=-1,
    )
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return d * np.float32(0.5) + np.float32(0.5)


def render_circle(width: int, height: int,
                  radius: float = ERA02_CIRCLE_RADIUS,
                  fg=ERA02_CIRCLE_FG, bg=ERA02_CIRCLE_BG) -> np.ndarray:
    """The 02-02 circle image -> [H, W, 3] f32 in [0, 1]."""
    yy, xx = np.mgrid[0:height, 0:width]
    inside = (
        (xx - width / 2.0) ** 2 + (yy - height / 2.0) ** 2 < radius**2
    )
    img = np.where(
        inside[..., None],
        np.asarray(fg, np.float32) / 255.0,
        np.asarray(bg, np.float32) / 255.0,
    )
    return img.astype(np.float32)


def glibc_random(seed: int, n: int) -> np.ndarray:
    """First ``n`` outputs of glibc's default random() (TYPE_3).

    State: r[0]=seed; r[1..30] via the Park-Miller LCG in Schrage form;
    r[31..33] copies of r[0..2]; then the additive lagged-Fibonacci
    r[i] = (r[i-31] + r[i-3]) mod 2^32 with the first 310 outputs
    discarded; each output is r[i] >> 1.  A C program that never calls
    srand() uses seed 1 — which is what pins the 02-01 golden.
    """
    r = [0] * 34
    r[0] = seed
    for i in range(1, 31):
        hi, lo = divmod(r[i - 1], 127773)
        word = 16807 * lo - 2836 * hi
        if word < 0:
            word += 2147483647
        r[i] = word
    for i in range(31, 34):
        r[i] = r[i - 31]
    vals = r
    out = np.empty(n + 310, dtype=np.int64)
    i = 34
    for k in range(n + 310):
        v = (vals[i - 31] + vals[i - 3]) & 0xFFFFFFFF
        vals.append(v)
        out[k] = v >> 1
        i += 1
    return out[310:]


# the 6-color block-mask cycle of the 02-01 grid (row-major block order):
# free channels render min(v, 255), constrained channels max(v - 255, 0)
ERA02_GRID_MASKS = ((1, 0, 0), (0, 1, 0), (1, 1, 0),
                    (0, 0, 1), (1, 0, 1), (0, 1, 1))


def render_rectangle_grid(width: int = 800, height: int = 600,
                          blocks: int = 4) -> np.ndarray:
    """The 02-01 rectangle-grid image -> [H, W, 3] f32 in [0, 1], BIT-EXACT.

    Generator (recovered by search against the determined rand() stream —
    see module docstring): for each pixel in row-major order, three glibc
    rand() draws (implicit seed 1) in R,G,B order; v = draw % 341;
    channel = min(v, 255) if the pixel's block mask includes the channel
    else max(v - 255, 0).  Blocks cycle ERA02_GRID_MASKS row-major.
    """
    draws = glibc_random(1, width * height * 3).reshape(height, width, 3)
    v = draws % 341
    bh, bw = height // blocks, width // blocks
    yy, xx = np.mgrid[0:height, 0:width]
    bidx = (yy // bh) * blocks + (xx // bw)
    mask = np.asarray(ERA02_GRID_MASKS)[bidx % len(ERA02_GRID_MASKS)]
    out = np.where(mask.astype(bool),
                   np.minimum(v, 255), np.maximum(v - 255, 0))
    return (out.astype(np.float32) / np.float32(255.0))


# (golden name, render fn) — every early-task PNG that is a pure function
# of the image size; sizes are read from the goldens themselves in tests.
ERA_CASES = [
    ("02-01-rectangle-grid", lambda w, h: render_rectangle_grid(w, h)),
    ("02-02-circle", lambda w, h: render_circle(w, h)),
    ("03-01-camera-rays-16x9", lambda w, h: render_camera_rays(w, h, False)),
    ("03-01-camera-rays-1x1", lambda w, h: render_camera_rays(w, h, False)),
    ("03-01-camera-rays-9x16", lambda w, h: render_camera_rays(w, h, True)),
]

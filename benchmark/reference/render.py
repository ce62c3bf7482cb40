"""Plain reference renderer: the semantics of the port's frames, written
out once more in plain PyTorch, in any float dtype, on any device.

It reads the scene from the benchmark's own description (a .crtscene-style
dict, or the arrays of a triangle soup) and imports nothing of the program.
What it computes:

  - camera rays through pixel centres (+0.5), y flipped, the aspect ratio
    on x, tan(fov / 2) on both axes, direction (sx, sy, -1) times the
    row-major camera matrix, normalized;
  - the closest hit of every ray against every triangle (a plane hit at
    t >= 0, |n.d| >= 1e-6, inside all three edges, back faces culled
    where the material asks), by brute force in blocks;
  - Whitted shading to ``max_ray_depth``: a miss takes the background, a
    diffuse hit the sum over lights of albedo * I / (4 pi r^2) * max(0,
    L.N) where the shadow ray from point + N * bias meets nothing within
    r, a mirror its albedo times the reflected ray's colour, a constant
    material its albedo; past the depth limit a ray is black;
  - diffuse GI: K hemisphere samples per diffuse hit, each direction from
    two uniforms of the ray's PCG32 stream, the child on the stream forked
    after its draws with salt k + 1, the colour divided by K + 1; a
    mirror's ray goes on on its parent's stream.  Streams are seeded per
    pixel from its raster x / y and forked per progressive pass.

The hit search is a constant (no gradient); the hit distance, the point,
the barycentrics, the normal and everything after them differentiate with
respect to the parameter leaves, as the port's do.  Smooth vertex normals
are computed once from the scene as loaded and stay constants.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

PARAM_KEYS = ("vertices", "tex_color_a", "tex_color_b", "light_intensity",
              "cam_position")

DIFFUSE, REFLECTIVE, REFRACTIVE, CONSTANT = 0, 1, 2, 3
_MATERIAL_CODES = {"diffuse": DIFFUSE, "reflective": REFLECTIVE,
                   "refractive": REFRACTIVE, "constant": CONSTANT}

# Ray x triangle pairs per block of the brute-force search.
PAIR_BLOCK = 1 << 25

# ---------------------------------------------------------------- PCG32
# The minimal PCG32 of the course renderer (state and increment as uint64
# bits in int64; a right shift masked to what a logical shift keeps).
_MUL = 0x5851F42D4C957F2D
_U32 = 0xFFFFFFFF


def _shr(x, s):
    return (x >> s) & ((1 << (64 - s)) - 1)


def pcg_step(state, inc):
    """-> (output in [0, 2^32) as int64, next state)."""
    xorshifted = _shr(_shr(state, 18) ^ state, 27) & _U32
    rot = _shr(state, 59)
    out = ((xorshifted >> rot) | (xorshifted << ((-rot) & 31))) & _U32
    return out, state * _MUL + inc


def pcg_seed(x, y):
    """Per-pixel stream: seed = (x << 32) | y, state 0, inc = 2 seed + 1,
    a step, state += seed, a step -> (state, inc)."""
    seed = ((x & _U32) << 32) | (y & _U32)
    inc = (seed << 1) | 1
    _, st = pcg_step(torch.zeros_like(seed), inc)
    _, st = pcg_step(st + seed, inc)
    return st, inc


def pcg_uniform(state, inc):
    """U[0, 1) from the top 23 bits -> (float32 value, next state)."""
    out, st = pcg_step(state, inc)
    bits = (out >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0, st


def pcg_fork(state, inc, salt: int):
    """The child stream: inc xor (salt << 1), then one step."""
    inc = inc ^ ((salt & _U32) << 1)
    _, st = pcg_step(state, inc)
    return st, inc


# ---------------------------------------------------------------- scene
@dataclass
class RefScene:
    """Scene arrays as float64 NumPy on the host; ``params`` holds the
    trainable leaves under the port's field names."""

    params: dict
    tri: np.ndarray  # [T, 3] int64 vertex ids
    vnormal: np.ndarray  # [V, 3] smooth vertex normals (constants)
    tri_mat: np.ndarray  # [T] material ids
    mat_type: np.ndarray  # [M]
    mat_tex: np.ndarray  # [M] texture row of the albedo
    mat_smooth: np.ndarray  # [M] bool
    mat_backface: np.ndarray  # [M] bool
    light_position: np.ndarray  # [L, 3]
    cam_rotation: np.ndarray  # [3, 3] row-major, row vectors
    tan_half_fov: float
    background: np.ndarray  # [3]
    width: int
    height: int
    gi_on: bool = False
    reflections_on: bool = True


def _vertex_normals(pos, idx):
    """Each triangle adds its unit face normal to its vertices; each sum
    is normalized (zero where no triangle touches a vertex)."""
    fn = np.cross(pos[idx[:, 1]] - pos[idx[:, 0]], pos[idx[:, 2]] - pos[idx[:, 0]])
    n = np.linalg.norm(fn, axis=1, keepdims=True)
    fn = fn / np.where(n > 0, n, 1.0)
    out = np.zeros_like(pos)
    for k in range(3):
        np.add.at(out, idx[:, k], fn)
    n = np.linalg.norm(out, axis=1, keepdims=True)
    return out / np.where(n > 0, n, 1.0)


def scene_from_description(d: dict) -> RefScene:
    """A .crtscene-style dict (flat albedo colours or named albedo
    textures, diffuse / reflective / constant materials) -> RefScene."""
    f32 = np.float32
    tex_a, name_map = [], {}
    for i, tv in enumerate(d.get("textures") or []):
        if tv["type"] != "albedo":
            raise NotImplementedError(f"texture type {tv['type']!r}")
        name_map[tv["name"]] = i
        tex_a.append(tv["albedo"])
    mat_type, mat_tex, smooth, backface = [], [], [], []
    for mv in d["materials"]:
        code = _MATERIAL_CODES[mv["type"]]
        if code == REFRACTIVE:
            raise NotImplementedError("refractive materials")
        alb = mv["albedo"]
        if isinstance(alb, str):
            mat_tex.append(name_map[alb])
        else:  # an inline colour becomes a texture row of its own
            mat_tex.append(len(tex_a))
            tex_a.append(alb)
        mat_type.append(code)
        smooth.append(bool(mv["smooth_shading"]))
        backface.append(bool(mv.get("back_face_culling", False)))
    verts, vn, tris, tmat, base = [], [], [], [], 0
    for ov in d["objects"]:
        pos = np.asarray(ov["vertices"], f32).reshape(-1, 3).astype(np.float64)
        idx = np.asarray(ov["triangles"], np.int64).reshape(-1, 3)
        verts.append(pos)
        vn.append(_vertex_normals(pos.astype(f32).astype(np.float64), idx))
        tris.append(idx + base)
        tmat.append(np.full(len(idx), ov["material_index"], np.int64))
        base += len(pos)
    s = d["settings"]
    cam = d["camera"]
    tan = math.tan(math.radians(float(cam.get("fov_degrees", 90.0))) * 0.5)
    lights = d["lights"]
    tex_a = np.asarray(tex_a, f32).astype(np.float64)
    return RefScene(
        params={
            "vertices": np.concatenate(verts),
            "tex_color_a": tex_a,
            "tex_color_b": np.zeros_like(tex_a),
            "light_intensity": np.asarray([lv["intensity"] for lv in lights],
                                          f32).astype(np.float64),
            "cam_position": np.asarray(cam["position"], f32).astype(np.float64),
        },
        tri=np.concatenate(tris), vnormal=np.concatenate(vn),
        tri_mat=np.concatenate(tmat), mat_type=np.asarray(mat_type),
        mat_tex=np.asarray(mat_tex), mat_smooth=np.asarray(smooth),
        mat_backface=np.asarray(backface),
        light_position=np.asarray([lv["position"] for lv in lights],
                                  f32).astype(np.float64).reshape(-1, 3),
        cam_rotation=np.asarray(cam["matrix"], f32).astype(np.float64).reshape(3, 3),
        tan_half_fov=float(np.float32(tan)),
        background=np.asarray(s["background_color"], f32).astype(np.float64),
        width=int(s["image_settings"]["width"]),
        height=int(s["image_settings"]["height"]),
        gi_on=bool(s.get("gi_on", False)),
        reflections_on=bool(s.get("reflections_on", True)),
    )


def scene_from_soup(a: dict) -> RefScene:
    """The arrays of a triangle soup (``vertices`` [3T, 3], one diffuse
    material, flat faces) -> RefScene."""
    v = np.asarray(a["vertices"], np.float32).astype(np.float64)
    T = v.shape[0] // 3
    tex_a = np.asarray([a["albedo"]], np.float32).astype(np.float64)
    return RefScene(
        params={
            "vertices": v, "tex_color_a": tex_a,
            "tex_color_b": np.zeros_like(tex_a),
            "light_intensity": np.asarray([a["light_intensity"]],
                                          np.float32).astype(np.float64),
            "cam_position": np.zeros(3),
        },
        tri=np.arange(3 * T, dtype=np.int64).reshape(T, 3),
        vnormal=np.zeros_like(v), tri_mat=np.zeros(T, np.int64),
        mat_type=np.asarray([DIFFUSE]), mat_tex=np.asarray([0]),
        mat_smooth=np.asarray([False]), mat_backface=np.asarray([False]),
        light_position=np.asarray([a["light_position"]], np.float32
                                  ).astype(np.float64),
        cam_rotation=np.eye(3), tan_half_fov=1.0,
        background=np.asarray(a["background"], np.float32).astype(np.float64),
        width=int(a["width"]), height=int(a["height"]),
    )


# ---------------------------------------------------------------- renderer
def _dot(a, b):
    return (a * b).sum(-1)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _safe_length(v):
    """|v| with the radicand held at 1e-30 or more: a finite gradient where
    a hit lies on a vertex or an edge."""
    return torch.sqrt(torch.clamp(_dot(v, v), min=1e-30))


def _unit(v):
    return v / torch.sqrt(_dot(v, v))[..., None]


def camera_rays(px, py, width: int, height: int, tan_half_fov: float,
                cam_position, cam_rotation):
    """Rays (origins, directions [N, 3], in the dtype and on the device of
    ``cam_position``) through the centres of pixels (px, py: int [N])."""
    dt, dev = cam_position.dtype, cam_position.device
    sx = 2.0 * ((px.to(dev, dt) + 0.5) / width) - 1.0
    sy = 1.0 - 2.0 * ((py.to(dev, dt) + 0.5) / height)
    sx = sx * (float(width) / float(height)) * tan_half_fov
    sy = sy * tan_half_fov
    local = torch.stack([sx, sy, -torch.ones_like(sx)], -1)
    rot = torch.as_tensor(cam_rotation, device=dev).to(dt)
    d = _unit(local @ rot)
    return cam_position.expand(d.shape), d


class Renderer:
    """The reference on one device in one dtype.  ``params`` (dict of
    tensors, the leaves a fit differentiates) default to the scene's."""

    def __init__(self, scene: RefScene, dtype=torch.float64, device="cpu",
                 max_ray_depth: int = 3, gi_rays: int = 4, bias: float = 1e-2):
        self.s = scene
        self.dtype = dtype
        self.dev = torch.device(device)
        self.depth = max_ray_depth
        self.K = gi_rays
        self.bias = bias

        def t(x, dt=dtype):
            return torch.as_tensor(np.asarray(x), device=self.dev).to(dt)

        self.tri = t(scene.tri, torch.int64)
        self.vnormal = t(scene.vnormal)
        mat = scene.tri_mat
        self.t_type = t(scene.mat_type[mat], torch.int64)
        self.t_tex = t(scene.mat_tex[mat], torch.int64)
        self.t_smooth = t(scene.mat_smooth[mat], torch.bool)
        self.t_backface = t(scene.mat_backface[mat], torch.bool)
        self.light_pos = t(scene.light_position)
        self.bg = t(scene.background)
        self.tan = scene.tan_half_fov
        self.params = {k: t(v) for k, v in scene.params.items()}
        self.set_geometry()

    def with_params(self, params: dict):
        """Use ``params`` (tensors in this renderer's dtype) from now on."""
        self.params = params
        self.set_geometry()

    def set_geometry(self):
        """The search's constant per-triangle planes and edge normals."""
        v = self.params["vertices"].detach()
        v0, v1, v2 = (v[self.tri[:, k]] for k in range(3))
        n = _unit(_cross(v1 - v0, v2 - v0))
        self.g_n = n
        self.g_nv0 = _dot(n, v0)
        self.g_m = [_cross(n, b - a) for a, b in ((v0, v1), (v1, v2), (v2, v0))]
        self.g_c = [_dot(m, a) for m, a in zip(self.g_m, (v0, v1, v2))]

    # -- rays
    def camera_rays(self, px, py, cam_rotation):
        """Rays through pixel centres (px, py: int64 [N]) with the camera
        matrix ``cam_rotation`` ([3, 3] float32 values)."""
        return camera_rays(px, py, self.s.width, self.s.height, self.tan,
                           self.params["cam_position"], cam_rotation)

    # -- the hit search
    def closest(self, o, d):
        """Closest hit -> (t [N] (inf on a miss), tri [N] int64, -1 on a
        miss), over every triangle, without gradient."""
        o, d = o.detach(), d.detach()
        N, T = o.shape[0], self.tri.shape[0]
        best_t = torch.full((N,), math.inf, dtype=self.dtype, device=self.dev)
        best_i = torch.full((N,), -1, dtype=torch.int64, device=self.dev)
        tb = max(1, min(T, PAIR_BLOCK // max(N, 1)))
        rb = max(1, min(N, PAIR_BLOCK // tb))
        with torch.no_grad():
            for r0 in range(0, N, rb):
                oo, dd = o[r0:r0 + rb], d[r0:r0 + rb]
                for s in range(0, T, tb):
                    sl = slice(s, s + tb)
                    n = self.g_n[sl]
                    nd = dd @ n.T
                    opd = self.g_nv0[sl][None] - oo @ n.T
                    not_par = nd.abs() >= 1e-6
                    ok = not_par & ((opd < 0) | ~self.t_backface[sl][None])
                    t = opd / torch.where(not_par, nd, torch.ones_like(nd))
                    ok &= t >= 0
                    for m, c in zip(self.g_m, self.g_c):
                        ok &= (oo @ m[sl].T) + t * (dd @ m[sl].T) >= c[sl][None]
                    t = torch.where(ok, t, torch.full_like(t, math.inf))
                    ct, ci = t.min(dim=1)
                    better = ct < best_t[r0:r0 + rb]
                    best_t[r0:r0 + rb] = torch.where(better, ct, best_t[r0:r0 + rb])
                    best_i[r0:r0 + rb] = torch.where(better, ci + s, best_i[r0:r0 + rb])
        best_i = torch.where(torch.isfinite(best_t), best_i, -1)
        return best_t, best_i

    def attributes(self, o, d, tri):
        """Point, shading normal, material and albedo of hits ``tri`` (no
        misses), differentiable in the parameters."""
        v = self.params["vertices"]
        idx = self.tri[tri]
        v0, v1, v2 = v[idx[:, 0]], v[idx[:, 1]], v[idx[:, 2]]
        e1, e2 = v1 - v0, v2 - v0
        cr = _cross(e1, e2)
        fn = _unit(cr)
        t = _dot(fn, v0 - o) / _dot(fn, d)
        p = o + d * t[:, None]
        smooth = self.t_smooth[tri]
        normal = fn
        if bool(smooth.any()):
            area = torch.sqrt(_dot(cr, cr))
            vp = p - v0
            u = _safe_length(_cross(vp, e2)) / area
            w = _safe_length(_cross(e1, vp)) / area
            vn = self.vnormal
            sn = (vn[idx[:, 1]] * u[:, None] + vn[idx[:, 2]] * w[:, None]
                  + vn[idx[:, 0]] * (1.0 - u - w)[:, None])
            normal = torch.where(smooth[:, None], sn, fn)
        albedo = self.params["tex_color_a"][self.t_tex[tri]]
        return p, normal, self.t_type[tri], albedo

    def direct(self, p, normal, albedo):
        """Direct light of diffuse hits with shadow rays -> [N, 3]."""
        lum = torch.zeros(p.shape[0], dtype=self.dtype, device=self.dev)
        for k in range(self.light_pos.shape[0]):
            lv = self.light_pos[k][None] - p
            r2 = _dot(lv, lv)
            ld = lv / torch.sqrt(r2)[:, None]
            cosl = torch.clamp(_dot(ld, normal), min=0.0)
            facing = (cosl > 0).detach()
            lit = torch.zeros_like(facing)
            if bool(facing.any()):
                so = (p + normal * self.bias)[facing]
                st, _ = self.closest(so, ld[facing])
                lit[facing] = ~(torch.isfinite(st) & (st * st <= r2.detach()[facing]))
            term = self.params["light_intensity"][k] / (4.0 * math.pi * r2) * cosl
            lum = lum + torch.where(lit, term, torch.zeros_like(term))
        return albedo * lum[:, None]

    def shade(self, o, d, depth, stream=None):
        """Colour [N, 3] of rays (o, d) at ``depth``; ``stream`` is the
        rays' (state, inc) under GI."""
        N = o.shape[0]
        if depth > self.depth:
            return torch.zeros((N, 3), dtype=self.dtype, device=self.dev)
        _, tri = self.closest(o, d)
        color = self.bg.expand(N, 3)
        hit = torch.nonzero(tri >= 0)[:, 0]
        if hit.numel() == 0:
            return color
        oh, dh = o[hit], d[hit]
        p, normal, mtype, albedo = self.attributes(oh, dh, tri[hit])
        sub = torch.zeros((hit.numel(), 3), dtype=self.dtype, device=self.dev)
        sh = None if stream is None else (stream[0][hit], stream[1][hit])

        dm = torch.nonzero(mtype == DIFFUSE)[:, 0]
        if dm.numel():
            col = self.direct(p[dm], normal[dm], albedo[dm])
            if self.s.gi_on:
                col = col + self.gi(dh[dm], p[dm], normal[dm], depth,
                                    (sh[0][dm], sh[1][dm]))
                col = col / (self.K + 1)
            sub = sub.index_put((dm,), col)
        rm = torch.nonzero(mtype == REFLECTIVE)[:, 0]
        if rm.numel():
            if self.s.reflections_on:
                n = normal[rm]
                rd = dh[rm] - n * (2.0 * _dot(dh[rm], n))[:, None]
                ro = p[rm] + n * self.bias
                child = self.shade(ro, rd, depth + 1,
                                   None if sh is None else (sh[0][rm], sh[1][rm]))
                col = albedo[rm] * child
            else:
                col = albedo[rm]
            sub = sub.index_put((rm,), col)
        cm = torch.nonzero(mtype == CONSTANT)[:, 0]
        if cm.numel():
            sub = sub.index_put((cm,), albedo[cm])
        return color.index_put((hit,), sub)

    def gi(self, d, p, normal, depth, stream):
        """Sum of the K GI children's colours of diffuse hits."""
        right = _cross(d, normal)
        r2 = _dot(right, right)
        right = torch.where((r2 > 1e-20)[:, None],
                            right / torch.sqrt(torch.clamp(r2, min=1e-20))[:, None],
                            torch.zeros_like(right))
        fwd = _cross(right, normal)
        origin = p + normal * self.bias
        state, inc = stream
        total = torch.zeros_like(p)
        for k in range(self.K):
            u1, state = pcg_uniform(state, inc)
            u2, state = pcg_uniform(state, inc)
            a1 = math.pi * u1.to(self.dtype)
            a2 = (2.0 * math.pi) * u2.to(self.dtype)
            x, y = torch.cos(a1), torch.sin(a1)
            c, s = torch.cos(a2), torch.sin(a2)
            gd = ((x * c)[:, None] * right + y[:, None] * normal
                  + (-x * s)[:, None] * fwd)
            child = pcg_fork(state, inc, k + 1)
            total = total + self.shade(origin, gd, depth + 1, child)
        return total

    # -- frames
    def pixels(self, px, py, cam_rotation, gi_salt=None):
        """Colours [N, 3] of pixels (px, py) with the camera matrix
        ``cam_rotation``, and under GI the pass salt ``gi_salt``."""
        o, d = self.camera_rays(px, py, cam_rotation)
        stream = None
        if self.s.gi_on:
            state, inc = pcg_seed(px.to(torch.int64), py.to(torch.int64))
            if gi_salt:
                state, inc = pcg_fork(state, inc, int(gi_salt))
            stream = (state, inc)
        return self.shade(o, d, 0, stream)

    def frame(self, cam_rotation):
        """The whole frame [H, W, 3]."""
        H, W = self.s.height, self.s.width
        py, px = torch.meshgrid(torch.arange(H, device=self.dev),
                                torch.arange(W, device=self.dev), indexing="ij")
        return self.pixels(px.reshape(-1), py.reshape(-1),
                           cam_rotation).reshape(H, W, 3)

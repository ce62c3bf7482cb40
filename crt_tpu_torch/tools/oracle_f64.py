"""Float64 oracle: vectorized NumPy port of the reference shade_ray.

Counterpart of crt_tpu's ``tools/oracle_f64.py``, whose ``OracleScene``
is copied here (the port's scenes hold torch tensors, read to the host).
It re-implements crt_renderer.cpp:46-145 semantics (diffuse direct
lighting, reflective, refractive with Fresnel blend and TIR, constant,
shadows optional) in float64 over an arbitrary subset of pixels — the
ground truth for diagnosing sub-1/255 golden residuals: if the oracle
matches the committed golden at a disputed pixel, the renderer has a
systematic f32 or semantic deviation there; if not, the golden itself
reflects reference-f32 behavior away from the exact value.

Usage:
    python -m crt_tpu_torch.tools.oracle_f64 <scene.crtscene> <golden-name>
        [--limit N] [--device cpu|cuda]

Renders the frame with the all-pairs backend under the golden's settings
profile, runs the oracle on the pixels where it mismatches the golden
(``$CRT_REFERENCE``), then reports who agrees with whom.
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np


def normalize(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _host(t, dtype=None):
    """A scene tensor as a NumPy array on the host."""
    return np.asarray(t.detach().cpu().numpy(), dtype)


class OracleScene:
    def __init__(self, scene):
        self.v0 = _host(scene.vertices, np.float64)[
            _host(scene.tri_vidx)[:, 0]]
        self.v1 = _host(scene.vertices, np.float64)[
            _host(scene.tri_vidx)[:, 1]]
        self.v2 = _host(scene.vertices, np.float64)[
            _host(scene.tri_vidx)[:, 2]]
        vn = _host(scene.vertex_normals, np.float64)
        tv = _host(scene.tri_vidx)
        self.n0, self.n1, self.n2 = vn[tv[:, 0]], vn[tv[:, 1]], vn[tv[:, 2]]
        e1 = self.v1 - self.v0
        e2 = self.v2 - self.v0
        self.face_n = normalize(np.cross(e1, e2))
        mat = _host(scene.tri_material)
        self.mtype = _host(scene.mat_type)[mat]
        self.albedo = _host(scene.tex_color_a, np.float64)[
            np.maximum(_host(scene.mat_albedo_tex)[mat], 0)]
        self.ior = _host(scene.mat_ior, np.float64)[mat]
        self.smooth = _host(scene.mat_smooth)[mat]
        self.backface = _host(scene.mat_backface)[mat]
        self.lights_p = _host(scene.light_position, np.float64)
        self.lights_i = _host(scene.light_intensity, np.float64)
        self.bg = _host(scene.background_color, np.float64)
        self.reflections_on = scene.reflections_on
        self.refractions_on = scene.refractions_on

    def trace(self, o, d):
        """Closest hit for [N,3] rays -> (t, tri, point, normal)."""
        N = o.shape[0]
        T = self.v0.shape[0]
        best_t = np.full(N, np.inf)
        best_tri = np.full(N, -1, np.int64)
        # chunk triangles to bound memory
        for s in range(0, T, 2048):
            e = min(T, s + 2048)
            v0, v1, v2 = self.v0[s:e], self.v1[s:e], self.v2[s:e]
            n = self.face_n[s:e]
            nd = np.einsum("tc,nc->nt", n, d)
            opd = np.einsum("tc,tc->t", n, v0)[None] - np.einsum(
                "tc,nc->nt", n, o)
            not_par = np.abs(nd) >= 1e-6
            front = opd < 0.0
            face_ok = front | ~self.backface[s:e][None]
            with np.errstate(divide="ignore", invalid="ignore"):
                t = opd / np.where(not_par, nd, 1.0)
            valid = not_par & face_ok & (t >= 0.0)
            p = o[:, None, :] + t[..., None] * d[:, None, :]
            for (a, b) in ((v0, v1), (v1, v2), (v2, v0)):
                cr = np.cross(
                    np.broadcast_to(b - a, p.shape), p - a[None]
                )
                valid &= np.einsum("tc,ntc->nt", n, cr) >= 0.0
            t = np.where(valid, t, np.inf)
            ct = t.min(axis=1)
            ci = t.argmin(axis=1) + s
            better = ct < best_t
            best_t = np.where(better, ct, best_t)
            best_tri = np.where(better, ci, best_tri)
        hit = np.isfinite(best_t)
        tri = np.maximum(best_tri, 0)
        point = o + best_t[:, None] * d
        # smooth or face normal with barycentric interpolation
        v0, v1, v2 = self.v0[tri], self.v1[tri], self.v2[tri]
        v0p = point - v0
        denom = np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
        denom = np.where(denom > 0, denom, 1.0)
        bu = np.linalg.norm(np.cross(v0p, v2 - v0), axis=-1) / denom
        bv = np.linalg.norm(np.cross(v1 - v0, v0p), axis=-1) / denom
        sn = (
            self.n1[tri] * bu[:, None]
            + self.n2[tri] * bv[:, None]
            + self.n0[tri] * (1 - bu - bv)[:, None]
        )
        normal = np.where(
            self.smooth[tri][:, None], sn, self.face_n[tri]
        )
        return best_t, np.where(hit, best_tri, -1), point, normal

    def shade(self, o, d, depth, settings):
        N = o.shape[0]
        if depth > settings.max_ray_depth:
            return np.zeros((N, 3))
        t, tri, point, normal = self.trace(o, d)
        color = np.broadcast_to(self.bg, (N, 3)).copy()
        hit = tri >= 0
        if not hit.any():
            return color
        trih = np.maximum(tri, 0)
        mtype = self.mtype[trih]
        albedo = self.albedo[trih]

        # diffuse
        dm = hit & (mtype == 0)
        if dm.any():
            acc = np.zeros((N, 3))
            for L, I in zip(self.lights_p, self.lights_i):
                lv = L[None] - point
                r2 = (lv ** 2).sum(-1)
                ld = lv / np.sqrt(r2)[:, None]
                cosl = np.maximum(0.0, (ld * normal).sum(-1))
                lit = np.ones(N, bool)
                if not settings.no_shadows:
                    so = point + normal * settings.shadow_bias
                    st, stri, _, _ = self.trace(so, ld)
                    lit = ~(np.isfinite(st) & (st * st <= r2))
                acc += np.where(
                    (lit & dm)[:, None],
                    albedo * (I / (4 * math.pi * r2) * cosl)[:, None],
                    0.0,
                )
            if settings.gi_divide:
                acc /= settings.diffuse_reflection_ray_count + 1
            color = np.where(dm[:, None], acc, color)

        # reflective
        rm = hit & (mtype == 1)
        if rm.any():
            if self.reflections_on and depth <= settings.max_ray_depth:
                rd = d - 2 * (d * normal).sum(-1)[:, None] * normal
                ro = point + normal * settings.reflection_bias
                sub = self.shade(ro[rm], rd[rm], depth + 1, settings)
                a = albedo[rm]
                if settings.hadamard_y:
                    a = a.copy()
                    a[:, 1] *= albedo[rm][:, 1]
                color[rm] = a * sub
            else:
                color[rm] = albedo[rm]

        # refractive (crt_renderer.cpp:109-135 + crt_vector.cpp:11-27)
        fm = hit & (mtype == 2)
        if fm.any():
            if not self.refractions_on:
                color[fm] = 0.0
            else:
                nn = normal.copy()
                out_ior = np.ones(N)
                in_ior = self.ior[trih].copy()
                exiting = (d * nn).sum(-1) > 0
                nn[exiting] = -nn[exiting]
                out_ior[exiting] = self.ior[trih][exiting]
                in_ior[exiting] = 1.0

                cos_a = -(d * nn).sum(-1)
                sin_a = np.sqrt(np.maximum(0.0, 1 - cos_a * cos_a))
                ok = sin_a <= in_ior / out_ior
                sin_b = sin_a * out_ior / in_ior
                cos_b = np.sqrt(np.maximum(0.0, 1 - sin_b * sin_b))
                tang = d + nn * cos_a[:, None]
                tl = np.linalg.norm(tang, axis=-1, keepdims=True)
                tang = tang / np.where(tl > 0, tl, 1.0)
                refr_d = tang * sin_b[:, None] - nn * cos_b[:, None]
                refr_o = point - nn * settings.refraction_bias

                refl_d = d - 2 * (d * nn).sum(-1)[:, None] * nn
                refl_o = point + nn * settings.reflection_bias

                refl_c = np.zeros((N, 3))
                refl_c[fm] = self.shade(
                    refl_o[fm], refl_d[fm], depth + 1, settings
                )
                both = fm & ok
                if both.any():
                    refr_c = np.zeros((N, 3))
                    refr_c[both] = self.shade(
                        refr_o[both], refr_d[both], depth + 1, settings
                    )
                    fres = 0.5 * (1.0 + (d * nn).sum(-1)) ** 5
                    blend = (
                        refl_c * fres[:, None]
                        + refr_c * (1 - fres[:, None])
                    )
                    color[both] = blend[both]
                tir = fm & ~ok
                color[tir] = refl_c[tir]

        # constant
        cm = hit & (mtype == 3)
        color[cm] = albedo[cm]
        return color


def oracle_pixels(scene, settings, xs, ys) -> np.ndarray:
    """The oracle's float64 colours [N, 3] of the primary rays through
    pixels (xs, ys): the rays come from ``ops/camera.generate_rays`` on the
    scene's device, as the renderer's, and are shaded in float64."""
    import torch

    from crt_tpu_torch.ops import camera as camera_ops

    dev = scene.vertices.device
    o, d = camera_ops.generate_rays(
        scene.cam_position, scene.cam_rotation, scene.cam_tan_half_fov,
        scene.width, scene.height,
        torch.as_tensor(np.asarray(xs, np.float32), device=dev),
        torch.as_tensor(np.asarray(ys, np.float32), device=dev),
    )
    o = _host(o, np.float64)
    d = _host(d, np.float64)
    return OracleScene(scene).shade(o, d, 0, settings)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="oracle_f64",
        description="float64 oracle on a golden's disputed pixels")
    p.add_argument("scene")
    p.add_argument("golden_name")
    p.add_argument("--limit", type=int, default=4000)
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; cpu must be asked for)")
    args = p.parse_args(argv)

    from crt_tpu_torch import RenderSettings, load_scene, render_image
    from crt_tpu_torch.tools import resolve_device_arg
    from crt_tpu_torch.utils import golden as G

    device = resolve_device_arg(args.device)
    if device is None:
        return 2
    gname, limit = args.golden_name, args.limit
    scene = load_scene(args.scene, device=device)
    prof = dict(
        next(p for _, n, p in G.HEAD_GOLDEN_CASES if n == gname)
    )
    prof.pop("aov", None)
    settings = RenderSettings(
        backend="bruteforce", chunk_pixels=1 << 16, **prof
    )
    ours = render_image(scene, settings).cpu().numpy()
    g = G.load_golden(gname)
    q = np.clip((ours * 255).astype(int), 0, 255) / 255.0
    bad = np.abs(q - g).max(axis=-1) > 2.5 / 255
    ys, xs = np.nonzero(bad)
    print(f"{gname}: {bad.sum()} disputed pixels; oracle on {min(len(ys), limit)}")
    sel = np.random.default_rng(0).permutation(len(ys))[:limit]
    ys, xs = ys[sel], xs[sel]

    oracle = oracle_pixels(scene, settings, xs, ys)
    oq = np.clip((oracle * 255).astype(int), 0, 255) / 255.0

    gsel = g[ys, xs]
    osel = q[ys, xs]
    tol = 2.5 / 255
    oracle_matches_golden = (np.abs(oq - gsel).max(axis=-1) <= tol)
    oracle_matches_ours = (np.abs(oq - osel).max(axis=-1) <= tol)
    print(f"oracle == golden: {oracle_matches_golden.mean():.3f}")
    print(f"oracle == ours:   {oracle_matches_ours.mean():.3f}")
    print(f"neither:          {(~oracle_matches_golden & ~oracle_matches_ours).mean():.3f}")
    # show a few three-way comparisons
    for i in range(min(8, len(ys))):
        print(
            f"  ({ys[i]},{xs[i]}) golden={np.round(gsel[i],3)} "
            f"ours={np.round(osel[i],3)} oracle={np.round(oq[i],3)}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())

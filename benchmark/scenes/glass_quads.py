"""The ``glass_quads`` scene kind: the ``quads`` scene with a fourth
material, glass (ior 1.5, smooth shading), and its own reference renderer.

The scene is the port's ``make_test_scene_dict(..., with_refractive=True)``
as of this file, frozen here: a floor, random single-triangle quads drawn
over diffuse, smooth diffuse, mirror and glass, two point lights.  It
stands in for the course's refraction task (``scenes/11-01-refractive``),
whose scene files are not in the repository.

``Renderer`` is the base reference (``reference/render.py``) with what the
course's refractive material adds, written out in plain PyTorch in any
dtype, with nothing of the program:

  - at a refractive hit the shading normal is flipped, and the iors
    swapped, where the ray leaves the volume (d.n > 0); the refracted
    direction is Snell's law in its vector form, eta d + (eta cos_i -
    sqrt(k)) n with eta = eta_i / eta_t and k = 1 - eta^2 (1 - cos_i^2),
    and k < 0 is total internal reflection;
  - the colour is the Fresnel blend fresnel * reflected + (1 - fresnel) *
    refracted, fresnel = 0.5 (1 + d.n)^5 about the flipped normal, the
    reflected ray from point + n * bias and the refracted one from point -
    n * bias; on total internal reflection the reflected colour alone;
  - shadow rays bend through glass (the transmissive march): from point +
    N * bias toward the light, each segment's closest hit that is
    refractive (and not a total internal reflection about its face normal,
    flipped as above) bends the ray, which goes on from the hit point -
    n * bias; the walk traces at most ``max_ray_depth`` + 1 segments, and
    ends at a miss, a non-refractive hit or a total internal reflection.
    The light is hidden where the last segment's hit lies within the
    light's distance from the shaded point (t^2 <= r^2, t along that
    segment).

Departures from the course's C++ (``crt_renderer.cpp``): the march is the
intent of ``trace_ray_with_refractions`` as live at the course's 11-01
tags; at the repository's HEAD its loop never runs, and no shadow falls.
One bias (1e-2) serves shadows, reflections and refraction, each the
course's default.  Refraction under diffuse GI has no reference here: the
port's bank wavefront forks the Fresnel reflection's PCG32 stream, which a
depth-first renderer does not follow, so a description with GI on raises.
"""

import math
from dataclasses import dataclass

import numpy as np
import torch

from reference import render
from reference.render import (
    CONSTANT,
    DIFFUSE,
    REFLECTIVE,
    REFRACTIVE,
    RefScene,
    _dot,
)


def description(p: dict, gi_on: bool = False) -> dict:
    """The .crtscene dict of a ``glass_quads`` configuration."""
    if gi_on:
        raise ValueError("the glass_quads reference has no GI")
    rng = np.random.default_rng(p["layout_seed"])
    objects = [{"material_index": 0,
                "vertices": [-20, -2, 20, 20, -2, 20, -20, -2, -20,
                             20, -2, -20],
                "triangles": [0, 1, 2, 3, 2, 1]}]
    mats = [
        {"type": "diffuse", "albedo": [0.7, 0.7, 0.7], "smooth_shading": False},
        {"type": "diffuse", "albedo": [0.9, 0.2, 0.2], "smooth_shading": True},
    ]
    if p.get("with_reflective", True):
        mats.append({"type": "reflective", "albedo": [0.8, 0.8, 0.9],
                     "smooth_shading": False})
    if p.get("with_refractive", True):
        mats.append({"type": "refractive", "ior": 1.5, "smooth_shading": True})
    for _ in range(p["num_quads"]):
        c = rng.uniform(-6, 6, 3)
        c[1] = rng.uniform(-1.5, 3.0)
        c[2] = -abs(c[2]) - 3.0
        s = rng.uniform(0.4, 1.2)
        v = np.array([c + [-s, -s, 0], c + [s, -s, 0], c + [0, s, 0]],
                     np.float32)
        objects.append({"material_index": int(rng.integers(1, len(mats))),
                        "vertices": v.reshape(-1).tolist(),
                        "triangles": [0, 1, 2]})
    return {
        "settings": {"background_color": [0.1, 0.2, 0.3],
                     "image_settings": {"width": p["width"],
                                        "height": p["height"]},
                     "gi_on": gi_on},
        "camera": {"matrix": [1, 0, 0, 0, 1, 0, 0, 0, 1],
                   "position": [0, 0, 6]},
        "lights": [{"intensity": 800, "position": [3, 6, 2]},
                   {"intensity": 300, "position": [-4, 5, -1]}],
        "materials": mats,
        "objects": objects,
    }


def program_scene(desc, device):
    """The program's Scene, through its own loader."""
    from crt_tpu_torch.scene.json_loader import scene_from_dict

    return scene_from_dict(desc, build_accel=False, device=device)


@dataclass
class GlassRefScene(RefScene):
    """A RefScene with each material's ior.  (The module is loaded by its
    path and is in no ``sys.modules``, so its annotations are objects, not
    strings.)"""

    mat_ior: np.ndarray = None  # [M]


def reference_scene(desc) -> GlassRefScene:
    """The reference's scene: the base conversion, with each refractive
    material parsed as a black constant and then given back its type and
    ior.  A refractive material has no albedo, so the texture rows the
    stand-ins added are taken out again: the texture table is the
    program's, row for row."""
    mats = desc["materials"]
    refr = [m["type"] == "refractive" for m in mats]
    stand_in = dict(desc, materials=[
        {"type": "constant", "albedo": [0.0, 0.0, 0.0],
         "smooth_shading": m["smooth_shading"]} if g else m
        for m, g in zip(mats, refr)])
    s = render.scene_from_description(stand_in)
    refr = np.asarray(refr)
    gone = set(s.mat_tex[refr].tolist())
    keep = [i for i in range(len(s.params["tex_color_a"])) if i not in gone]
    row = {old: new for new, old in enumerate(keep)}
    s.params["tex_color_a"] = s.params["tex_color_a"][keep]
    s.params["tex_color_b"] = s.params["tex_color_b"][keep]
    mat_tex = np.asarray([0 if g else row[t] for t, g in
                          zip(s.mat_tex.tolist(), refr)])
    mat_type = np.where(refr, REFRACTIVE, s.mat_type)
    ior = np.asarray([float(np.float32(m.get("ior", 1.0))) if g else 1.0
                      for m, g in zip(mats, refr)])
    fields = {f: getattr(s, f) for f in RefScene.__dataclass_fields__}
    fields.update(mat_tex=mat_tex, mat_type=mat_type)
    return GlassRefScene(**fields, mat_ior=ior)


def refract(d, n, eta_i, eta_t):
    """Snell's law for unit d at unit n facing the incoming ray ->
    (direction, ok); ``ok`` False on total internal reflection, where the
    direction is d."""
    eta = eta_i / eta_t
    cos_i = -_dot(d, n)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    ok = k >= 0
    t = eta[:, None] * d + (eta * cos_i - torch.sqrt(torch.clamp(k, min=0.0))
                            )[:, None] * n
    return torch.where(ok[:, None], t, d), ok


def facing(d, n, ior):
    """The normal flipped to face the ray, and (eta_i, eta_t): the ray
    leaves the volume where d.n > 0."""
    exiting = _dot(d, n) > 0
    one = torch.ones_like(ior)
    return (torch.where(exiting[:, None], -n, n),
            torch.where(exiting, ior, one), torch.where(exiting, one, ior))


class Renderer(render.Renderer):
    """The base reference with refraction, the Fresnel pair and the
    transmissive shadow march (the module's docstring)."""

    def __init__(self, scene: GlassRefScene, *args, **kwargs):
        super().__init__(scene, *args, **kwargs)
        mat = scene.tri_mat
        self.t_ior = torch.as_tensor(scene.mat_ior[mat], device=self.dev
                                     ).to(self.dtype)
        self.t_refr = torch.as_tensor(scene.mat_type[mat] == REFRACTIVE,
                                      device=self.dev)

    def shade(self, o, d, depth, stream=None):
        """Colour [N, 3] of rays (o, d) at ``depth`` (no GI: ``stream`` is
        unused)."""
        N = o.shape[0]
        if depth > self.depth:
            return torch.zeros((N, 3), dtype=self.dtype, device=self.dev)
        _, tri = self.closest(o, d)
        color = self.bg.expand(N, 3)
        hit = torch.nonzero(tri >= 0)[:, 0]
        if hit.numel() == 0:
            return color
        dh = d[hit]
        p, normal, mtype, albedo = self.attributes(o[hit], dh, tri[hit])
        sub = torch.zeros((hit.numel(), 3), dtype=self.dtype, device=self.dev)

        dm = torch.nonzero(mtype == DIFFUSE)[:, 0]
        if dm.numel():
            sub = sub.index_put((dm,), self.direct(p[dm], normal[dm],
                                                   albedo[dm]))
        rm = torch.nonzero(mtype == REFLECTIVE)[:, 0]
        if rm.numel():
            if self.s.reflections_on:
                n = normal[rm]
                rd = dh[rm] - n * (2.0 * _dot(dh[rm], n))[:, None]
                col = albedo[rm] * self.shade(p[rm] + n * self.bias, rd,
                                              depth + 1)
            else:
                col = albedo[rm]
            sub = sub.index_put((rm,), col)
        gm = torch.nonzero(mtype == REFRACTIVE)[:, 0]
        if gm.numel():
            sub = sub.index_put((gm,), self.glass(
                dh[gm], p[gm], normal[gm], self.t_ior[tri[hit][gm]], depth))
        cm = torch.nonzero(mtype == CONSTANT)[:, 0]
        if cm.numel():
            sub = sub.index_put((cm,), albedo[cm])
        return color.index_put((hit,), sub)

    def glass(self, d, p, normal, ior, depth):
        """Colour of refractive hits: the Fresnel blend of the reflected
        and the refracted ray, the reflection alone on total internal
        reflection."""
        n, eta_i, eta_t = facing(d, normal, ior)
        dn = _dot(d, n)
        refl = self.shade(p + n * self.bias, d - n * (2.0 * dn)[:, None],
                          depth + 1)
        rd, ok = refract(d, n, eta_i, eta_t)
        through = torch.nonzero(ok)[:, 0]
        if through.numel() == 0:
            return refl
        refr = self.shade((p - n * self.bias)[through], rd[through],
                          depth + 1)
        f = (0.5 * (1.0 + dn[through]) ** 5)[:, None]
        return refl.index_put((through,), refl[through] * f + refr * (1.0 - f))

    def direct(self, p, normal, albedo):
        """Direct light of diffuse hits, each shadow ray marched through
        glass -> [N, 3]."""
        lum = torch.zeros(p.shape[0], dtype=self.dtype, device=self.dev)
        for k in range(self.light_pos.shape[0]):
            lv = self.light_pos[k][None] - p
            r2 = _dot(lv, lv)
            ld = lv / torch.sqrt(r2)[:, None]
            cosl = torch.clamp(_dot(ld, normal), min=0.0)
            lit_facing = (cosl > 0).detach()
            lit = torch.zeros_like(lit_facing)
            if bool(lit_facing.any()):
                so = (p + normal * self.bias)[lit_facing].detach()
                lit[lit_facing] = ~self.march(so, ld[lit_facing].detach(),
                                              r2.detach()[lit_facing])
            term = self.params["light_intensity"][k] / (4.0 * math.pi * r2) \
                * cosl
            lum = lum + torch.where(lit, term, torch.zeros_like(term))
        return albedo * lum[:, None]

    def march(self, o, d, r2):
        """Whether each shadow ray (o, d), marched through glass, is
        hidden from its light at squared distance ``r2`` -> bool [N]."""
        o, d = o.clone(), d.clone()
        last_valid = torch.zeros(o.shape[0], dtype=torch.bool, device=self.dev)
        last_t = torch.zeros(o.shape[0], dtype=self.dtype, device=self.dev)
        alive = torch.ones_like(last_valid)
        for _ in range(self.depth + 1):
            idx = torch.nonzero(alive)[:, 0]
            if idx.numel() == 0:
                break
            oo, dd = o[idx], d[idx]
            t, tri = self.closest(oo, dd)
            valid = tri >= 0
            t = torch.where(valid, t, torch.zeros_like(t))
            last_valid[idx] = valid
            last_t[idx] = t
            tri = tri.clamp(min=0)
            n, eta_i, eta_t = facing(dd, self.g_n[tri], self.t_ior[tri])
            nd, ok = refract(dd, n, eta_i, eta_t)
            bend = valid & self.t_refr[tri] & ok
            o[idx] = torch.where(bend[:, None], oo + dd * t[:, None]
                                 - n * self.bias, oo)
            d[idx] = torch.where(bend[:, None], nd, dd)
            alive[idx] = bend
        return last_valid & (last_t * last_t <= r2)

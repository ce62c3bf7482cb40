"""Wavefront Whitted shading, differentiable.

Counterpart of ``crt_tpu/ops/shade.py``.  The
recursion is unrolled over the whole ray wavefront: every level traces its
[R] rays once, material behavior is applied with masks, and the mirror
bounce recurses into the next level with an active mask.

  - depth cutoff -> black; miss -> scene background
  - diffuse: sum over lights of albedo * intensity / (4 pi r^2) *
    max(0, L.N), with shadow occlusion (hit_dist^2 > r^2 means lit)
  - reflective: albedo (*) shade(reflected), or plain albedo when
    reflections are off
  - constant: albedo
  - ``head_compat``: no shadows, the unconditional divide by
    ``diffuse_reflection_ray_count + 1``, the Hadamard y typo

Refractive materials (ROADMAP A7) and GI (ROADMAP A8) raise
``NotImplementedError``.

Gradient contract: hit ids, material / texture codes and occlusion masks
are constants (every trace sees detached geometry and rays); everything
else differentiates through the scene tensors.  The read of the packed
per-triangle table at the hit ids goes through the adapters of
``ops/segsum.py``, whose backward is the segment-sum kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from crt_tpu_torch.ops import vecmath
from crt_tpu_torch.ops.intersect import Hit
from crt_tpu_torch.ops.segsum import (
    packed_gather,
    packed_gather_ranked,
    packed_rows_from_kernel,
)
from crt_tpu_torch.ops.texture import sample_textures
from crt_tpu_torch.scene.types import (
    MATERIAL_CONSTANT,
    MATERIAL_DIFFUSE,
    MATERIAL_REFLECTIVE,
    TEXTURE_BITMAP,
    TEXTURE_CHECKER,
    TEXTURE_EDGES,
)

_PI = math.pi

# 07-era light direction for material-less scenes (see crt_tpu/ops/shade.py).
ERA07_LIGHT_DIR = (0.3809265, 0.7244545, 0.5750355)


class HitAttributes(NamedTuple):
    """Per-ray hit attributes recomputed from triangle ids.  Lanes where
    ``valid`` is False hold safe dummy values."""

    valid: torch.Tensor  # [R] bool
    t: torch.Tensor  # [R] f32 hit distance
    point: torch.Tensor  # [R, 3]
    normal: torch.Tensor  # [R, 3] shading normal (smooth or face)
    uv: torch.Tensor  # [R, 3]
    bary_u: torch.Tensor  # [R]
    bary_v: torch.Tensor  # [R]
    mat_type: torch.Tensor  # [R] i32
    albedo_tex: torch.Tensor  # [R] i32
    ior: torch.Tensor  # [R] f32


def check_supported(scene, settings=None) -> None:
    """Raise NotImplementedError for a scene or setting outside the slice."""
    if scene.has_refractive:
        raise NotImplementedError(
            "refractive materials are not ported yet (ROADMAP A7)")
    if scene.gi_on:
        raise NotImplementedError("GI is not ported yet (ROADMAP A8)")
    if TEXTURE_BITMAP in scene.texture_types_present:
        raise NotImplementedError(
            "bitmap textures are not ported yet (ROADMAP A9)")
    if settings is None:
        return
    if settings.aov:
        raise NotImplementedError("AOV passes are not ported yet (ROADMAP A10)")
    if settings.wavefront == "iter":
        raise NotImplementedError(
            "the iterative bank wavefront is not ported yet (ROADMAP A7)")


def _needs_uv(scene) -> bool:
    """uv interpolation feeds only checker and bitmap sampling."""
    return (
        TEXTURE_CHECKER in scene.texture_types_present
        or TEXTURE_BITMAP in scene.texture_types_present
    )


def _needs_bary(scene) -> bool:
    """barycentrics feed smooth normals, uv interpolation and edges."""
    return (
        scene.any_smooth
        or _needs_uv(scene)
        or TEXTURE_EDGES in scene.texture_types_present
    )


def build_packed(scene) -> torch.Tensor:
    """The per-triangle shading-constant table, transposed [K, T].

    Layout: v0|v1|v2 (+n0|n1|n2 if smooth needed) (+uv0|uv1|uv2 if uv
    needed) | mat_type|mat_albedo_tex|mat_smooth|mat_ior — the four
    material rows are always the last four.  Small ints are exact in f32.
    The discrete material rows are detached; the ior row stays
    differentiable.
    """
    idx = scene.tri_vidx.long()
    cols = [scene.vertices[idx[:, 0]], scene.vertices[idx[:, 1]],
            scene.vertices[idx[:, 2]]]
    if scene.any_smooth:
        cols += [scene.vertex_normals[idx[:, k]] for k in range(3)]
    if _needs_uv(scene):
        cols += [scene.vertex_uvs[idx[:, k]] for k in range(3)]
    if scene.has_materials:
        mt = scene.tri_material.long()
        cols += [
            scene.mat_type[mt].to(torch.float32).detach()[:, None],
            scene.mat_albedo_tex[mt].to(torch.float32).detach()[:, None],
            scene.mat_smooth[mt].to(torch.float32).detach()[:, None],
            scene.mat_ior[mt][:, None],
        ]
    else:
        cols += [torch.zeros((idx.shape[0], 4), dtype=torch.float32,
                             device=idx.device)]
    return torch.cat(cols, dim=-1).T  # [K, T]


def hit_attributes(scene, origins, dirs, hit: Hit, kernel_rows=None,
                   rank=None) -> HitAttributes:
    """Recompute intersection attributes from the hit triangle ids.

    ``hit.tri`` is a constant (a discrete choice); everything else
    differentiates through the scene tensors.  ``kernel_rows`` ([K+1, R],
    from ``trace.with_rows``) supplies the packed rows the closest-hit
    kernel emitted (the last row is the slot rank), and
    ``packed_rows_from_kernel`` routes their cotangents into the scene;
    without it the rows are gathered from ``build_packed`` through
    ``packed_gather_ranked`` (``packed_gather`` when the trace has no
    ``rank``, the [T] triangle id -> Morton rank map).  A table that needs
    a gradient is always read through an adapter, whatever the shape of
    the ray batch; one that needs none is read without.
    """
    tri_raw = hit.tri.detach()
    valid = tri_raw >= 0
    tri_flat = tri_raw.reshape(-1)  # the adapters take one ray axis

    need_uv = _needs_uv(scene)
    need_bary = _needs_bary(scene)
    any_smooth = scene.any_smooth

    packed = build_packed(scene)
    want_grad = packed.requires_grad and torch.is_grad_enabled()
    if kernel_rows is not None:
        rows = kernel_rows[:-1].detach()
        if want_grad:
            if rank is None:
                raise ValueError("kernel_rows need the trace's rank map")
            ranked = torch.where(
                tri_flat >= 0, kernel_rows[-1].detach().to(torch.int32), -1)
            rows = packed_rows_from_kernel(packed, rows, ranked, rank)
        # Miss lanes: the gather path yields triangle 0's row (clamped
        # index); the kernel leaves them zero — patch for bit-parity.
        # Their cotangents are exactly zero either way.
        rows = torch.where((tri_flat >= 0)[None], rows,
                           packed[:, 0:1].detach())
    elif want_grad and rank is not None:
        rows = packed_gather_ranked(packed, tri_flat, rank)
    elif want_grad:
        rows = packed_gather(packed, tri_flat.clamp(min=0))
    else:
        rows = packed[:, tri_flat.clamp(min=0).long()]
    rows = rows.reshape((rows.shape[0],) + tuple(tri_raw.shape))  # [K, *R]

    def col3(o):
        return rows[o:o + 3].movedim(0, -1)  # [R, 3]

    v0, v1, v2 = col3(0), col3(3), col3(6)
    off = 9

    face_n = vecmath.safe_normalize(vecmath.cross(v1 - v0, v2 - v0))
    nd = vecmath.dot(face_n, dirs)
    opd = vecmath.dot(face_n, v0 - origins)
    t = opd / torch.where(nd.abs() > 0, nd, torch.ones_like(nd))
    t = torch.where(valid, t, torch.zeros_like(t))
    point = origins + dirs * t[..., None]

    zeros = torch.zeros_like(t)
    if need_bary:
        v0p = point - v0
        v0v1 = v1 - v0
        v0v2 = v2 - v0
        denom = vecmath.length(vecmath.cross(v0v1, v0v2))
        denom = torch.where(denom > 0, denom, torch.ones_like(denom))
        bary_u = vecmath.safe_length(vecmath.cross(v0p, v0v2)) / denom
        bary_v = vecmath.safe_length(vecmath.cross(v0v1, v0p)) / denom
    else:
        bary_u = bary_v = zeros

    normal = face_n
    if any_smooth:
        n0, n1, n2 = col3(off), col3(off + 3), col3(off + 6)
        off += 9
        # the interpolated normal is not renormalized (reference behavior)
        smooth_n = (
            n1 * bary_u[..., None]
            + n2 * bary_v[..., None]
            + n0 * (1.0 - bary_u - bary_v)[..., None]
        )
        smooth_flag = rows[-2] > 0.5  # mat_smooth row
        normal = torch.where(smooth_flag[..., None], smooth_n, face_n)

    if need_uv:
        uv0, uv1, uv2 = col3(off), col3(off + 3), col3(off + 6)
        uv = (
            uv1 * bary_u[..., None]
            + uv2 * bary_v[..., None]
            + uv0 * (1.0 - bary_u - bary_v)[..., None]
        )
    else:
        uv = torch.zeros_like(point)

    return HitAttributes(
        valid=valid,
        t=t,
        point=point,
        normal=normal,
        uv=uv,
        bary_u=bary_u,
        bary_v=bary_v,
        mat_type=rows[-4].detach().to(torch.int32),
        albedo_tex=rows[-3].detach().to(torch.int32),
        ior=rows[-1],
    )


def _hadamard(albedo, color, hadamard_y: bool):
    """albedo (*) color — with the reference operator* typo when
    hadamard_y (the y component gets an extra albedo.y factor)."""
    out = albedo * color
    if hadamard_y:
        out = torch.cat(
            [out[..., 0:1], out[..., 1:2] * albedo[..., 1:2], out[..., 2:3]],
            dim=-1,
        )
    return out


def _occlusion_masks(scene, trace_fn, point, normal, light_positions,
                     shadow_bias, no_shadows, shadow_active):
    """is_illuminated per (light, ray), all lights in one batched pass.

    Returns (illuminated [Ll, R] bool, light_dir [Ll, R, 3], r2 [Ll, R]).
    A trace with ``shadow_apex_w`` (the cluster backend) tests occlusion in
    the kernel along the unnormalized w = light - point (s <= 1 is the
    reference's t^2 <= r^2); any other trace takes the closest hit of the
    stacked [Ll*R] shadow wavefront.
    """
    light_vec = light_positions[:, None, :] - point[None]  # [Ll, R, 3]
    r2 = vecmath.length_squared(light_vec)
    light_dir = vecmath.safe_normalize(light_vec)
    if no_shadows:
        return torch.ones(r2.shape, dtype=torch.bool,
                          device=r2.device), light_dir, r2

    shadow_o_px = point + normal * shadow_bias  # [R, 3], light-invariant
    # Lanes facing away contribute zero whatever the occlusion: drop them
    # from the binning mask.
    facing = vecmath.dot(light_dir, normal[None].expand_as(light_vec)) > 0.0
    act_lr = shadow_active[None] & facing.detach()  # [Ll, R]

    apex_w_fn = getattr(trace_fn, "shadow_apex_w", None)
    if apex_w_fn is not None and point.dim() == 2:
        occluded = apex_w_fn(point.detach(), shadow_o_px.detach(),
                             light_positions.detach(), act_lr,
                             2.0 * shadow_bias)
        if occluded is not None:
            return ~occluded.reshape(r2.shape), light_dir, r2

    # the occlusion mask is a constant: the shadow trace sees no graph
    shadow_o = shadow_o_px.detach().expand(light_vec.shape).reshape(-1, 3)
    sh = trace_fn(shadow_o, light_dir.detach().reshape(-1, 3),
                  act_lr.reshape(-1))
    occluded = sh.valid & (sh.t * sh.t <= r2.detach().reshape(-1))
    return ~occluded.reshape(r2.shape), light_dir, r2


def shade_wavefront(scene, settings, trace_fn, origins, dirs,
                    active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Shade a camera-ray wavefront -> [R, 3] linear colors.

    ``trace_fn(origins, dirs, active) -> Hit`` is the intersection backend.
    ``active=False`` lanes (chunk padding) produce arbitrary colors the
    caller discards; they are dropped from the trace binning.
    """
    check_supported(scene)
    if active is None:
        active = torch.ones(origins.shape[:-1], dtype=torch.bool,
                            device=origins.device)
    return _shade_level(scene, settings, trace_fn, origins, dirs, 0, active)


def _shade_level(scene, settings, trace_fn, origins, dirs, depth, active):
    """One unrolled recursion level -> color [R, 3]."""
    R = origins.shape[:-1]
    black = torch.zeros(R + (3,), dtype=torch.float32, device=origins.device)
    if depth > settings.max_ray_depth:
        return black

    kernel_rows = None
    if hasattr(trace_fn, "with_rows"):
        hit, kernel_rows = trace_fn.with_rows(origins, dirs, active)
    else:
        hit = trace_fn(origins, dirs, active)
    attrs = hit_attributes(scene, origins, dirs, hit, kernel_rows=kernel_rows,
                           rank=getattr(trace_fn, "rank", None))

    if not scene.has_materials:
        # 07-era material-less scenes: gray half-lambert on the face normal.
        light_dir = torch.tensor(ERA07_LIGHT_DIR, dtype=torch.float32,
                                 device=origins.device)
        gray = 0.5 + 0.5 * vecmath.dot(attrs.normal, light_dir)
        legacy = gray[..., None].expand(R + (3,))
        return torch.where(attrs.valid[..., None], legacy,
                           scene.background_color)

    albedo = sample_textures(scene, attrs.albedo_tex, attrs.uv,
                             attrs.bary_u, attrs.bary_v)

    is_diffuse = attrs.valid & (attrs.mat_type == MATERIAL_DIFFUSE)
    is_reflective = attrs.valid & (attrs.mat_type == MATERIAL_REFLECTIVE)
    is_constant = attrs.valid & (attrs.mat_type == MATERIAL_CONSTANT)
    normal = attrs.normal
    point = attrs.point

    # ---- reflection batch (mirror lanes only; refraction is ROADMAP A7)
    want_reflect = scene.has_reflective and scene.reflections_on
    if want_reflect and depth < settings.max_ray_depth + 1:
        refl_dir = vecmath.reflect(dirs, normal)
        refl_origin = point + normal * settings.reflection_bias
        refl_color = _shade_level(scene, settings, trace_fn, refl_origin,
                                  refl_dir, depth + 1, active & is_reflective)
    else:
        refl_color = black

    # ---- diffuse
    diffuse_color = black
    if scene.num_lights > 0:
        illuminated, light_dir, r2 = _occlusion_masks(
            scene, trace_fn, point, normal, scene.light_position,
            settings.shadow_bias, settings.no_shadows,
            shadow_active=active & is_diffuse,
        )  # [Ll, R](, 3)
        cos_law = torch.clamp(vecmath.dot(light_dir, normal[None]), min=0.0)
        sphere_area = 4.0 * _PI * r2
        terms = torch.where(
            illuminated,
            scene.light_intensity[:, None] / sphere_area * cos_law,
            torch.zeros_like(r2),
        )  # [Ll, R]
        lum = terms[0]
        for k in range(1, terms.shape[0]):
            lum = lum + terms[k]
        diffuse_color = diffuse_color + albedo * lum[..., None]

    if settings.gi_divide:
        diffuse_color = diffuse_color / (settings.diffuse_reflection_ray_count + 1)

    # ---- reflective
    if want_reflect:
        reflective_color = _hadamard(albedo, refl_color, settings.hadamard_y)
    else:
        reflective_color = albedo  # reflections off

    color = torch.where(is_diffuse[..., None], diffuse_color,
                        scene.background_color)
    if scene.has_reflective:
        color = torch.where(is_reflective[..., None], reflective_color, color)
    if scene.has_constant:
        color = torch.where(is_constant[..., None], albedo, color)
    return color

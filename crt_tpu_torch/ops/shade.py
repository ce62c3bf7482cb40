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

  - refractive: the Fresnel blend of the reflected and the refracted
    ray about the (possibly flipped) normal, the full reflection on total
    internal reflection, black when refractions are off; shadow rays bend
    through glass (the transmissive march of ``_occlusion_masks``)

This module holds the unrolled recursion (``wavefront="recursive"``); the
iterative bank wavefront that refractive scenes take by default is
``ops/shade_iter.py``, which shares ``hit_attributes`` and
``_occlusion_masks``.  The AOV passes (``renderer.render_aov``) read
``hit_attributes(..., force_all=True)`` of the primary hits.

  - diffuse GI (``scene.gi_on``): K = ``diffuse_reflection_ray_count``
    hemisphere samples a diffuse hit, each from two uniforms of the
    pixel's PCG32 stream (``ops/rng.py``, seeded from the raster x / y
    and forked per progressive pass by ``gi_salt``), drawn with masked
    advancement in the reference's depth-first order; the diffuse colour
    is divided by K + 1

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

from crt_tpu_torch.ops import rng as rng_mod
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
    MATERIAL_REFRACTIVE,
    TEXTURE_BITMAP,
    TEXTURE_CHECKER,
    TEXTURE_EDGES,
)
from crt_tpu_torch.utils import trace as tracing

_PI = math.pi

# 07-era light direction for material-less scenes (see crt_tpu/ops/shade.py).
ERA07_LIGHT_DIR = (0.3809265, 0.7244545, 0.5750355)

# The transmissive shadow march of a refractive scene.  With the split, one
# pass of the w-occlusion kernel in its glass-flag mode routes the shadow
# lanes: those whose ray meets no glass take its occlusion bits, and only
# the glass-suspect ones pay the bend-walk.  With the narrowing, that walk
# runs over the live 1024-lane blocks only.  Both are bit-exact and on;
# the tests switch them off to hold them to the full-width march.
_MARCH_SPLIT = True
_MARCH_NARROW = True
_MARCH_BLOCK = 1024  # the pixel-tile quantum (renderer.TILE_H * TILE_W)


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


def build_packed(scene, force_all: bool = False) -> torch.Tensor:
    """The per-triangle shading-constant table, transposed [K, T].

    Layout: v0|v1|v2 (+n0|n1|n2 if smooth needed) (+uv0|uv1|uv2 if uv
    needed; both with ``force_all``) | mat_type|mat_albedo_tex|mat_smooth|
    mat_ior — the four material rows are always the last four.  Small
    ints are exact in f32.
    The discrete material rows are detached; the ior row stays
    differentiable and is read through ``segsum.packed_gather``.
    """
    idx = scene.tri_vidx.long()
    cols = [scene.vertices[idx[:, 0]], scene.vertices[idx[:, 1]],
            scene.vertices[idx[:, 2]]]
    if scene.any_smooth or force_all:
        cols += [scene.vertex_normals[idx[:, k]] for k in range(3)]
    if _needs_uv(scene) or force_all:
        cols += [scene.vertex_uvs[idx[:, k]] for k in range(3)]
    if scene.has_materials:
        mt = scene.tri_material.long()
        cols += [
            scene.mat_type[mt].to(torch.float32).detach()[:, None],
            scene.mat_albedo_tex[mt].to(torch.float32).detach()[:, None],
            scene.mat_smooth[mt].to(torch.float32).detach()[:, None],
            # a small table with grad: its backward is the segment sum
            packed_gather(scene.mat_ior[None, :], mt).T,
        ]
    else:
        cols += [torch.zeros((idx.shape[0], 4), dtype=torch.float32,
                             device=idx.device)]
    return torch.cat(cols, dim=-1).T  # [K, T]


def hit_attributes(scene, origins, dirs, hit: Hit, kernel_rows=None,
                   rank=None, force_all: bool = False,
                   read_rows=None) -> HitAttributes:
    """Recompute intersection attributes from the hit triangle ids.

    ``hit.tri`` is a constant (a discrete choice); everything else
    differentiates through the scene tensors.  ``kernel_rows`` ([K+1, R],
    from ``tracer.with_rows``) supplies the packed rows the closest-hit
    kernel emitted (the last row is the slot rank), and
    ``packed_rows_from_kernel`` routes their cotangents into the scene;
    without it the rows are gathered from ``build_packed`` through
    ``packed_gather_ranked`` (``packed_gather`` when the tracer has no
    ``rank``, the [T] triangle id -> Morton rank map).  A table that needs
    a gradient is always read through an adapter, whatever the shape of
    the ray batch; one that needs none is read without.  ``read_rows(tri)
    -> [K, R]`` (a tracer's ``read_rows``) replaces every read of the
    packed table (a scene-partitioned render: each rank holds a shard of
    the table and the rows come back through an exchange,
    ``parallel/scene_sharded.py``).
    """
    tri_raw = hit.tri.detach()
    valid = tri_raw >= 0
    tri_flat = tri_raw.reshape(-1)  # the adapters take one ray axis

    need_uv = _needs_uv(scene) or force_all
    need_bary = _needs_bary(scene) or force_all
    any_smooth = scene.any_smooth or force_all

    packed = None if read_rows is not None else build_packed(scene,
                                                             force_all)
    want_grad = (packed is not None and packed.requires_grad
                 and torch.is_grad_enabled())
    if read_rows is not None:
        rows = read_rows(tri_flat.clamp(min=0))
    elif kernel_rows is not None:
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


def light_sum(scene, illuminated, light_dir, r2, normal):
    """Direct-light radiance weight per ray -> [R]: the sum over lights of
    intensity / (4 pi r^2) * max(0, L.N) where lit, lights added in
    order."""
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
    return lum


def march_table(scene, read_rows=None):
    """[5, T] constants of the transmissive march, one column gather per
    step: the face normal (rows 0-2), "is refractive" (row 3), the ior
    (row 4).  Constants: the march decides visibility only.  With a
    tracer's ``read_rows`` (a scene-partitioned render, where no rank
    holds the vertices) a function of the ids to those columns instead
    (``_march_rows``)."""
    if read_rows is not None:
        return _march_rows(scene, read_rows)
    verts = scene.vertices.detach()
    tv = scene.tri_vidx.long()
    v0, v1, v2 = verts[tv[:, 0]], verts[tv[:, 1]], verts[tv[:, 2]]
    face_n = vecmath.safe_normalize(vecmath.cross(v1 - v0, v2 - v0))
    mat = scene.tri_material.long()
    return torch.cat([
        face_n.T,
        (scene.mat_type[mat] == MATERIAL_REFRACTIVE).to(torch.float32)[None],
        scene.mat_ior.detach()[mat][None],
    ], dim=0)


def _march_rows(scene, read_rows):
    """``march_table``'s columns at triangle ids, read through
    ``read_rows``: tri [N] -> [5, N], the face normal from the packed rows'
    v0 | v1 | v2, the material rows from the replicated material tables."""
    mat_refr = (scene.mat_type == MATERIAL_REFRACTIVE).to(torch.float32)

    def rows(tri):
        r = read_rows(tri).detach()
        v0, v1, v2 = (r[o:o + 3].movedim(0, -1) for o in (0, 3, 6))
        face_n = vecmath.safe_normalize(vecmath.cross(v1 - v0, v2 - v0))
        mat = scene.tri_material.long()[tri]
        return torch.cat([face_n.T, mat_refr[mat][None],
                          scene.mat_ior.detach()[mat][None]], dim=0)

    return rows


def _march_step(tracer, march_tab, refraction_bias, carry):
    """One segment of the bend-walk: trace the marching lanes, record the
    hit, and bend the lanes that hit glass (total internal reflection
    stops a lane: the glass surface occludes).  ``march_tab`` is
    ``march_table``'s [5, T] or a function of the ids to its columns."""
    o, d, alive, last_valid, last_t = carry
    tracing.count("crt.march.traces")
    with tracing.span("crt.trace"):
        sh = tracer(o, d, alive)
    tri = torch.clamp(sh.tri, min=0).long()
    hit_valid = sh.valid & alive

    last_valid = torch.where(alive, sh.valid, last_valid)
    last_t = torch.where(
        alive, torch.where(sh.valid, sh.t, torch.zeros_like(sh.t)), last_t)

    mrows = march_tab(tri) if callable(march_tab) else march_tab[:, tri]
    face_n = mrows[0:3].movedim(0, -1)
    is_refr = hit_valid & (mrows[3] > 0.5)
    ior = mrows[4]

    exiting = vecmath.dot(d, face_n) > 0.0
    n_eff = torch.where(exiting[..., None], -face_n, face_n)
    one = torch.ones_like(ior)
    new_d, ok = vecmath.refract(d, n_eff, torch.where(exiting, ior, one),
                                torch.where(exiting, one, ior))

    hit_point = o + d * sh.t[..., None]
    cont = is_refr & ok
    o = torch.where(cont[..., None], hit_point - n_eff * refraction_bias, o)
    d = torch.where(cont[..., None], new_d, d)
    return o, d, cont, last_valid, last_t


def _run_march(tracer, march_tab, refraction_bias, max_ray_depth, o, d,
               alive):
    """The bend-walk at any wavefront width -> (last_valid, last_t): the
    last hit of each lane, its distance along the last bent segment.  A
    step past the first runs only while some lane still marches (the
    marching set only shrinks), which is one device-to-host read each
    (``crt.host_reads.march.any``)."""
    carry = (o, d, alive, torch.zeros_like(alive),
             torch.zeros(alive.shape, dtype=torch.float32, device=o.device))
    carry = _march_step(tracer, march_tab, refraction_bias, carry)
    for _ in range(max_ray_depth):
        tracing.count("crt.host_reads.march.any")
        if not bool(carry[2].any()):
            break
        carry = _march_step(tracer, march_tab, refraction_bias, carry)
    return carry[3], carry[4]


def _transmissive_march(tracer, march_tab, refraction_bias, max_ray_depth,
                        shadow_o, d, act, narrow):
    """(last_valid, last_t) of the shadow lanes ``act`` ([N]).  ``narrow``
    gathers the 1024-lane blocks that hold a marching lane, walks those
    and scatters back: every survivor of a step is a lane of ``act``, and
    a block is a binning tile, so the narrow walk equals the full-width
    one bit for bit.  The gather's size is a host read
    (``crt.host_reads.march.blocks``)."""
    N = act.shape[0]
    if not narrow or N % _MARCH_BLOCK:
        return _run_march(tracer, march_tab, refraction_bias,
                          max_ray_depth, shadow_o, d, act)
    n_blk = N // _MARCH_BLOCK
    blk_live = act.reshape(n_blk, _MARCH_BLOCK).any(dim=1)
    tracing.count("crt.host_reads.march.blocks")
    idx = torch.nonzero(blk_live)[:, 0]  # sized by the data: a host read
    last_valid = torch.zeros((n_blk, _MARCH_BLOCK), dtype=torch.bool,
                             device=act.device)
    last_t = torch.zeros((n_blk, _MARCH_BLOCK), dtype=torch.float32,
                         device=act.device)
    if idx.numel():
        lv, lt = _run_march(
            tracer, march_tab, refraction_bias, max_ray_depth,
            shadow_o.reshape(n_blk, _MARCH_BLOCK, 3)[idx].reshape(-1, 3),
            d.reshape(n_blk, _MARCH_BLOCK, 3)[idx].reshape(-1, 3),
            act.reshape(n_blk, _MARCH_BLOCK)[idx].reshape(-1))
        last_valid[idx] = lv.reshape(-1, _MARCH_BLOCK)
        last_t[idx] = lt.reshape(-1, _MARCH_BLOCK)
    return last_valid.reshape(-1), last_t.reshape(-1)


def _occlusion_masks(scene, tracer, point, normal, light_positions,
                     shadow_bias, no_shadows, shadow_active,
                     max_ray_depth=3, refraction_bias=1e-2, march_tab=None):
    """is_illuminated per (light, ray), all lights in one batched pass.

    Returns (illuminated [Ll, R] bool, light_dir [Ll, R, 3], r2 [Ll, R]).
    The mask is a constant: every trace here sees detached inputs.

    Without live refraction, the mask is ``tracer.shadow``'s, the opaque
    shadow pass of the backend (``ops/tracer.py``).

    With it, shadow rays refract through glass and go on: each lane is
    re-traced after bending at a refractive hit, up to ``max_ray_depth``
    bends; total internal reflection or a non-refractive hit ends the
    walk, and the last hit's distance along the last segment is held
    against the original light distance.  Where ``tracer.shadow_glass``
    routes the lanes (one kernel pass), lanes whose whole ray meets no
    glass (and whose light is farther than 1) take its occlusion bits, the
    rest march, over the live 1024-lane blocks only.  Without
    ``march_tab``, the march reads its constants from
    ``march_table(scene, tracer.read_rows)``.
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
    point, shadow_o_px = point.detach(), shadow_o_px.detach()
    light_positions = light_positions.detach()

    if not (scene.has_refractive and scene.refractions_on):
        with tracing.span("crt.trace.shadow"):
            occluded = tracer.shadow(point, shadow_o_px, light_positions,
                                     light_dir.detach(), r2.detach(), act_lr,
                                     2.0 * shadow_bias)
        return ~occluded, light_dir, r2

    # the transmissive branch: the split pass and the bend-walk, with the
    # shadow lanes that enter it and those that walk, counted on the device
    shadow_o = shadow_o_px.expand(light_vec.shape).reshape(-1, 3)
    d = light_dir.detach().reshape(-1, 3)
    r2_flat = r2.detach().reshape(-1)
    with tracing.span("crt.shade.march"):
        tracing.count("crt.march.lanes", act_lr)
        act = act_lr.reshape(-1)
        occ_opaque = opaque_act = None
        res = None
        if _MARCH_SPLIT:
            with tracing.span("crt.trace"):
                res = tracer.shadow_glass(point, shadow_o_px,
                                          light_positions, act_lr,
                                          2.0 * shadow_bias)
        if res is not None:
            occ_opaque, glass = res
            # |w| < 1 is where the kernel's |n.w| parallel test is weaker
            # than the walk's |n.d|: those lanes march whatever the flag
            march_lr = act_lr & (glass | (r2.detach() <= 1.0))
            opaque_act = act_lr & ~march_lr
            act = march_lr.reshape(-1)
        tracing.count("crt.march.walk_lanes", act)

        if march_tab is None:
            march_tab = march_table(scene, tracer.read_rows)
        with torch.no_grad():
            last_valid, last_t = _transmissive_march(
                tracer, march_tab, refraction_bias, max_ray_depth,
                shadow_o, d, act,
                narrow=_MARCH_NARROW and occ_opaque is not None)
    occluded = (last_valid & (last_t * last_t <= r2_flat)).reshape(r2.shape)
    if occ_opaque is not None:
        # march verdicts on the glass-suspect lanes, kernel verdicts on the
        # rest, each masked to its own part
        occluded = occluded | (occ_opaque.reshape(r2.shape) & opaque_act)
    return ~occluded, light_dir, r2


def count_refraction(is_refractive, refr_ok) -> None:
    """Count the refractive hits that refract
    (``crt.shade.refracted_lanes``) and those that totally reflect
    (``crt.shade.tir_lanes``), on the device; nothing is computed while
    tracing is off."""
    if tracing.enabled():
        tracing.count("crt.shade.refracted_lanes", is_refractive & refr_ok)
        tracing.count("crt.shade.tir_lanes", is_refractive & ~refr_ok)


@tracing.spanned("crt.shade")
def shade_wavefront(scene, settings, tracer, origins, dirs,
                    active: Optional[torch.Tensor] = None, *,
                    raster_x: Optional[torch.Tensor] = None,
                    raster_y: Optional[torch.Tensor] = None,
                    gi_salt=None) -> torch.Tensor:
    """Shade a camera-ray wavefront -> [R, 3] linear colors, by the
    unrolled recursion.

    ``tracer`` is the intersection backend (``ops/tracer.py``).
    ``active=False`` lanes (chunk padding) produce arbitrary colors the
    caller discards; they are dropped from the trace binning.  A GI scene
    needs the rays' raster x / y (uint32 values) to seed each pixel's
    PCG32 stream; ``gi_salt`` (an int or an integer scalar tensor) forks
    the streams for a progressive pass, salt 0 bit for bit the unsalted
    render.  The tracer's ``read_rows``, where it has one, replaces the
    reads of the packed table (``hit_attributes``) and of the march's
    constants.
    """
    if active is None:
        active = torch.ones(origins.shape[:-1], dtype=torch.bool,
                            device=origins.device)
    rng = None
    if scene.gi_on:
        if raster_x is None or raster_y is None:
            raise ValueError("GI needs raster coordinates to seed the "
                             "per-pixel PCG32 streams")
        rng = rng_mod.salt_stream(
            rng_mod.make_pcg(raster_x.to(origins.device),
                             raster_y.to(origins.device)), gi_salt)
    march_tab = None
    if scene.has_materials and scene.has_refractive and scene.refractions_on:
        march_tab = march_table(scene, tracer.read_rows)
    return _shade_level(scene, settings, tracer, origins, dirs, 0, active,
                        march_tab, rng)[0]


def refraction_geometry(dirs, normal, ior, refraction_bias, point):
    """What a refractive hit needs, shared by both wavefronts: the normal
    flipped to face the incoming ray, the refracted direction with its
    total-internal-reflection flag, and the refracted ray's origin."""
    exiting = vecmath.dot(dirs, normal) > 0.0
    refr_normal = torch.where(exiting[..., None], -normal, normal)
    one = torch.ones_like(ior)
    refr_dir, refr_ok = vecmath.refract(
        dirs, refr_normal, torch.where(exiting, ior, one),
        torch.where(exiting, one, ior))
    refr_origin = point - refr_normal * refraction_bias
    return refr_normal, refr_dir, refr_ok, refr_origin


def fresnel_weight(dirs, refr_normal):
    """0.5 * (1 + d.n)^5 about the (possibly flipped) normal -> [R]."""
    return 0.5 * torch.pow(1.0 + vecmath.dot(dirs, refr_normal), 5.0)


def gi_basis(dirs, normal):
    """The local frame of a diffuse hit's hemisphere samples
    (crt_renderer.cpp:62-66): rows right = |d x n|, up = n, forward =
    right x up -> [..., 3, 3]."""
    right = vecmath.safe_normalize(vecmath.cross(dirs, normal))
    return vecmath.from_axes(right, normal, vecmath.cross(right, normal))


def gi_direction(rng, active, local_m):
    """One hemisphere sample in the frame ``local_m`` from two uniforms of
    ``rng`` (advanced where ``active``): (cos, sin, 0) of pi * u1, turned
    about y by 2 pi * u2, then into the frame -> (dir [..., 3], rng)."""
    u1, rng = rng_mod.uniform(rng, active)
    angle_xy = _PI * u1
    x, y = torch.cos(angle_xy), torch.sin(angle_xy)
    u2, rng = rng_mod.uniform(rng, active)
    angle_xz = (2.0 * _PI) * u2
    c, s = torch.cos(angle_xz), torch.sin(angle_xz)
    # (x, y, 0) times rotation_y, row-vector convention
    z = torch.zeros_like(x)
    d = torch.stack([x * c + z * s, y, -x * s + z * c], dim=-1)
    return vecmath.rotate_rows(d, local_m), rng


def _shade_level(scene, settings, tracer, origins, dirs, depth, active,
                 march_tab=None, rng=None):
    """One unrolled recursion level -> (color [R, 3], rng)."""
    R = origins.shape[:-1]
    black = torch.zeros(R + (3,), dtype=torch.float32, device=origins.device)
    if depth > settings.max_ray_depth:
        return black, rng

    kernel_rows = None
    with tracing.span("crt.trace.primary" if depth == 0 else "crt.trace"):
        if tracer.emits_rows and tracer.read_rows is None:
            hit, kernel_rows = tracer.with_rows(origins, dirs, active)
        else:
            hit = tracer(origins, dirs, active)
    attrs = hit_attributes(scene, origins, dirs, hit, kernel_rows=kernel_rows,
                           rank=tracer.rank, read_rows=tracer.read_rows)

    if not scene.has_materials:
        # 07-era material-less scenes: gray half-lambert on the face normal.
        tracing.count("crt.host_reads.era07_light")  # a copy to the card
        light_dir = torch.tensor(ERA07_LIGHT_DIR, dtype=torch.float32,
                                 device=origins.device)
        gray = 0.5 + 0.5 * vecmath.dot(attrs.normal, light_dir)
        legacy = gray[..., None].expand(R + (3,))
        return torch.where(attrs.valid[..., None], legacy,
                           scene.background_color), rng

    albedo = sample_textures(scene, attrs.albedo_tex, attrs.uv,
                             attrs.bary_u, attrs.bary_v,
                             live=attrs.valid)

    is_diffuse = attrs.valid & (attrs.mat_type == MATERIAL_DIFFUSE)
    is_reflective = attrs.valid & (attrs.mat_type == MATERIAL_REFLECTIVE)
    is_refractive = attrs.valid & (attrs.mat_type == MATERIAL_REFRACTIVE)
    is_constant = attrs.valid & (attrs.mat_type == MATERIAL_CONSTANT)
    normal = attrs.normal
    point = attrs.point

    # ---- refractive geometry first: it feeds the shared reflection batch
    want_refract = scene.has_refractive and scene.refractions_on
    if want_refract:
        refr_normal, refr_dir, refr_ok, refr_origin = refraction_geometry(
            dirs, normal, attrs.ior, settings.refraction_bias, point)
        count_refraction(active & is_refractive, refr_ok)

    # ---- shared reflection batch: reflective lanes reflect about the
    # shading normal, refractive lanes about the (possibly flipped) one
    want_reflect = scene.has_reflective and scene.reflections_on
    if (want_reflect or want_refract) and depth < settings.max_ray_depth + 1:
        n_eff = normal
        refl_active = torch.zeros_like(active)
        if want_reflect:
            refl_active = refl_active | is_reflective
        if want_refract:
            n_eff = torch.where(is_refractive[..., None], refr_normal, normal)
            refl_active = refl_active | is_refractive
        refl_dir = vecmath.reflect(dirs, n_eff)
        refl_origin = point + n_eff * settings.reflection_bias
        refl_color, rng = _shade_level(
            scene, settings, tracer, refl_origin, refl_dir, depth + 1,
            active & refl_active, march_tab, rng)
    else:
        refl_color = black

    if want_refract:
        refr_color, rng = _shade_level(
            scene, settings, tracer, refr_origin, refr_dir, depth + 1,
            active & is_refractive & refr_ok, march_tab, rng)

    # ---- diffuse: the GI samples in order, each child's subtree drawing
    # from the pixel's stream before the next sample's angles
    diffuse_color = black
    K = settings.diffuse_reflection_ray_count
    if scene.gi_on and K > 0:
        gi_active = active & is_diffuse
        local_m = gi_basis(dirs, normal)
        gi_origin = point + normal * settings.diffuse_reflection_bias
        for _ in range(K):
            gi_dir, rng = gi_direction(rng, gi_active, local_m)
            gi_color, rng = _shade_level(
                scene, settings, tracer, gi_origin, gi_dir, depth + 1,
                gi_active, march_tab, rng)
            diffuse_color = diffuse_color + gi_color
    if scene.num_lights > 0:
        illuminated, light_dir, r2 = _occlusion_masks(
            scene, tracer, point, normal, scene.light_position,
            settings.shadow_bias, settings.no_shadows,
            shadow_active=active & is_diffuse,
            max_ray_depth=settings.max_ray_depth,
            refraction_bias=settings.refraction_bias, march_tab=march_tab,
        )  # [Ll, R](, 3)
        diffuse_color = diffuse_color + albedo * light_sum(
            scene, illuminated, light_dir, r2, normal)[..., None]

    if settings.gi_divide or scene.gi_on:
        diffuse_color = diffuse_color / (K + 1)

    # ---- reflective
    if want_reflect:
        reflective_color = _hadamard(albedo, refl_color, settings.hadamard_y)
    else:
        reflective_color = albedo  # reflections off

    # ---- refractive
    if want_refract:
        fresnel = fresnel_weight(dirs, refr_normal)[..., None]
        blended = refl_color * fresnel + refr_color * (1.0 - fresnel)
        # total internal reflection: all weight on the reflection
        refractive_color = torch.where(refr_ok[..., None], blended,
                                       refl_color)
    else:
        refractive_color = black  # refractions off

    color = torch.where(is_diffuse[..., None], diffuse_color,
                        scene.background_color)
    if scene.has_reflective:
        color = torch.where(is_reflective[..., None], reflective_color, color)
    if scene.has_refractive:
        color = torch.where(is_refractive[..., None], refractive_color, color)
    if scene.has_constant:
        color = torch.where(is_constant[..., None], albedo, color)
    return color, rng

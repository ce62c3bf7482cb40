"""Iterative bank-structured Whitted wavefront.

Counterpart of ``crt_tpu/ops/shade_iter.py``.  The recursive wavefront of
``ops/shade.py`` unrolls the call tree: a refractive scene traces
2^depth wavefronts.  Here the tree becomes a depth-bounded iteration over
a pool of B banks of R lanes, where slot (b, p) always belongs to pixel p:

  - path radiance accumulates elementwise into a [B, R, 3] buffer and the
    image is one sum over the banks, with no scatter-add;
  - spawned children (the refractive Fresnel pair's reflection ray, the K
    diffuse-GI samples) only move along the small bank axis: a child takes
    the lowest free bank of its own column, matched by a cumulative count
    over [B, B, R];
  - every bank keeps the renderer's pixel-tile ray order, so the trace
    binning sees the same coherent 32x32 blocks as the primary pass.

A lane carries its throughput (the product of per-bounce factors: the
albedo of a mirror, fresnel and 1 - fresnel of the refractive pair,
1 / (K + 1) a GI sample), so the tree's bottom-up blend becomes a sum over
root-to-leaf paths: the same radiance up to the order of f32 additions.

Two schedules (``RenderSettings.wavefront_sched``): "scan" carries all B
banks through D + 1 identical bounces; "grow" lets the pool grow 1 -> 2 ->
4 -> B banks, folds the depth-D leaf children in without placing them and
ends on a spawn-free bounce, so dead banks are never traced.  "auto" is
grow under GI, whose cost follows the pool's width, and scan otherwise
(crt_tpu's choice).

Children that find no free bank in their column are dropped and counted.
A GI scene gets the tree's exact width f^D banks (f = max(K, 2 with live
refraction)), which drops none; other scenes 2^min(D, 3), which drops
none at depth <= 3.

GI streams.  A GI parent draws its 2K angles from its lane's PCG32 stream
in order, with masked advancement; each child takes a forked stream
(``rng.derive(parent, k + 1)``, the Fresnel reflection ``derive(parent,
97)``), since the reference's depth-first draw order cannot be kept
breadth-first: a child's stream position would depend on its siblings'
subtree sizes.  Deterministic, and the same distribution as the recursive
wavefront (``ops/shade.py``), which keeps the reference's order.

Live lanes.  Past the camera rays the pool is mostly dead (a GI ray
that escapes to the background ends its lane, and the grow schedule's
leaf banks hold few rays).  Each later bounce takes one ``nonzero`` of
its flat pool's ``act`` (its one host read); when at most
``_COMPACT_MAX_LIVE`` of the lanes are live, every per-lane step runs on
the gathered live lanes, padded to a multiple of ``TILE_RAYS`` with the
pool's first dead lanes: the trace, the hit attributes, textures,
shadows and lights, the continuation, the refraction geometry, the GI
frame, draws and forked streams, and the leaf children's shading.
``index_copy`` on the distinct gathered lanes puts the radiance, the
continuation, the rng state and each child's candidate fields back at
full width; a lane outside the set is dead, and the full-width bounce
leaves such a lane as it was.  Child placement, the grow pads and the
final sum over banks stay full-width: they work along columns.
``nonzero`` keeps lane order, so the 1,024-lane blocks stay as coherent
as the live rays allow.  So the gathered bounce is the full-width one
restricted to a subset of its lanes, and the image is the full-width one
bit for bit: every step is per lane, and a ray's closest hit does not
depend on the rays that share its tile (a tie in t goes to the first
cluster walked, and every tile walks its list in cluster order).  The
padding is the pool's own lanes and not made-up rays because a dead
lane's zero cotangent still meets the derivatives of its own math: a
made-up ray parallel to the triangle its dead lane reads (the floor)
gives ``refract`` a square root at 0, and 0 x inf is a NaN in the
gradient.  A denser pool, and the camera rays, take the full-width
path.

A scene-partitioned render (``parallel/scene_sharded.py``) passes a
tracer with ``read_rows``, which replaces the reads of the packed table
and of the march's constants.  Every rank holds the same all-reduced hits, so every
rank gathers the same live lanes and the row exchange keeps equal
lengths.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from crt_tpu_torch.ops import rng as rng_mod
from crt_tpu_torch.ops import vecmath
from crt_tpu_torch.ops.cluster_tables import TILE_RAYS
from crt_tpu_torch.ops.shade import (
    _occlusion_masks,
    count_refraction,
    fresnel_weight,
    gi_basis,
    gi_direction,
    hit_attributes,
    light_sum,
    march_table,
    refraction_geometry,
)
from crt_tpu_torch.ops.texture import sample_textures
from crt_tpu_torch.scene.types import (
    MATERIAL_CONSTANT,
    MATERIAL_DIFFUSE,
    MATERIAL_REFLECTIVE,
    MATERIAL_REFRACTIVE,
)
from crt_tpu_torch.utils import trace as tracing


def default_banks(scene, settings) -> int:
    """Pool bank count: ``wavefront_banks`` when set; under GI the exact
    tree width f^D (f = max(K, 2 with live refraction)), under which a
    parent at bounce b lies below bank f^(b+1) and no child is dropped;
    else 2^min(D, 3) for a scene with live refraction (beyond depth 3 the
    Fresnel tree is starved of weight and the few drops are below noise)
    and 2 without."""
    if settings.wavefront_banks:
        return int(settings.wavefront_banks)
    if scene.gi_on:
        f = 2 if (scene.has_refractive and scene.refractions_on) else 1
        f = max(f, settings.diffuse_reflection_ray_count)
        return max(2, f ** settings.max_ray_depth)
    banks = 2 ** min(settings.max_ray_depth, 3)
    if not (scene.has_refractive and scene.refractions_on):
        banks = min(banks, 2)
    return max(banks, 2)


def _grow_factor(scene, settings) -> int:
    """Slots one bounce leaves per parent lane in its column: the Fresnel
    pair (the continuation and one child), a GI parent's K children (the
    parent dies), else 1."""
    f = 2 if (scene.has_refractive and scene.refractions_on) else 1
    K = settings.diffuse_reflection_ray_count
    if scene.gi_on and K > 1:
        f = max(f, K)
    return f


def _grows(scene, settings) -> bool:
    """Whether the pool takes the grow schedule ("auto": under GI)."""
    sched = settings.wavefront_sched
    return sched == "grow" or (sched == "auto" and scene.gi_on)


def pool_width(scene, settings) -> int:
    """The most banks the pool holds at once: grow_f^(D - 1) capped by the
    bank count under grow (the leaves are shaded inline and the last bounce
    spawns nothing), the bank count under scan."""
    B = default_banks(scene, settings)
    if not _grows(scene, settings):
        return B
    return min(B, _grow_factor(scene, settings)
               ** max(settings.max_ray_depth - 1, 0))


class _Pool(NamedTuple):
    """The ray pool carried from bounce to bounce; leading dims [B, R]."""

    o: torch.Tensor  # [B, R, 3] origins
    d: torch.Tensor  # [B, R, 3] directions
    w: torch.Tensor  # [B, R, 3] path throughput
    act: torch.Tensor  # [B, R] bool
    acc: torch.Tensor  # [B, R, 3] accumulated radiance
    rng: Optional[rng_mod.PCGState]  # [B, R] planes; None without GI
    dropped: torch.Tensor  # [] i32 children lost to pool overflow


def _place_children(pool_fields, dead, cand_act, cand_fields, dropped):
    """Place per-lane spawned children into free banks of their own column.

    ``dead`` [Bj, R]: free slots.  ``cand_act`` [Bi, R]: parent lanes
    (bank i, column p) that spawn one child each into column p.  Children
    fill the free slots in bank order; children beyond the free slots are
    dropped and counted.  Bi and Bj may differ (the pool may have grown
    between shading and placement).

    Returns (new_fields, new_dead, placed [Bj, R], dropped).
    """
    dead_rank = torch.cumsum(dead.to(torch.int32), dim=0) - 1  # [Bj, R]
    spawn_rank = torch.cumsum(cand_act.to(torch.int32), dim=0) - 1  # [Bi, R]
    # match[i, j, p]: the child of bank i lands in free bank j of column p
    match = (cand_act[:, None, :] & dead[None, :, :]
             & (spawn_rank[:, None, :] == dead_rank[None, :, :]))
    has_src = match.any(dim=0)  # [Bj, R] the slot receives a child
    placed = has_src.sum(dtype=torch.int32)
    spawned = cand_act.sum(dtype=torch.int32)
    dropped = dropped + (spawned - placed)

    # at most one source bank matches a slot: gather it (an exact copy)
    src = match.to(torch.uint8).argmax(dim=0)  # [Bj, R]
    out = []
    for old, cand in zip(pool_fields, cand_fields):
        if old.dim() == 3:  # [B, R, 3] vectors; else [B, R] rng planes
            g = torch.gather(cand, 0, src[..., None].expand(src.shape + (3,)))
            out.append(torch.where(has_src[..., None], g, old))
        else:
            out.append(torch.where(has_src, torch.gather(cand, 0, src), old))
    return out, dead & ~has_src, has_src, dropped


# A bounce past the primary one shades only the live lanes of its flat
# pool while they are at most this share of it; a denser pool (and the
# camera rays) goes full-width.  Gathering a mostly live pool saves
# little work and holds the gathered copy beside the pool: on the 1080p
# GI frame (K 4, depth 3) on an H100, gathering also its one mostly live
# bounce (4.2 M lanes, 89 % live) took the same frame time and raised
# the peak from 4.46 to 4.68 GiB.
_COMPACT_MAX_LIVE = 0.5


def _live_lanes(act):
    """The lanes a bounce shades -> [C] int64, or None for all of them.

    The live lanes of the flat pool ``act`` in lane order, then its first
    dead lanes (found on the device) up to a multiple of ``TILE_RAYS``,
    one tile at least.  None when more than ``_COMPACT_MAX_LIVE`` of the
    lanes are live, or too few are dead to pad.  The ``nonzero`` waits
    for the device: the bounce's one host read."""
    tracing.count("crt.host_reads.shade_compact")
    live = torch.nonzero(act).reshape(-1)
    n, total = live.numel(), act.numel()
    lanes = max(1, -(-n // TILE_RAYS)) * TILE_RAYS
    if n > _COMPACT_MAX_LIVE * total or lanes > total:
        return None
    if lanes == n:
        return live
    dead_rank = torch.cumsum(~act, 0)  # k at the k-th dead lane and after
    want = torch.arange(1, lanes - n + 1, device=act.device)
    return torch.cat([live, torch.searchsorted(dead_rank, want)])


def shade_wavefront_iter(scene, settings, tracer, origins, dirs,
                         active: Optional[torch.Tensor] = None,
                         banks: Optional[int] = None, *,
                         raster_x: Optional[torch.Tensor] = None,
                         raster_y: Optional[torch.Tensor] = None,
                         gi_salt=None) -> torch.Tensor:
    """Shade a camera wavefront iteratively -> [R, 3] linear colors.  A GI
    scene needs the rays' raster x / y (uint32 values) to seed each pixel's
    PCG32 stream; ``gi_salt`` forks the streams for a progressive pass
    (salt 0: the unsalted render, bit for bit).  ``tracer`` is the
    intersection backend (``ops/tracer.py``)."""
    color, _ = shade_wavefront_iter_with_stats(
        scene, settings, tracer, origins, dirs, active, banks,
        raster_x=raster_x, raster_y=raster_y, gi_salt=gi_salt)
    return color


@tracing.spanned("crt.shade")
def shade_wavefront_iter_with_stats(scene, settings, tracer, origins, dirs,
                                    active=None, banks=None, *,
                                    raster_x=None, raster_y=None,
                                    gi_salt=None):
    """Like ``shade_wavefront_iter``, and the count of dropped children."""
    R = origins.shape[0]
    dev = origins.device
    B = int(banks) if banks else default_banks(scene, settings)
    D = settings.max_ray_depth
    if active is None:
        active = torch.ones((R,), dtype=torch.bool, device=dev)
    seed = None
    if scene.gi_on:
        if raster_x is None or raster_y is None:
            raise ValueError("GI needs raster coordinates to seed the "
                             "per-pixel PCG32 streams")
        seed = rng_mod.salt_stream(
            rng_mod.make_pcg(raster_x.to(dev), raster_y.to(dev)), gi_salt)

    want_refract = scene.has_refractive and scene.refractions_on
    want_reflect = scene.has_reflective and scene.reflections_on
    K = settings.diffuse_reflection_ray_count
    gi_scale = 1.0 / (K + 1) if (scene.gi_on or settings.gi_divide) else 1.0
    # The packer fills the lowest free banks first, so after bounce b every
    # occupied bank index is below min(B, grow_f^(b+1)).
    grow_f = _grow_factor(scene, settings)
    march_tab = (march_table(scene, tracer.read_rows) if want_refract
                 else None)

    def shade_local(o, d, act, primary=False):
        """Trace and the local (terminal) radiance of a flat wavefront:
        what a ray at the depth limit contributes.  Background on a miss,
        the albedo of a constant material (and of a mirror when
        reflections are off), direct light on diffuse; mirrors and glass
        otherwise add nothing here (their children would).  ``primary``:
        the wavefront is the camera rays'.

        Returns (contrib [C, 3], attrs, albedo, masks)."""
        tracing.count("crt.shade.lanes", act.numel())
        tracing.count("crt.shade.live_lanes", act)
        with tracing.span("crt.trace.primary" if primary else "crt.trace"):
            hit = tracer(o, d, act)
        attrs = hit_attributes(scene, o, d, hit, rank=tracer.rank,
                               read_rows=tracer.read_rows)
        valid = attrs.valid & act
        miss = act & ~attrs.valid

        albedo = sample_textures(scene, attrs.albedo_tex, attrs.uv,
                                 attrs.bary_u, attrs.bary_v,
                                 live=attrs.valid)
        is_diffuse = valid & (attrs.mat_type == MATERIAL_DIFFUSE)
        is_reflective = valid & (attrs.mat_type == MATERIAL_REFLECTIVE)
        is_refractive = valid & (attrs.mat_type == MATERIAL_REFRACTIVE)
        is_constant = valid & (attrs.mat_type == MATERIAL_CONSTANT)

        contrib = torch.where(miss[..., None], scene.background_color,
                              torch.zeros((), device=dev))
        if scene.has_constant:
            contrib = torch.where(is_constant[..., None], albedo, contrib)
        if scene.has_reflective and not scene.reflections_on:
            contrib = torch.where(is_reflective[..., None], albedo, contrib)

        if scene.num_lights > 0:
            illuminated, light_dir, r2 = _occlusion_masks(
                scene, tracer, attrs.point, attrs.normal,
                scene.light_position, settings.shadow_bias,
                settings.no_shadows, shadow_active=is_diffuse,
                max_ray_depth=settings.max_ray_depth,
                refraction_bias=settings.refraction_bias,
                march_tab=march_tab,
            )
            lum = light_sum(scene, illuminated, light_dir, r2, attrs.normal)
            direct = albedo * lum[..., None]
            contrib = torch.where(is_diffuse[..., None], direct * gi_scale,
                                  contrib)
        return contrib, attrs, albedo, (is_diffuse, is_reflective,
                                        is_refractive)

    def bounce(pool, grow_to=None, last=False, leaf_children=False,
               primary=False):
        """One wavefront bounce.

        ``grow_to``: pad the pool to this many banks between shading and
        child placement.  ``last``: the terminal bounce; every child would
        shade beyond the depth limit, so only local radiance accumulates.
        ``leaf_children``: this bounce's children are leaves (depth ==
        max_ray_depth): their radiance is folded in by one masked trace
        and local shade each instead of placing them, so the pool never
        holds the widest tree level and starvation cannot drop them.
        ``primary``: the pool holds the camera rays.

        Every per-lane step runs on the bounce's lanes: the live ones of
        the flat pool (``_live_lanes``), or all of them.  ``widen`` puts a
        per-lane result back at full width, over ``into`` (the pool's own
        field: a lane outside the set keeps its value) or over zeros.
        """
        Bc = pool.o.shape[0]

        def flat(x):
            return x.reshape((Bc * R,) + x.shape[2:])

        def unflat(x):
            return x.reshape((Bc, R) + x.shape[1:])

        o_all, d_all, w_all = flat(pool.o), flat(pool.d), flat(pool.w)
        act_all, acc_all = flat(pool.act), flat(pool.acc)
        rng_all = (None if pool.rng is None
                   else rng_mod.PCGState(*(flat(p) for p in pool.rng)))
        tracing.count("crt.shade.bounces")
        idx = None if primary else _live_lanes(act_all)
        if idx is None:
            o, d, w, act, acc = o_all, d_all, w_all, act_all, acc_all
            rng = rng_all

            def widen(x, into=None):
                return x
        else:
            tracing.count("crt.shade.compacted_bounces")
            o, d, w, act, acc = (x.index_select(0, idx) for x in
                                 (o_all, d_all, w_all, act_all, acc_all))
            rng = (None if rng_all is None else rng_mod.PCGState(
                *(p.index_select(0, idx) for p in rng_all)))

            def widen(x, into=None):
                if into is None:
                    into = x.new_zeros((Bc * R,) + x.shape[1:])
                    return into.index_copy_(0, idx, x)
                return into.index_copy(0, idx, x)

        contrib, attrs, albedo, masks = shade_local(o, d, act, primary)
        is_diffuse, is_reflective, is_refractive = masks
        normal, point = attrs.normal, attrs.point
        acc = acc + w * contrib
        if last:
            return pool._replace(act=torch.zeros_like(pool.act),
                                 acc=unflat(widen(acc, acc_all)))

        # ---- refractive geometry (feeds both children)
        if want_refract:
            refr_normal, refr_dir, refr_ok, refr_origin = refraction_geometry(
                d, normal, attrs.ior, settings.refraction_bias, point)
            count_refraction(is_refractive, refr_ok)
            fresnel = fresnel_weight(d, refr_normal)[..., None]
            refl_r_dir = vecmath.reflect(d, refr_normal)
            refl_r_origin = point + refr_normal * settings.reflection_bias

        # ---- continuation in place: a mirror lane goes on as its mirror
        # ray with weight * albedo, a glass lane as its refracted ray with
        # weight * (1 - fresnel), or on total internal reflection as the
        # reflection with its full weight
        new_o, new_d, new_w = o, d, w
        cont = torch.zeros_like(act)
        if want_reflect:
            albedo_eff = albedo
            if settings.hadamard_y:
                # (a (*) c) with the y typo == a' * c with a'.y = a.y^2
                albedo_eff = torch.cat(
                    [albedo[..., 0:1], albedo[..., 1:2] * albedo[..., 1:2],
                     albedo[..., 2:3]], dim=-1)
            m = is_reflective[..., None]
            new_o = torch.where(
                m, point + normal * settings.reflection_bias, new_o)
            new_d = torch.where(m, vecmath.reflect(d, normal), new_d)
            new_w = torch.where(m, w * albedo_eff, new_w)
            cont = cont | is_reflective
        if want_refract:
            m = (is_refractive & refr_ok)[..., None]
            new_o = torch.where(m, refr_origin, new_o)
            new_d = torch.where(m, refr_dir, new_d)
            new_w = torch.where(m, w * (1.0 - fresnel), new_w)
            m = (is_refractive & ~refr_ok)[..., None]
            new_o = torch.where(m, refl_r_origin, new_o)
            new_d = torch.where(m, refl_r_dir, new_d)
            cont = cont | is_refractive

        # ---- the GI samples' directions and forked streams, before any
        # placement: the parent's stream after its draws is the pool's,
        # and a child placed over a dying parent's slot brings its own
        gi_children = []
        if scene.gi_on and K > 0:
            local_m = gi_basis(d, normal)
            gi_origin = point + normal * settings.diffuse_reflection_bias
            for k in range(K):
                gi_dir, rng = gi_direction(rng, is_diffuse, local_m)
                gi_children.append((gi_dir, rng_mod.derive(rng, k + 1)))
        rng_out = None
        if rng_all is not None:
            rng_out = rng_mod.PCGState(
                unflat(widen(rng.state, rng_all.state)), unflat(rng_all.inc))

        if leaf_children:
            leaf = torch.zeros_like(w)
            if want_refract:
                c = shade_local(refl_r_origin, refl_r_dir,
                                is_refractive & refr_ok)[0]
                leaf = leaf + (w * fresnel) * c
            for gi_dir, _ in gi_children:
                c = shade_local(gi_origin, gi_dir, is_diffuse)[0]
                leaf = leaf + (w * gi_scale) * c
            return _Pool(o=unflat(widen(new_o, o_all)),
                         d=unflat(widen(new_d, d_all)),
                         w=unflat(widen(new_w, w_all)),
                         act=unflat(widen(cont)),
                         acc=unflat(widen(acc + leaf, acc_all)), rng=rng_out,
                         dropped=pool.dropped)

        pool_fields = [unflat(widen(new_o, o_all)),
                       unflat(widen(new_d, d_all)),
                       unflat(widen(new_w, w_all))]
        if rng_out is not None:
            pool_fields += list(rng_out)
        act2 = unflat(widen(cont))
        dead = ~act2
        dropped = pool.dropped
        acc_out = unflat(widen(acc, acc_all))

        if grow_to is not None and grow_to > Bc:
            # fresh dead banks for this bounce's children; their values
            # are never consumed, d gets a unit vector to stay finite
            pad = grow_to - Bc

            def padb(x, fill):
                p = torch.full((pad,) + x.shape[1:], fill, dtype=x.dtype,
                               device=dev)
                return torch.cat([x, p], dim=0)

            pool_fields[0] = padb(pool_fields[0], 0.0)
            tracing.count("crt.host_reads.pool_pad")  # a copy to the card
            d_pad = torch.tensor([0.0, 0.0, -1.0], device=dev).expand(
                pad, R, 3)
            pool_fields[1] = torch.cat([pool_fields[1], d_pad], dim=0)
            pool_fields[2] = padb(pool_fields[2], 0.0)
            for j in range(3, len(pool_fields)):  # the rng planes
                pool_fields[j] = padb(pool_fields[j], 0)
            dead = padb(dead, True)
            act2 = padb(act2, False)
            acc_out = padb(acc_out, 0.0)

        def spawn(cand_act, cand, pool_fields, dead, act2, dropped):
            """Place the children of ``cand_act``; ``cand``: their fields
            at full width, flat."""
            pool_fields, dead, placed, dropped = _place_children(
                pool_fields, dead, unflat(cand_act),
                [unflat(c) for c in cand], dropped)
            return pool_fields, dead, act2 | placed, dropped

        if want_refract:
            # the Fresnel pair's reflection ray, weight * fresnel, on a
            # forked stream so the two subtrees' GI draws decorrelate
            cand = [refl_r_origin, refl_r_dir, w * fresnel]
            if rng is not None:
                cand += list(rng_mod.derive(rng, 97))
            pool_fields, dead, act2, dropped = spawn(
                widen(is_refractive & refr_ok), [widen(c) for c in cand],
                pool_fields, dead, act2, dropped)
        if gi_children:
            gi_act = widen(is_diffuse)
            gi_o, gi_w = widen(gi_origin), widen(w * gi_scale)
        for gi_dir, child_rng in gi_children:
            pool_fields, dead, act2, dropped = spawn(
                gi_act, [gi_o, widen(gi_dir), gi_w,
                         *(widen(p) for p in child_rng)],
                pool_fields, dead, act2, dropped)

        return _Pool(o=pool_fields[0], d=pool_fields[1], w=pool_fields[2],
                     act=act2, acc=acc_out,
                     rng=(rng_mod.PCGState(*pool_fields[3:5])
                          if rng_out is not None else None),
                     dropped=dropped)

    def step(pool, **kw):
        """A bounce; under ``remat_shading`` its intermediates are not
        kept for the backward but recomputed there (the traces too), so a
        backward holds the pool of every bounce and one bounce's graph."""
        if not (settings.remat_shading and torch.is_grad_enabled()):
            return bounce(pool, **kw)
        return _Pool(*checkpoint(
            lambda *fields: tuple(bounce(_Pool(*fields), **kw)), *pool,
            use_reentrant=False))

    def init_pool(nbanks):
        act = torch.zeros((nbanks, R), dtype=torch.bool, device=dev)
        act[0] = active
        rng = None
        if seed is not None:
            rng = rng_mod.PCGState(*(p[None].expand(nbanks, R).contiguous()
                                     for p in seed))
        return _Pool(
            o=origins[None].expand(nbanks, R, 3),
            d=dirs[None].expand(nbanks, R, 3),
            w=torch.ones((nbanks, R, 3), dtype=torch.float32, device=dev),
            act=act,
            acc=torch.zeros((nbanks, R, 3), dtype=torch.float32, device=dev),
            rng=rng,
            dropped=torch.zeros((), dtype=torch.int32, device=dev),
        )

    if _grows(scene, settings):
        pool = init_pool(1)
        width = 1
        for b in range(D + 1):
            is_last = b == D
            leaf = b == D - 1  # this bounce's children are depth-D leaves
            g = width if (is_last or leaf) else min(B, width * grow_f)
            with tracing.span(f"crt.shade.bounce.{b}"):
                pool = step(pool, grow_to=g, last=is_last,
                            leaf_children=leaf, primary=b == 0)
            width = max(width, g)
    else:
        pool = init_pool(B)
        for b in range(D + 1):
            with tracing.span(f"crt.shade.bounce.{b}"):
                pool = step(pool, primary=b == 0)

    acc = pool.acc[0]
    for b in range(1, pool.acc.shape[0]):
        acc = acc + pool.acc[b]
    return acc, pool.dropped

#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (crt_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile | --large]

Phases, each printing what it found; any failure raises (exit code != 0):

  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: nvcc builds the kernels in crt_tpu_torch/csrc (or reuses the
     build); build seconds, cache hit, ptxas register / spill report;
  3. kernels vs their plain PyTorch versions on the card, at the shapes of
     the forward benchmark frame (make_test_scene(1920, 1080, 64)): the
     closest-hit kernel on the primary and on a masked mirror-bounce
     wavefront (tri, t and rows bit-equal), the w-occlusion kernel on the
     depth-0 shadow wavefront (masks equal); CUDA-event times, median of
     5 after 2 warm-ups; then the segment-sum kernel (the backward of the
     packed-row read) on the depth-0 cotangents of a real backward of that
     frame (T = 66) and on the big scene's primary wavefront (T = 65,536,
     seeded cotangents), vs its plain version, vs an fp64 sum of the same
     terms and vs itself (two launches), with index_add_ timed beside it;
  4. scale: make_big_scene(65536) at 1920x1080 (4096 clusters): the
     closest-hit kernel vs its plain version on 16 sampled tiles (bit-equal)
     and vs the all-pairs backend on 8192 sampled rays; then the closest
     hit (K1), the w-occlusion (K2), the segment sum (K3) and the
     live-tile compacted closest hit (K4) at the shapes of their redesign,
     each line tagged with the phase its inputs come from ([kernels]: the
     opaque primary, the masked mirror bounce (K1 and K4), the capped
     depth-0 shadow wavefront, the depth-0 cotangents of the packed rows
     and of the texture colours recorded from a real fit_scene backward;
     [glass]: the bounce-1 pool's trace (K1 and K4) and glass-flag pass
     recorded from a real frame, the uncapped member-masked pass, the
     segment sums of a real glass backward over the packed rows of the
     pool and over the ior row; [scale]:
     the 65,536-triangle primary, the segment sum over its wide id band,
     and its capped depth-0 shadow wavefront): K1, K2 and K4 bit-equal to
     the plain version on every lane (on 16 seeded tiles at 65,536
     triangles), K4 also to K1 and its live-tile list to the plain one, K3
     within its tolerances of fp64 and of the plain version; list lengths,
     the kernel's time (10 launches back to back between CUDA events,
     median of 5 after 2 warm-ups; for K3 and K4 also a single launch and
     the device time a profiler reads, which leaves the wrapper's host
     time out), the time of the same launch with every count zeroed (every
     tile dead: the fixed cost of the tiles and the output stores), for K1
     with rows the time at kp = 0 (the rows epilogue), for K2 the member
     tests a walk without any exit would do beside those the answer needs,
     for K4 K1's times on the same lists and its tile list's device time,
     for K3 the device time with every id -1, the bound and the no-FMA
     floor;
  5. main path: the CLI renders the benchmark scene from a .crtscene file
     (launch counts reset just before, read just after: 4 and 4 expected);
     render_image on the card vs the all-pairs backend and vs the CPU
     render of a small scene; forward frame time and Mrays/s (median of 5);
  6. train: value_and_grad of render_image(scene).sum() with respect to
     vertices, light intensities and camera position on the benchmark
     scene (launch counts reset just before, read just after: 4, 4 and 4
     expected); the gradients vs the all-pairs backend's on the card and,
     on a small scene, vs the CPU's; forward+backward time, Mrays/s and
     peak memory; then three Adam steps of fit_scene on the same frame
     from perturbed texture colours, light intensities and vertices (the
     loss must fall at every step);
  7. variants: on the forward benchmark frame's primary and masked
     mirror-bounce wavefronts (2,040 tiles) the tile-merged closest hit
     (K7) at merge 2 and 4 vs its plain version and vs the closest-hit
     kernel (K1), bit for bit, K1 and K7 timed in turns with the bound;
     then the CLI frame, in process with the defaults (4 K1 launches) and
     in a child process with CRT_TILE_MERGE=2 (4 K7 and no K1 launches):
     the two PPMs equal byte for byte, and in process the float image with
     the merge equals the default one;
  8. glass kernels: on the depth-0 shadow wavefront of the refractive
     benchmark scene (make_test_scene(1920, 1080, 64,
     with_refractive=True)) the w-occlusion kernel in its glass-flag mode
     (both outputs) and in its uncapped member-masked mode vs the plain
     version, lane for lane; then, on the inputs recorded from a real
     frame, the glass-flag mode again on the second bounce's pool shadow
     wavefront (8 banks under 2 lights, 32,640 tiles: the shape the frame
     launches it at, and the one its time and bound are taken at), on that
     bounce's pool trace (active-masked) the live-tile compacted closest
     hit vs its plain version and vs the closest-hit kernel on the same
     lists (timed as a single launch, 10 back to back and by the profiler,
     beside the closest-hit kernel), and the closest-hit kernel vs its own
     plain version there and on the widest segment of the bend-walk (all
     bit-equal);
  9. refract: the CLI renders the refractive scene from a .crtscene file
     (launch counts reset just before, read just after, and held to what
     the schedule implies: one pool trace and one glass-flag pass per
     bounce, one closest hit per march segment, no capped pass, no
     compacted launch); the image vs the all-pairs backend and, on a small
     scene, vs the CPU; compact_bounces=True bit-equal with every trace a
     compacted launch (each with one launch of its live-list kernel); the
     router's flag vs the separate uncapped gate
     through the trace factory; frame times of the scan and grow schedules,
     of scan with compact_bounces, of the recursive tree and of scan in 8
     chunks, host syncs, device time and launches of a profiled frame,
     peak memory; then value_and_grad of the
     image sum with respect to vertices, light intensities, camera
     position and mat_ior (vs the all-pairs backend's, time and peak
     memory, with and without remat_shading; per bounce one segment sum
     for the packed rows and one for the ior row), and the backward of
     the mat_ior[tri_material] gather at 65,536 triangles on one material,
     through packed_gather as build_packed reads it and by plain indexing;
 10. occlusion-d: on the opaque bench frame's depth-0 shadow wavefront the
     direction-form occlusion kernel in its two launches, K5 (shaft lists,
     origin tiles stored once) and K6 (generic lists, seeded with the
     inactive lanes), vs the plain version lane for lane, K5 == K6 on the
     active lanes, the lanes on which K5 and the w-occlusion kernel differ
     (|n.d| against |n.w| in the parallel test), times and bounds;
 11. stream-kernels: make_big_scene(1,000,000) at 1920x1080 (62,500
     clusters in 1,954 superclusters): the streaming closest hit (K8) on
     the primary wavefront and the streaming any-hit (K9) on the depth-0
     shadow wavefront, in one phase and in both phases of the two-phase
     resolve (the inputs of its two launches recorded from
     occluded_stream_twophase), each timed with its bound from that
     launch's own pairs and members, and held bit-equal to its plain
     version on 32 seeded tiles that own pairs (the plain version walks
     one list position at a time to a chunk's longest list: tens of
     seconds over every tile at this size; the kernel's launch on those 32
     tiles must also repeat its full launch there), each also with its
     walks cut into items of 8 live members, bit-equal to the default
     item length on every lane, with the no-FMA floor beside the bound and
     the time on the 32 tiles beside the full launch's, and K8 and phase
     2 timed at item lengths 16 to 512; the same launches (the primary
     and the three shadow launches) in the lane and rows table layouts
     (K10, K11), each equal to the fused launch on every lane, with 8
     members an item to the default, and to its plain version on the same
     32 tiles, with times beside the fused ones and the same bounds; K8 vs
     the all-pairs backend on 8192 sampled rays; two-phase == single phase
     on the active lanes; at 65,536 triangles streaming hits == the closest-hit
     kernel's on every lane and K9 == K5 on every active shadow lane;
 12. big, the large-scene main path: render_image of the 1,000,000-triangle
     frame with default settings (launch counts reset just before, read
     just after: one K8, two K9, no cluster-backend kernel, so "auto" took
     the streaming backend); a second forward frame bit-identical to the
     first; the frame vs the all-pairs backend on 8192 sampled pixels;
     render_image(backend="bruteforce") of the same scene at 64x36 (its
     ray chunk sized from T) vs the streaming frame; forward frame time
     and Mrays/s (host clock around a synchronize, median of 5), device
     time and launches of a profiled
     frame, the streaming kernels' and Phase A's share, pairs, host reads,
     peak memory; value_and_grad of the frame's sum (finite, time, peak,
     segment-sum launches); both backends timed on make_big_scene at
     16,384, 65,536, 262,144 and 1,000,000 triangles (what sets
     renderer.AUTO_STREAM_MIN_CLUSTERS) and, at 65,536, their images on
     every pixel and their gradients held together;
 13. layouts: render_image of the 1,000,000-triangle frame with
     CRT_STREAM_LAYOUT=fused, lane and rows (launch counts reset just
     before, read just after: one closest hit and two any-hit launches, all
     of the layout's kernels); the lane and rows frames equal the fused one
     bit for bit; frame times in turns (median of 5, host clock around a
     synchronize);
 14. direction-form: the opaque bench frame through the CLI in a child
     process with CRT_APEX_W=0 (4 K5 launches, no w-form pass) and with
     --backend pallas_stream (4 K8 + 8 K9): the two PPMs equal, and within
     one 8-bit level of the default frame and of the all-pairs backend's
     on all but 0.01 % of pixels; one frame shaded through a trace built
     with use_occlusion_kernel=True (4 K6 launches), equal to the K5 frame;
 15. a JSON line of the kernels, then the last line
     {"ok": true, "device": {...}}.  ``launches`` are those of the render
     paths; the uncapped member-masked mode of the w-occlusion kernel is on
     none of them (``on_a_render_path`` false, launches 0) and is listed
     for its comparison and times; K6 is reached through a factory option
     that no setting of render_image takes (``on_a_render_path`` false, the
     launches of phase 14's frame); K7's launches are those of phase 7's
     CRT_TILE_MERGE=2 frame, K10's and K11's those of phase 13's frames.

``--profile`` runs, instead of phases 3 to 14, a torch.profiler pass over
three forward+backward frames: host enqueue time vs device kernel time,
the top device kernels, the segment-sum kernel's share and peak memory.
``--large`` runs phases 10 to 14 only.  ``--parent DIR`` builds the
kernels of another checkout (DIR/crt_tpu_torch/csrc, the same files)
beside this one's and runs only phase 4's K1 / K2 / K3 / K4 shapes, K1,
K2 and K4 also held to the other build's kernel on every lane (K3's
distance from it printed: its atomics add in another order) and every
time taken in turns (other, this, this, other), then profiles the opaque
forward and forward+backward frames, the glass scan frame and the glass
scan frame with compact_bounces with each build in the same turns (device
time and launches, each redesigned kernel's share); no JSON lines.  The
other checkout's kernels must have this one's entry points and
signatures (a library without ``crt_live_tiles`` is refused).

Tolerances.  The trace kernels (closest hit, compacted and tile-merged
closest hit, every mode of the w-occlusion, both launches of the
direction-form occlusion, the streaming closest hit and any-hit in every
table layout): bit-equal to their plain versions.  The
segment-sum kernel: |kernel - fp64| <= 4e-6 * sum|g| per segment, which is
ten times the largest error this script has read (3.7e-7, on the bench
frame's 640,651-ray segment) and a tenth of the worst case of the kernel's
~5 + 128 + R / 4096 sequential f32 additions at 2^-24 each, so a kernel
that lost 1e-5 of a segment's rays fails; and |kernel - plain| <= 5e-4 *
sum|g|, four times the plain version's own distance from fp64 (1.3e-4
read: it adds up to 10^6 terms one f32 atomic at a time; printed).  The
kernels line carries the fp64 error as max_abs_err and the distance from
the plain version as max_abs_err_vs_plain.
Gradients: cluster vs all-pairs backend on the card rtol 1e-3 / atol 1e-4
of the group's largest entry (same hit ids, sums of 2 M pixels in another
order); card vs CPU rtol 1e-4 / atol 2e-4 of the largest entry (a vertex
gradient sums per-pixel terms of both signs that largely cancel, in the
kernel's tree order on the card and one by one on the CPU, over shading
values that differ by an ulp between the devices; 5e-5 observed).

Needs one CUDA card; exits with an error when there is none.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

BENCH = dict(width=1920, height=1080, num_quads=64)
TILE = 1024
TRAINED = ("vertices", "light_intensity", "cam_position")

# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory rate
# and dense fp32 rate outside the tensor cores.
H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12
# member_t of csrc/cluster_common.cuh: two 3-dots and a subtract for the
# plane, a divide, and per edge two 3-dots, a subtract, a multiply, an add.
FLOPS_PER_MEMBER = 5 + 5 + 1 + 1 + 3 * 13
# The no-FMA floor of a bit-exact member test: the kernels are built with
# -fmad=false, so each of the 50 multiplies and adds is an FP32 instruction
# of its own, and the IEEE divide is a sequence (a reciprocal at a quarter
# of the FP32 rate and about five FMA-class steps: ~9 issue slots).  At one
# FP32 instruction a lane a clock the card issues H100_FP32_FLOPS / 2 a
# second (the rate counts an FMA as two flops).
NOFMA_SLOTS_PER_MEMBER = 50 + 9
H100_FP32_ISSUE = H100_FP32_FLOPS / 2


def bound_ms(num_bytes: float, flops: float) -> dict:
    """The least time the card could take: every input byte read once and
    every output byte written once at the memory rate, or the arithmetic
    at the peak fp32 rate, whichever is larger."""
    by = num_bytes / H100_BYTES_PER_S * 1e3
    op = flops / H100_FP32_FLOPS * 1e3
    return {"bound_ms": max(by, op),
            "bound_by": "bytes" if by >= op else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def walk_bound(tables, cl, cnt, rays, outputs, active, blocked=None,
               rows_table=None, small=()) -> dict:
    """Bound of a cluster-walk kernel from what this run gave it.

    Bytes: the counts, the walked list entries, the tables and the
    ``small`` inputs (lights, member mask, tile permutation) once, every
    output in full, and of the per-lane ``rays`` ([R, 3] each) only the
    tiles the answer needs: those with a list to walk.  List tile i reads
    ray tile i % (R / TILE), so the lights of a shadow pass share one copy.
    Operations: member tests the answer needs.  A lane of ``active``
    [tiles, TILE] (the lanes the lists were binned for) must test every
    real member of every cluster on its tile's list; a lane that
    ``blocked`` marks (an any-hit answer) needs one test, its blocker's; a
    lane outside ``active`` needs none."""
    walked = int(cnt.sum())
    table_bytes = nbytes(tables.n, tables.nv0, tables.m, tables.c,
                         tables.nobf, tables.tri_id, rows_table)
    live = torch.nonzero(cnt > 0)[:, 0]
    ray_bytes = 0
    for x in rays:
        ray_tiles = x.shape[0] // TILE
        needed = int(torch.unique(live % ray_tiles).numel())
        ray_bytes += needed * TILE * x.shape[1] * x.element_size()
    num_bytes = (ray_bytes + nbytes(cnt, *small, *outputs) + 4 * walked
                 + table_bytes)
    full = active if blocked is None else active & ~blocked
    tests = int((full.sum(dim=1) * tile_members(tables, cl, cnt)).sum())
    if blocked is not None:
        tests += int((active & blocked).sum())
    return {**bound_ms(num_bytes, tests * FLOPS_PER_MEMBER),
            "member_tests": tests, "ray_bytes": ray_bytes}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {msg}")


def cuda_ms(fn, warmup: int = 2, reps: int = 5) -> float:
    """Median CUDA-event time of fn() in ms, after warm-ups."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare_hits(name, got, want):
    """Bit-equality of (t, tri, rows) triples; prints differing lanes."""
    t, tri, rows = got
    t0, tri0, rows0 = want
    bad = (tri != tri0) | ~((t == t0) | (torch.isinf(t) & torch.isinf(t0)))
    if rows is not None:
        bad |= (rows != rows0).any(dim=0)
    n_bad = int(bad.sum())
    if n_bad:
        for i in torch.nonzero(bad)[:10, 0].tolist():
            print(f"  {name} lane {i}: kernel (t={t[i].item()!r}, "
                  f"tri={tri[i].item()}) plain (t={t0[i].item()!r}, "
                  f"tri={tri0[i].item()})")
    fin = torch.isfinite(t) & torch.isfinite(t0)
    err = float((t[fin] - t0[fin]).abs().max()) if bool(fin.any()) else 0.0
    if rows is not None:
        err = max(err, float((rows - rows0).abs().max()))
    check(n_bad == 0, f"{name}: {n_bad} lanes differ from the plain version")
    return err


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[device] torch.cuda: {name}; count {torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)  # name, power limit: as nvidia-smi prints them, on their own
    return name


def phase_build():
    from crt_tpu_torch.ops import cuda_lib

    info = cuda_lib.build()
    cuda_lib.load()
    print(f"[build] {info.path}: {info.seconds:.2f} s in nvcc, "
          f"cache hit {info.cache_hit}")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] ptxas: {line.strip()}")


def primary_wavefront(scene):
    from crt_tpu_torch.ops import camera
    from crt_tpu_torch.renderer import make_tiler

    rx, ry, _ = make_tiler(scene.height, scene.width, device=scene.device)
    o, d = camera.generate_rays(scene.cam_position, scene.cam_rotation,
                                scene.cam_tan_half_fov, scene.width,
                                scene.height, rx, ry)
    return o.contiguous(), d.contiguous()


def mirror_bounce(scene, settings, o, d, k):
    """The masked mirror-bounce wavefront behind closest-hit results ``k``
    (t, tri, rows), built as the shader builds it: (o, d, active)."""
    from crt_tpu_torch.ops import vecmath
    from crt_tpu_torch.ops.intersect import Hit
    from crt_tpu_torch.ops.shade import hit_attributes
    from crt_tpu_torch.scene.types import MATERIAL_REFLECTIVE

    attrs = hit_attributes(scene, o, d, Hit(t=k[0], tri=k[1]),
                           kernel_rows=k[2])
    refl_d = vecmath.reflect(d, attrs.normal).contiguous()
    refl_o = (attrs.point + attrs.normal * settings.reflection_bias
              ).contiguous()
    return refl_o, refl_d, attrs.valid & (attrs.mat_type
                                          == MATERIAL_REFLECTIVE)


def phase_kernels(device):
    from crt_tpu_torch.ops.binning import bin_apex_shared, bin_rays
    from crt_tpu_torch.ops.cluster_tables import (
        build_cluster_tables, emit_rows_table,
    )
    from crt_tpu_torch.ops.cluster_trace import (
        closest_hit, closest_hit_plain, occlusion_w, occlusion_w_plain,
    )
    from crt_tpu_torch.ops.intersect import Hit
    from crt_tpu_torch.scene.procedural import make_test_scene
    from crt_tpu_torch.scene.types import RenderSettings

    scene = make_test_scene(**BENCH, device=device)
    st = RenderSettings()
    tables = build_cluster_tables(scene)
    rows_table = emit_rows_table(scene, tables)
    o, d = primary_wavefront(scene)
    R = o.shape[0]
    act = torch.ones(R, dtype=torch.bool, device=device)
    cl, cnt = bin_rays(tables, o, d, TILE, act)
    print(f"[kernels] bench scene: {scene.num_triangles} triangles, "
          f"{tables.n.shape[0]} clusters, {R} rays in {R // TILE} tiles, "
          f"list length max {int(cnt.max())} mean {float(cnt.float().mean()):.2f}")

    k = closest_hit(tables, o, d, cl, cnt, rows_table)
    p = closest_hit_plain(tables, o, d, cl, cnt, rows_table)
    err_k1 = compare_hits("closest_hit primary", k, p)
    ms_k1 = cuda_ms(lambda: closest_hit(tables, o, d, cl, cnt, rows_table))
    ms_k1p = cuda_ms(lambda: closest_hit_plain(tables, o, d, cl, cnt,
                                               rows_table))
    print(f"[kernels] closest_hit primary: bit-equal on {R} lanes; "
          f"kernel {ms_k1:.3f} ms, plain {ms_k1p:.3f} ms")

    refl_o, refl_d, refl_act = mirror_bounce(scene, st, o, d, k)
    bcl, bcnt = bin_rays(tables, refl_o, refl_d, TILE, refl_act)
    kb = closest_hit(tables, refl_o, refl_d, bcl, bcnt, rows_table)
    pb = closest_hit_plain(tables, refl_o, refl_d, bcl, bcnt, rows_table)
    err_k1 = max(err_k1, compare_hits("closest_hit bounce", kb, pb))
    print(f"[kernels] closest_hit bounce: {int(refl_act.sum())} active lanes, "
          f"{int((bcnt > 0).sum())} live tiles, bit-equal")

    w = depth0_shadow_wavefront(scene, st, o, d, Hit(t=k[0], tri=k[1]),
                                kernel_rows=k[2])
    point, shadow_o, lights, act_lr = (w["point"], w["shadow_o"], w["lights"],
                                       w["act"])
    scl, scnt = bin_apex_shared(tables, shadow_o, lights, act_lr, TILE,
                                2.0 * st.shadow_bias)
    ko = occlusion_w(tables, shadow_o, point, lights, scl, scnt)
    po = occlusion_w_plain(tables, shadow_o, point, lights, scl, scnt)
    n_bad = int((ko != po).sum())
    err_k2 = float((ko.to(torch.int32) - po.to(torch.int32)).abs().max())
    check(n_bad == 0, f"occlusion_w: {n_bad} lanes differ from the plain version")
    ms_k2 = cuda_ms(lambda: occlusion_w(tables, shadow_o, point, lights,
                                        scl, scnt))
    ms_k2p = cuda_ms(lambda: occlusion_w_plain(tables, shadow_o, point,
                                               lights, scl, scnt))
    print(f"[kernels] occlusion_w shadow: {ko.numel()} lanes in "
          f"{scnt.numel()} tiles ({int((scnt > 0).sum())} live), "
          f"{int(ko.sum())} blocked, equal; kernel {ms_k2:.3f} ms, "
          f"plain {ms_k2p:.3f} ms")
    b1 = walk_bound(tables, cl, cnt, (o, d), k, act.reshape(-1, TILE),
                    rows_table=rows_table)
    b2 = walk_bound(tables, scl, scnt, (shadow_o, point), (ko,),
                    act_lr.reshape(-1, TILE), blocked=ko.reshape(-1, TILE),
                    small=(lights,))
    tests1, tests2 = b1.pop("member_tests"), b2.pop("member_tests")
    b1.pop("ray_bytes"), b2.pop("ray_bytes")
    print(f"[kernels] bounds from this run's inputs: closest_hit "
          f"{b1['bound_ms']:.4f} ms ({b1['bound_by']}, {int(cnt.sum())} "
          f"walked entries, {tests1} member tests needed), occlusion_w "
          f"{b2['bound_ms']:.4f} ms ({b2['bound_by']}, {int(scnt.sum())} "
          f"walked entries, {int(act_lr.sum())} active lanes, {tests2} "
          f"member tests needed)")
    return {
        "closest_hit": dict(max_abs_err=err_k1, ms=ms_k1, plain_ms=ms_k1p,
                            library_ms=None, **b1),
        "occlusion_w": dict(max_abs_err=err_k2, ms=ms_k2, plain_ms=ms_k2p,
                            library_ms=None, **b2),
    }


def grad_params(scene, keys=TRAINED):
    return {k: getattr(scene, k).detach().clone().requires_grad_(True)
            for k in keys}


def image_sum_grads(scene, settings=None, keys=TRAINED):
    """value_and_grad of render_image(scene).sum() w.r.t. ``keys``."""
    from crt_tpu_torch import render_image

    params = grad_params(scene, keys)
    value = render_image(scene.replace(**params), settings).sum()
    value.backward()
    return value.detach(), {k: p.grad for k, p in params.items()}


def record_segsums(scene, keys=TRAINED):
    """(ids, g, T) of every segment sum that one real backward of the
    frame (value_and_grad of the image sum w.r.t. ``keys``) makes."""
    from crt_tpu_torch.ops import segsum

    calls = []
    real = segsum.segment_accumulate

    def recording(ids, g, num_segments, *args, **kw):
        calls.append((ids, g, num_segments))
        return real(ids, g, num_segments, *args, **kw)

    segsum.segment_accumulate = recording
    try:
        image_sum_grads(scene, keys=keys)
    finally:
        segsum.segment_accumulate = real
    return calls


def live_rays(ids, T) -> int:
    return int(((ids >= 0) & (ids < T)).sum())


def most_live(calls):
    """The recorded call with the most live rays (the primary
    wavefront's)."""
    return max(calls, key=lambda c: live_rays(c[0], c[2]))


def capture_depth0_cotangents(scene):
    """One real backward of the frame with the segment sum's inputs
    recorded: (ids, g, T) of the call with the most live rays, which is the
    primary wavefront's."""
    calls = record_segsums(scene)
    check(len(calls) == 4,
          f"the backward called the segment sum {len(calls)} times, "
          "expected 4 (one per shading level)")
    return most_live(calls)


def segsum_bound(ids, g, T) -> dict:
    """K3's bound from this run's data: every id read, the g values of the
    rays with a valid id (a miss's cotangents are not needed, and the
    kernel reads none), every output written."""
    K, R = g.shape
    live = live_rays(ids, T)
    return bound_ms(4 * R + 4 * K * live + 4 * K * T, K * live)


def hold_segsum(name, ids, g, T, out):
    """K3's result ``out`` vs an fp64 sum of the same terms (4e-6 of each
    segment's sum|g|) and vs the plain version (5e-4); prints both, with
    the plain version's own distance from fp64.  -> (max |out - fp64|,
    max |out - plain|)."""
    from crt_tpu_torch.ops import segsum

    plain = segsum.segment_accumulate_plain(ids, g, T)
    exact = segsum.segment_accumulate_plain(ids, g.double(), T)
    mass = segsum.segment_accumulate_plain(ids, g.double().abs(), T)
    err = (out.double() - exact).abs()
    plain_err = (plain.double() - exact).abs()
    rel = float((err / mass.clamp(min=1e-300)).max())
    plain_rel = float((plain_err / mass.clamp(min=1e-300)).max())
    vs_plain = (out - plain).abs()
    print(f"{name}: vs fp64 max abs {float(err.max()):.3e} max rel to "
          f"sum|g| {rel:.3e} (plain version: {float(plain_err.max()):.3e}, "
          f"{plain_rel:.3e}); vs plain max abs {float(vs_plain.max()):.3e}")
    check(bool(torch.isfinite(out).all()), f"{name}: not finite")
    check(bool((err <= 4e-6 * mass).all()),
          f"{name}: off the fp64 sum by {rel:.3e} of sum|g| (tolerance 4e-6)")
    check(bool((vs_plain.double() <= 5e-4 * mass).all()),
          f"{name}: off the plain version by more than 5e-4 sum|g|")
    return float(err.max()), float(vs_plain.max())


def check_segsum(name, ids, g, T):
    """K3 vs plain, vs fp64 and vs itself on (ids [R], g [K, R]); times."""
    from crt_tpu_torch.ops import segsum

    K, R = g.shape
    out = segsum.segment_accumulate(ids, g, T)
    again = segsum.segment_accumulate(ids, g, T)
    torch.cuda.synchronize()
    rerun = float((out - again).abs().max())
    live = live_rays(ids, T)
    top = int(torch.bincount(ids[ids >= 0].long(), minlength=1).max())
    print(f"[kernels] segsum {name}: K {K}, R {R}, T {T}, {live} live rays, "
          f"largest segment {top} rays; two launches differ by {rerun:.3e}")
    err, vs_plain = hold_segsum(f"[kernels] segsum {name}", ids, g, T, out)

    col = torch.where((ids >= 0) & (ids < T), ids, T).long()

    def library():
        return torch.zeros((K, T + 1), device=g.device).index_add_(1, col, g)

    ms = cuda_ms(lambda: segsum.segment_accumulate(ids, g, T))
    ms_plain = cuda_ms(lambda: segsum.segment_accumulate_plain(ids, g, T))
    ms_lib = cuda_ms(library)
    b = segsum_bound(ids, g, T)
    print(f"[kernels] segsum {name}: kernel {ms:.3f} ms, plain {ms_plain:.3f}"
          f" ms, index_add_ {ms_lib:.3f} ms, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']})")
    return dict(max_abs_err=err, max_abs_err_vs_plain=vs_plain, ms=ms,
                plain_ms=ms_plain, library_ms=ms_lib, **b)


def phase_segsum(device):
    from crt_tpu_torch.ops.binning import bin_rays
    from crt_tpu_torch.ops.cluster_tables import (
        build_cluster_tables, emit_rows_table,
    )
    from crt_tpu_torch.ops.cluster_trace import closest_hit
    from crt_tpu_torch.scene.procedural import make_big_scene, make_test_scene

    scene = make_test_scene(**BENCH, device=device)
    ids, g, T = capture_depth0_cotangents(scene)
    stats = check_segsum("bench frame, depth-0 cotangents", ids, g, T)
    del ids, g

    # the big scene's primary wavefront: ids from the closest-hit kernel's
    # slot-rank row, seeded cotangents
    big = make_big_scene(num_triangles=65536, width=BENCH["width"],
                         height=BENCH["height"], seed=0, device=device)
    tables = build_cluster_tables(big)
    o, d = primary_wavefront(big)
    cl, cnt = bin_rays(tables, o, d, TILE,
                       torch.ones(o.shape[0], dtype=torch.bool, device=device))
    _, tri, rows = closest_hit(tables, o, d, cl, cnt,
                               emit_rows_table(big, tables))
    ids = torch.where(tri >= 0, rows[-1].to(torch.int32), -1).contiguous()
    gen = torch.Generator(device="cpu").manual_seed(0)
    g = torch.randn((rows.shape[0] - 1, 1024), generator=gen).to(device)
    g = g.repeat(1, ids.shape[0] // 1024).contiguous()
    g *= 1.0 + torch.arange(g.shape[1], device=device) % 7
    check_segsum("big scene, primary wavefront", ids, g, big.num_triangles)
    return stats


def phase_scale(device, num_triangles=65536, width=1920, height=1080):
    from crt_tpu_torch.ops.binning import bin_rays
    from crt_tpu_torch.ops.cluster_tables import (
        build_cluster_tables, emit_rows_table,
    )
    from crt_tpu_torch.ops.cluster_trace import closest_hit, closest_hit_plain
    from crt_tpu_torch.scene.procedural import make_big_scene

    scene = make_big_scene(num_triangles=num_triangles, width=width,
                           height=height, seed=0, device=device)
    tables = build_cluster_tables(scene)
    rows_table = emit_rows_table(scene, tables)
    o, d = primary_wavefront(scene)
    R = o.shape[0]
    act = torch.ones(R, dtype=torch.bool, device=device)
    cl, cnt = bin_rays(tables, o, d, TILE, act)
    t, tri, rows = closest_hit(tables, o, d, cl, cnt, rows_table)
    ms = cuda_ms(lambda: closest_hit(tables, o, d, cl, cnt, rows_table),
                 warmup=1, reps=3)
    b = walk_bound(tables, cl, cnt, (o, d), (t, tri, rows),
                   act.reshape(-1, TILE), rows_table=rows_table)
    print(f"[scale] big scene: {scene.num_triangles} triangles, "
          f"{tables.n.shape[0]} clusters; list length max {int(cnt.max())} "
          f"mean {float(cnt.float().mean()):.1f}; closest_hit {ms:.3f} ms, "
          f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}, "
          f"{b['member_tests']} member tests needed); "
          f"hits {int((tri >= 0).sum())} of {R}")

    gen = torch.Generator(device="cpu").manual_seed(0)
    tiles = R // TILE
    pick = torch.randperm(tiles, generator=gen)[:16].sort().values.to(device)
    lanes = (pick[:, None] * TILE + torch.arange(TILE, device=device)).reshape(-1)
    sub = closest_hit_plain(tables, o[lanes].contiguous(), d[lanes].contiguous(),
                            cl[pick].contiguous(), cnt[pick].contiguous(),
                            rows_table)
    compare_hits("closest_hit big-scene tiles", (t[lanes], tri[lanes],
                                                 rows[:, lanes]), sub)
    print(f"[scale] closest_hit vs plain on tiles {pick.tolist()}: bit-equal "
          f"(list lengths {cnt[pick].tolist()})")

    bruteforce_agreement("[scale] closest_hit", scene, o, d, t, tri, gen,
                         device)


# ---------------------------------------------------------------------------
# The redesigned kernels at the shapes of their redesign (PERF.md, section 6)
# ---------------------------------------------------------------------------

SHAPE_SAMPLE_TILES = 16  # tiles held to the plain version at 65,536 triangles


def tile_members(tables, cl, cnt):
    """[tiles] real members on each tile's list."""
    members = (tables.tri_id >= 0).sum(dim=1)
    on_list = torch.arange(cl.shape[1], device=cl.device) < cnt[:, None]
    return (members[cl.long()] * on_list).sum(dim=1)


def floor_ms(tests: int) -> float:
    """The no-FMA floor of ``tests`` member tests."""
    return tests * NOFMA_SLOTS_PER_MEMBER / H100_FP32_ISSUE * 1e3


def cuda_ms_many(fn, launches: int = 10, warmup: int = 2,
                 reps: int = 5) -> float:
    """Median over ``reps`` of the CUDA-event time of ``launches`` calls of
    fn() back to back, per call, after warm-ups: a short kernel queues
    behind the previous one instead of waiting for the host (unless the
    host takes longer to enqueue a call than the device to run it)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def dev_us(ev) -> float:
    """An event's own device time (us) in torch.profiler's key_averages."""
    return getattr(ev, "self_device_time_total",
                   getattr(ev, "self_cuda_time_total", 0.0))


def device_ms(fn, calls: int = 10, traces: int = 3) -> float:
    """Device time per call of fn(): every device row of a torch.profiler
    trace (kernels, memsets, copies) over ``calls`` calls after a warm-up,
    summed; the median of ``traces`` traces (a trace now and then misses
    events, and now and then records none at all: such a trace is taken
    again, up to ``3 * traces`` traces in all).  Unlike cuda_ms_many, the
    host's enqueue time is not in it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(3 * traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(dev_us(ev) for ev in prof.key_averages()
                 if ev.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            times.append(us)
        if len(times) == traces:
            break
    check(len(times) == traces,
          f"the profiler recorded device time in {len(times)} of "
          f"{3 * traces} traces")
    return statistics.median(times) / calls / 1e3


class kernels_from:
    """Within the block the kernel wrappers launch the kernels of ``lib``
    (bind_parent: a library built by cuda_lib.build from another
    checkout's sources)."""

    def __init__(self, lib):
        self.lib = lib

    def __enter__(self):
        from crt_tpu_torch.ops import cuda_lib

        self.saved = cuda_lib.load
        cuda_lib.load = lambda: (self.lib, None)

    def __exit__(self, *exc):
        from crt_tpu_torch.ops import cuda_lib

        cuda_lib.load = self.saved


def on(lib, fn):
    """fn() with the kernels of ``lib``, or of this checkout (None)."""
    if lib is None:
        return fn()
    with kernels_from(lib):
        return fn()


def bind_parent(path):
    """Load another checkout's library with this checkout's interface
    (cuda_lib.bind); refuse one whose entry points differ."""
    import ctypes

    from crt_tpu_torch.ops import cuda_lib

    if not hasattr(ctypes.CDLL(path), "crt_live_tiles"):
        raise RuntimeError(
            f"{path}: the other checkout's kernels have no crt_live_tiles "
            "entry, so their K4 and K3 take other arguments than this "
            "checkout's wrappers pass; --parent needs a checkout with this "
            "interface")
    return cuda_lib.bind(path)


def sample_tiles(cnt, gen, n=SHAPE_SAMPLE_TILES):
    """``n`` seeded tiles with a list (all of them when fewer)."""
    live = torch.nonzero(cnt > 0)[:, 0].cpu()
    pick = live[torch.randperm(live.numel(), generator=gen)[:n]]
    return pick.sort().values.to(cnt.device)


def k1_shape(tag, name, tables, o, d, act, rows_table, gen=None):
    """K1 on one wavefront: its lists, calls, plain check and bound."""
    from crt_tpu_torch.ops.binning import bin_rays
    from crt_tpu_torch.ops.cluster_trace import closest_hit, closest_hit_plain

    cl, cnt = bin_rays(tables, o, d, TILE, act)
    dead = torch.zeros_like(cnt)

    def run(counts=cnt, rows=rows_table):
        return closest_hit(tables, o, d, cl, counts, rows)

    out = run()
    if gen is None:  # every lane
        compare_hits(f"{tag} {name}", out,
                     closest_hit_plain(tables, o, d, cl, cnt, rows_table))
        held = "bit-equal to the plain version on every lane"
    else:  # sampled tiles: the plain version walks long lists slowly
        pick = sample_tiles(cnt, gen)
        lanes = (pick[:, None] * TILE
                 + torch.arange(TILE, device=o.device)).reshape(-1)
        sub = closest_hit_plain(tables, o[lanes].contiguous(),
                                d[lanes].contiguous(), cl[pick].contiguous(),
                                cnt[pick].contiguous(), rows_table)
        got = (out[0][lanes], out[1][lanes],
               None if out[2] is None else out[2][:, lanes])
        compare_hits(f"{tag} {name}", got, sub)
        held = f"bit-equal to the plain version on {pick.numel()} sampled tiles"
    act2 = (torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
            if act is None else act).reshape(-1, TILE)
    b = walk_bound(tables, cl, cnt, (o, d),
                   tuple(x for x in out if x is not None), act2,
                   rows_table=rows_table)
    calls = {"kernel": lambda lib=None: on(lib, run),
             "dead": lambda lib=None: on(lib, lambda: run(dead))}
    if rows_table is not None:
        calls["kp0"] = lambda lib=None: on(lib, lambda: run(rows=None))
    kp = 0 if rows_table is None else rows_table.shape[-1]
    return dict(tag=tag, name=name, kernel="K1", calls=calls, out=out,
                bound=b, held=held, lists=(cl, cnt), act=act2,
                text=(f"{o.shape[0]} lanes in {cnt.numel()} tiles "
                      f"({int((cnt > 0).sum())} live), list length mean "
                      f"{float(cnt.float().mean()):.3f} max {int(cnt.max())}"
                      f", kp {kp}"))


def k4_shape(tag, name, tables, o, d, k1, rows_table):
    """K4 on the lists of K1's shape ``k1``: bit-equal to its plain
    version and to K1 on every lane, its tile list equal to the plain
    one; calls timed beside K1's on the same lists."""
    from crt_tpu_torch.ops import cluster_trace as ct

    cl, cnt = k1["lists"]
    dead = torch.zeros_like(cnt)

    def run(lib=None, counts=cnt):
        return on(lib, lambda: ct.closest_hit_compact(tables, o, d, cl, counts,
                                                      rows_table))

    def k1_run(lib=None):
        return on(lib, lambda: ct.closest_hit(tables, o, d, cl, cnt,
                                              rows_table))

    out = run()
    compare_hits(f"{tag} {name} vs plain", out,
                 ct.closest_hit_compact_plain(tables, o, d, cl, cnt,
                                              rows_table))
    compare_hits(f"{tag} {name} vs K1", out, k1["out"])
    ids, n_live = ct.live_tiles(cnt)
    want_ids, want_n = ct.live_tiles_plain(cnt)
    check(torch.equal(ids, want_ids) and torch.equal(n_live, want_n),
          f"{tag} {name}: the live-tile list differs from its plain version")
    b = walk_bound(tables, cl, cnt, (o, d),
                   tuple(x for x in out if x is not None), k1["act"],
                   rows_table=rows_table, small=(ids, n_live))
    return dict(
        tag=tag, name=name, kernel="K4", out=out, bound=b,
        held=("bit-equal to the plain version and to K1 on every lane, its "
              "tile list equal to the plain one"),
        calls={"kernel": run, "single": run, "device": run,
               "dead": lambda lib=None: run(lib, dead), "K1": k1_run,
               "K1 device": k1_run,
               "list device": lambda lib=None: on(
                   lib, lambda: ct.live_tiles(cnt))},
        timers={"single": cuda_ms, "device": device_ms,
                "K1 device": device_ms, "list device": device_ms},
        text=f"{k1['text']}; {int(n_live)} live tiles first")


def k3_shape(tag, name, ids, g, T):
    """K3 on recorded or seeded cotangents: within 4e-6 sum|g| of fp64 and
    5e-4 sum|g| of the plain version."""
    from crt_tpu_torch.ops import segsum

    def run(lib=None, ids=ids):
        return on(lib, lambda: segsum.segment_accumulate(ids, g, T))

    misses = torch.full_like(ids, -1)
    out = run()
    torch.cuda.synchronize()
    hold_segsum(f"{tag} {name}", ids, g, T, out)
    K, R = g.shape
    live = live_rays(ids, T)
    runs = int((ids[1:] != ids[:-1]).sum()) + 1
    return dict(
        tag=tag, name=name, kernel="K3", out=out, inputs=(ids, g, T),
        bound=segsum_bound(ids, g, T),
        held=("within 4e-6 sum|g| of fp64 and 5e-4 sum|g| of the plain "
              "version"),
        calls={"kernel": run, "single": run, "device": run,
               "misses device": lambda lib=None: run(lib, misses)},
        timers={"single": cuda_ms, "device": device_ms,
                "misses device": device_ms},
        text=(f"K {K}, R {R}, T {T}, {live} live rays in {runs} runs of "
              "equal ids"))


def k2_shape(tag, name, tables, shadow_o, point, lights, act_lr, cl, cnt,
             gen=None, **kw):
    """K2 in one mode on one shadow wavefront."""
    from crt_tpu_torch.ops.cluster_trace import occlusion_w, occlusion_w_plain

    dead = torch.zeros_like(cnt)

    def run(counts=cnt):
        return occlusion_w(tables, shadow_o, point, lights, cl, counts, **kw)

    out = run()
    outs = out if isinstance(out, tuple) else (out,)
    tpl = shadow_o.shape[0] // TILE
    if gen is None:
        want = occlusion_w_plain(tables, shadow_o, point, lights, cl, cnt,
                                 **kw)
        want = want if isinstance(want, tuple) else (want,)
        got = outs
        held = "equal to the plain version on every lane"
    else:  # sampled tiles, one light at a time
        pick = sample_tiles(cnt, gen)
        lane = torch.arange(TILE, device=cnt.device)
        got, want = [[] for _ in outs], [[] for _ in outs]
        for light in torch.unique(pick // tpl).tolist():
            mine = pick[pick // tpl == light]
            src = ((mine % tpl)[:, None] * TILE + lane).reshape(-1)
            w = occlusion_w_plain(
                tables, shadow_o[src].contiguous(), point[src].contiguous(),
                lights[light:light + 1].contiguous(), cl[mine].contiguous(),
                cnt[mine].contiguous(), **kw)
            w = w if isinstance(w, tuple) else (w,)
            rows = (mine[:, None] * TILE + lane).reshape(-1)
            for i, x in enumerate(outs):
                got[i].append(x[rows])
                want[i].append(w[i])
        got = [torch.cat(g) for g in got]
        want = [torch.cat(w) for w in want]
        held = f"equal to the plain version on {pick.numel()} sampled tiles"
    n_bad = sum(int((g != w).sum()) for g, w in zip(got, want))
    check(n_bad == 0, f"{tag} {name}: {n_bad} lanes differ from the plain "
          "version")
    # a lane may leave once it has nothing left to learn
    done = outs[0] & outs[1] if len(outs) == 2 else outs[0]
    gm = kw.get("member_mask")
    b = walk_bound(tables, cl, cnt, (shadow_o, point), outs,
                   act_lr.reshape(-1, TILE), blocked=done.reshape(-1, TILE),
                   small=(lights,) + (() if gm is None else (gm,)))
    members = tile_members(tables, cl, cnt)
    no_exit = int(members.sum()) * TILE
    packed, packed_tests = repacked_rays(shadow_o, point, lights, cnt,
                                         members)
    return dict(tag=tag, name=name, kernel="K2", calls={
        "kernel": lambda lib=None: on(lib, run),
        "dead": lambda lib=None: on(lib, lambda: run(dead))},
        out=outs, bound=b, held=held,
        text=(f"{shadow_o.shape[0] * lights.shape[0]} lanes in {cnt.numel()} tiles "
              f"({int((cnt > 0).sum())} live), list length mean "
              f"{float(cnt.float().mean()):.3f} max {int(cnt.max())}; "
              f"{int(done.sum())} lanes done; member tests without any exit "
              f"{no_exit}, needed {b['member_tests']} "
              f"({no_exit / max(b['member_tests'], 1):.2f}x); rays walked "
              f"after repacking {packed} of {int((cnt > 0).sum()) * TILE} "
              f"lanes of live tiles, member tests of their warps without "
              f"any exit {packed_tests}"))


def repacked_rays(shadow_o, point, lights, cnt, members):
    """K2's repacking of a shadow wavefront: (rays walked, member tests of
    the warps they fill) on the tiles with a list.  A lane whose ray (o and
    w = light - p, bit for bit) is its warp's first lane's is not walked;
    the other rays of each 256-lane unit fill ceil(n / 32) warps."""
    Ll = lights.shape[0]
    w = (lights[:, None, :] - point[None]).reshape(-1, 3)
    ray = torch.cat([shadow_o.repeat(Ll, 1), w], dim=1).contiguous()
    bits = ray.view(torch.int32).reshape(-1, 32, 6)
    own = (bits != bits[:, :1]).any(dim=2)
    own[:, 0] = True
    per_unit = own.reshape(-1, 256).sum(dim=1)
    live = (cnt > 0).repeat_interleave(TILE // 256)
    warps = torch.div(per_unit + 31, 32, rounding_mode="floor")
    tests = warps * 32 * members.repeat_interleave(TILE // 256)
    return int(per_unit[live].sum()), int(tests[live].sum())


def kernel_shapes(device):
    """K1, K2, K3 and K4 at the shapes of PERF.md's redesign tables, in the
    order [kernels] (opaque bench frame), [glass] (refractive bench frame,
    its bounce-1 pool and backward recorded from a real frame), [scale]
    (65,536 triangles)."""
    from crt_tpu_torch.ops.binning import bin_apex_shared, bin_rays
    from crt_tpu_torch.ops.cluster_tables import (
        build_cluster_tables, emit_rows_table, glass_subset,
    )
    from crt_tpu_torch.ops.cluster_trace import closest_hit
    from crt_tpu_torch.ops.intersect import Hit
    from crt_tpu_torch.scene.procedural import make_big_scene, make_test_scene
    from crt_tpu_torch.scene.types import RenderSettings

    st = RenderSettings()
    slack = 2.0 * st.shadow_bias
    gen = torch.Generator(device="cpu").manual_seed(7)

    # the opaque bench frame
    scene = make_test_scene(**BENCH, device=device)
    tables = build_cluster_tables(scene)
    rows_table = emit_rows_table(scene, tables)
    o, d = primary_wavefront(scene)
    prim = k1_shape("[kernels]", "K1 opaque primary", tables, o, d, None,
                    rows_table)
    yield prim
    k = prim["out"]
    refl_o, refl_d, refl_act = mirror_bounce(scene, st, o, d, k)
    bounce = k1_shape("[kernels]", "K1 opaque masked mirror bounce", tables,
                      refl_o, refl_d, refl_act, rows_table)
    yield bounce
    yield k4_shape("[kernels]", "K4 opaque masked mirror bounce", tables,
                   refl_o, refl_d, bounce, rows_table)
    del bounce
    w = depth0_shadow_wavefront(scene, st, o, d, Hit(t=k[0], tri=k[1]),
                                kernel_rows=k[2])
    scl, scnt = bin_apex_shared(tables, w["shadow_o"], w["lights"], w["act"],
                                TILE, slack)
    yield k2_shape("[kernels]", "K2 capped, opaque depth-0 shadow", tables,
                   w["shadow_o"], w["point"], w["lights"], w["act"], scl,
                   scnt)
    del prim, k, w
    # the backward of a fit_scene step: the packed rows (K 22) and the
    # texture colours (K 3) of every shading level
    calls = record_segsums(scene, keys=TRAINED + ("tex_color_a",))
    check(len(calls) == 8 and sum(g.shape[0] == 3 for _, g, _ in calls) == 4,
          f"a fit_scene backward made {len(calls)} segment sums, expected 4 "
          "of the packed rows and 4 of the texture colours")
    yield k3_shape("[kernels]", "K3 bench frame, depth-0 cotangents",
                   *most_live([c for c in calls if c[1].shape[0] != 3]))
    yield k3_shape("[kernels]", "K3 fit_scene texture colours, depth 0",
                   *most_live([c for c in calls if c[1].shape[0] == 3]))
    del calls

    # the refractive bench frame
    scene = make_test_scene(**GLASS, device=device)
    tables = build_cluster_tables(scene)
    gm, gmin, gmax = glass_subset(scene, tables)
    rec = record_glass_frame(scene)
    po, pd, pact = rec["traces"][1]
    pool = k1_shape("[glass]", "K1 glass bounce-1 pool", tables, po, pd, pact,
                    None)
    yield pool
    yield k4_shape("[glass]", "K4 glass bounce-1 pool", tables, po, pd, pool,
                   None)
    del pool
    point, shadow_o, lights, act_lr, pslack = rec["shadows"][1]
    gcl, gcnt = bin_apex_shared(tables, shadow_o, lights, act_lr, TILE,
                                pslack, glass_boxes=(gmin, gmax))
    yield k2_shape("[glass]", "K2 glass-flag, bounce-1 pool", tables,
                   shadow_o, point, lights, act_lr, gcl, gcnt,
                   member_mask=gm, glass_flag=True)
    del rec, po, pd, pact, point, shadow_o, act_lr, gcl, gcnt
    o, d = primary_wavefront(scene)
    t, tri, _ = closest_hit(tables, o, d, *bin_rays(tables, o, d, TILE))
    w = depth0_shadow_wavefront(scene, st, o, d, Hit(t=t, tri=tri))
    ucl, ucnt = bin_apex_shared(tables, w["shadow_o"], w["lights"], w["act"],
                                TILE, slack, boxes=(gmin, gmax), capped=False)
    yield k2_shape("[glass]", "K2 uncapped member-masked, depth-0 shadow",
                   tables, w["shadow_o"], w["point"], w["lights"], w["act"],
                   ucl, ucnt, capped=False, member_mask=gm)
    del w
    # the glass backward: per bounce the packed rows over the pool (K 22)
    # and the ior row (K 1)
    calls = record_segsums(scene, keys=GLASS_TRAINED)
    yield k3_shape("[glass]", "K3 glass backward packed rows",
                   *most_live([c for c in calls if c[1].shape[0] != 1]))
    yield k3_shape("[glass]", "K3 glass backward ior row",
                   *most_live([c for c in calls if c[1].shape[0] == 1]))
    del calls

    # 65,536 triangles: the largest scene `auto` sends to this backend
    scene = make_big_scene(**MID, seed=0, device=device)
    tables = build_cluster_tables(scene)
    rows_table = emit_rows_table(scene, tables)
    o, d = primary_wavefront(scene)
    prim = k1_shape("[scale]", "K1 65,536-triangle primary", tables, o, d,
                    None, rows_table, gen=gen)
    yield prim
    k = prim["out"]
    # the wide band: the primary's slot ranks (K1's last row), seeded
    # cotangents, as [kernels] segsum takes them
    ids = torch.where(k[1] >= 0, k[2][-1].to(torch.int32), -1).contiguous()
    g = torch.randn((k[2].shape[0] - 1, 1024), generator=gen).to(device)
    g = g.repeat(1, ids.shape[0] // 1024).contiguous()
    g *= 1.0 + torch.arange(g.shape[1], device=device) % 7
    yield k3_shape("[scale]", "K3 65,536-triangle wide band", ids, g,
                   scene.num_triangles)
    del ids, g
    w = depth0_shadow_wavefront(scene, st, o, d, Hit(t=k[0], tri=k[1]),
                                kernel_rows=k[2])
    del prim, k
    scl, scnt = bin_apex_shared(tables, w["shadow_o"], w["lights"], w["act"],
                                TILE, slack)
    yield k2_shape("[scale]", "K2 capped, 65,536-triangle depth-0 shadow",
                   tables, w["shadow_o"], w["point"], w["lights"], w["act"],
                   scl, scnt, gen=gen)


SHAPE_CALLS = {"kernel": "kernel", "single": "single launch",
               "device": "device time", "dead": "every count zeroed",
               "kp0": "kp = 0", "K1": "K1 on the same lists",
               "K1 device": "K1 device time",
               "list device": "tile list device time",
               "misses device": "device time with every id -1"}


def phase_shapes(device, parent=None):
    """The redesigned kernels at every shape of kernel_shapes, each held
    and timed by shape_turns."""
    return {sh["name"]: shape_turns(sh, parent)
            for sh in kernel_shapes(device)}


def shape_turns(sh, parent=None):
    """One shape of kernel_shapes: K1, K2 and K4 bit-equal to the plain
    version (every lane, or sampled tiles at 65,536 triangles), K4 also to
    K1; K3 within its tolerances of fp64 and of the plain version (held by
    k3_shape).  Given ``parent`` (a library of another checkout's kernels,
    bind_parent), K1, K2 and K4 also equal to its kernels on every lane,
    K3 its distance printed.  Times of the shape's calls: cuda_ms_many
    unless the shape names another timer (a single launch, cuda_ms; device
    time, device_ms): the launch, the launch with every count zeroed (every
    tile dead: the fixed cost of the output stores and the tiles), K1 with
    rows at kp = 0, K4's tile list and K1 on K4's lists, K3 with every id
    -1; given ``parent``, each in turns: parent, new, new, parent.  Bound
    and, where the kernel tests members, no-FMA floor from this run's
    inputs.  -> dict(times, bound_ms)."""
    tag, name = sh["tag"], sh["name"]
    held = sh["held"]
    if parent is not None:
        pout = sh["calls"]["kernel"](parent)
        if sh["kernel"] in ("K1", "K4"):
            compare_hits(f"{tag} {name} vs the parent's kernel",
                         sh["out"], pout)
            held += "; equal to the parent's kernel on every lane"
        elif sh["kernel"] == "K2":
            pout = pout if isinstance(pout, tuple) else (pout,)
            check(all(torch.equal(a, b) for a, b in zip(sh["out"], pout)),
                  f"{tag} {name}: the kernel differs from the parent's")
            held += "; equal to the parent's kernel on every lane"
        else:  # atomics: the last bits may differ
            held += ("; max |new - parent| "
                     f"{float((sh['out'] - pout).abs().max()):.3e}")
    timers = sh.get("timers", {})
    times = {}
    for key, fn in sh["calls"].items():
        timer = timers.get(key, cuda_ms_many)
        if parent is None:
            times[key] = [timer(fn)]
            continue
        p1 = timer(lambda fn=fn: fn(parent))
        n1, n2 = timer(fn), timer(fn)
        times[key] = [n1, n2, p1, timer(lambda fn=fn: fn(parent))]
    b = sh["bound"]

    def fmt(v):
        text = f"{v[0]:.4f} ms"
        if len(v) > 1:
            text += f" ({v[1]:.4f}; parent {v[2]:.4f}, {v[3]:.4f})"
        return text

    if "member_tests" in b:
        tail = (f", {b['member_tests']} member tests needed), no-FMA "
                f"floor {floor_ms(b['member_tests']):.4f} ms")
    else:
        tail = ")"
    print(f"{tag} {name}: {sh['text']}; {held}; "
          + "; ".join(f"{SHAPE_CALLS[k]} {fmt(v)}"
                      for k, v in times.items())
          + f"; bound {b['bound_ms']:.4f} ms ({b['bound_by']}{tail}")
    return dict(times=times, bound_ms=b["bound_ms"])


def profile_turns(device, parent):
    """Profiled device time and launches of the opaque forward and
    forward+backward frames, the glass scan frame and the glass scan frame
    with compact_bounces, with the parent's kernels and the new ones in
    turns (parent, new, new, parent), and the redesigned kernels' share."""
    from crt_tpu_torch import RenderSettings, render_image
    from crt_tpu_torch.scene.procedural import make_test_scene

    opaque = make_test_scene(**BENCH, device=device)
    glass = make_test_scene(**GLASS, device=device)
    compact = RenderSettings(compact_bounces=True)
    frames = (("opaque forward", lambda: render_image(opaque)),
              ("opaque forward+backward", lambda: image_sum_grads(opaque)),
              ("glass scan forward", lambda: render_image(glass)),
              ("glass scan forward, compact_bounces",
               lambda: render_image(glass, compact)))
    tags = {"K1": "closest_hit_kernel", "K2": "occlusion_w",
            "K3": "segment_accumulate", "K4": "closest_hit_compact_kernel",
            "K4 list": "live_tiles_kernel"}
    for name, fn in frames:
        fn()
        torch.cuda.synchronize()
        for who in ("parent", "new", "new", "parent"):
            lib = parent if who == "parent" else None
            dev_ms, n, by_tag = on(lib, lambda: profile_frame(
                fn, tags=tuple(tags.values())))
            print(f"[turns] {name}, {who} kernels: device {dev_ms:.3f} ms in "
                  f"{n} launches; " + ", ".join(
                      f"{k} {by_tag[v]:.3f} ms" for k, v in tags.items()
                      if by_tag[v] > 0))


def reset_launches():
    from crt_tpu_torch.ops import (
        cluster_trace, segsum, shade, stream_binning, stream_trace,
    )

    cluster_trace.closest_hit_launches = 0
    cluster_trace.closest_hit_compact_launches = 0
    cluster_trace.live_tiles_launches = 0
    cluster_trace.closest_hit_merged_launches = 0
    cluster_trace.occlusion_w_launches = 0
    for mode in cluster_trace.occlusion_w_mode_launches:
        cluster_trace.occlusion_w_mode_launches[mode] = 0
    cluster_trace.occlusion_d_launches = 0
    for mode in cluster_trace.occlusion_d_mode_launches:
        cluster_trace.occlusion_d_mode_launches[mode] = 0
    stream_trace.closest_hit_stream_launches = 0
    stream_trace.occlusion_stream_launches = 0
    for counts in (stream_trace.closest_hit_stream_layout_launches,
                   stream_trace.occlusion_stream_layout_launches):
        for layout in counts:
            counts[layout] = 0
    stream_binning.stream_host_syncs = 0
    stream_binning.stream_pairs = 0
    segsum.segsum_launches = 0
    shade.march_host_syncs = 0
    shade.march_traces = 0


def read_launches() -> dict:
    """Launch counts of the three kernels of the opaque frame."""
    from crt_tpu_torch.ops import cluster_trace, segsum

    return {"closest_hit": cluster_trace.closest_hit_launches,
            "occlusion_w": cluster_trace.occlusion_w_launches,
            "segsum": segsum.segsum_launches}


def read_stream_launches() -> dict:
    """Launch counts of every trace kernel and the segment sum, with the
    streaming Phase A's own counts (pairs listed, device-to-host reads)."""
    from crt_tpu_torch.ops import (
        cluster_trace, segsum, stream_binning, stream_trace,
    )

    return {"closest_hit": cluster_trace.closest_hit_launches,
            "closest_hit_compact": cluster_trace.closest_hit_compact_launches,
            "occlusion_w": cluster_trace.occlusion_w_launches,
            "occlusion_d": cluster_trace.occlusion_d_mode_launches["compact"],
            "occlusion_d_exit": cluster_trace.occlusion_d_mode_launches["exit"],
            "closest_hit_stream": stream_trace.closest_hit_stream_launches,
            "occlusion_stream": stream_trace.occlusion_stream_launches,
            "segsum": segsum.segsum_launches,
            "stream_pairs": stream_binning.stream_pairs,
            "stream_host_syncs": stream_binning.stream_host_syncs}


def read_glass_launches() -> dict:
    """Launch counts of the refractive frame's kernels, K2 by mode, and
    the march's own counts (closest-hit segments, device-to-host reads)."""
    from crt_tpu_torch.ops import cluster_trace, segsum, shade

    modes = cluster_trace.occlusion_w_mode_launches
    return {"closest_hit": cluster_trace.closest_hit_launches,
            "closest_hit_compact": cluster_trace.closest_hit_compact_launches,
            "live_tiles": cluster_trace.live_tiles_launches,
            "occlusion_w": modes["capped"],
            "occlusion_w_glass": modes["glass"],
            "occlusion_w_uncapped": modes["uncapped"],
            "segsum": segsum.segsum_launches,
            "march_traces": shade.march_traces,
            "march_host_syncs": shade.march_host_syncs}


def phase_main_path(device):
    from crt_tpu_torch import RenderSettings, render_image
    from crt_tpu_torch.frontend import cli
    from crt_tpu_torch.scene.procedural import (
        make_test_scene, make_test_scene_dict,
    )

    with tempfile.TemporaryDirectory() as tmp:
        scene_path = os.path.join(tmp, "bench.crtscene")
        out_path = os.path.join(tmp, "bench.ppm")
        with open(scene_path, "w") as f:
            json.dump(make_test_scene_dict(**BENCH), f)
        reset_launches()
        rc = cli.main([scene_path, out_path, "--device", str(device)])
        launches = read_launches()
        check(rc == 0, f"CLI exited {rc}")
        with open(out_path) as f:
            tokens = f.read().split()
    W, H = BENCH["width"], BENCH["height"]
    check(tokens[:4] == ["P3", str(W), str(H), "255"],
          f"bad PPM header {tokens[:4]}")
    check(len(tokens) == 4 + W * H * 3, "PPM has the wrong number of values")
    print(f"[main] CLI wrote a {W}x{H} P3 image; kernel launches {launches}")
    check(launches == {"closest_hit": 4, "occlusion_w": 4, "segsum": 0},
          f"the forward path launched {launches}, expected 4, 4 and 0")

    scene = make_test_scene(**BENCH, device=device)
    img = render_image(scene, RenderSettings(backend="auto"))
    ref = render_image(scene, RenderSettings(backend="bruteforce"))
    check(tuple(img.shape) == (H, W, 3) and bool(torch.isfinite(img).all()),
          "image is not a finite [H, W, 3]")
    close = ((img - ref).abs() <= 1e-5 + 1e-4 * ref.abs()).all(dim=-1)
    frac = float(close.float().mean())
    print(f"[main] cluster vs bruteforce on the card: max |diff| "
          f"{float((img - ref).abs().max()):.3e}, {int((~close).sum())} px "
          f"outside rtol 1e-4 / atol 1e-5 ({frac * 100:.4f} % inside)")
    check(frac >= 0.9999, "fewer than 99.99 % of pixels agree with bruteforce")

    small = make_test_scene(64, 36, num_quads=12, device="cpu")
    cpu_img = render_image(small)
    gpu_img = render_image(small.to(device)).cpu()
    diff = float((cpu_img - gpu_img).abs().max())
    print(f"[main] small scene, card vs CPU plain path: max |diff| {diff:.3e}")
    check(torch.allclose(gpu_img, cpu_img, rtol=1e-5, atol=1e-6),
          "small-scene render on the card disagrees with the CPU render")

    ms = cuda_ms(lambda: render_image(scene), warmup=2, reps=5)
    ms_bf = cuda_ms(lambda: render_image(
        scene, RenderSettings(backend="bruteforce")), warmup=1, reps=5)
    print(f"[main] forward frame {ms:.3f} ms = {W * H / ms / 1e3:.3f} Mrays/s "
          f"(bruteforce backend {ms_bf:.3f} ms)")
    return launches


def phase_variants(device):
    """K7 on the opaque bench frame's primary and mirror-bounce wavefronts
    at merge 2 and 4, then the CLI frame with CRT_TILE_MERGE=2."""
    from crt_tpu_torch import render_image
    from crt_tpu_torch.frontend import cli
    from crt_tpu_torch.ops import cluster_trace as ct
    from crt_tpu_torch.ops.binning import bin_rays
    from crt_tpu_torch.ops.cluster_tables import (
        build_cluster_tables, emit_rows_table,
    )
    from crt_tpu_torch.scene.procedural import (
        make_test_scene, make_test_scene_dict,
    )
    from crt_tpu_torch.scene.types import RenderSettings

    scene = make_test_scene(**BENCH, device=device)
    tables = build_cluster_tables(scene)
    rows_table = emit_rows_table(scene, tables)
    o, d = primary_wavefront(scene)
    act = torch.ones(o.shape[0], dtype=torch.bool, device=device)
    cl, cnt = bin_rays(tables, o, d, TILE, act)
    k1 = ct.closest_hit(tables, o, d, cl, cnt, rows_table)
    ro, rd, ract = mirror_bounce(scene, RenderSettings(), o, d, k1)
    bcl, bcnt = bin_rays(tables, ro, rd, TILE, ract)
    waves = {"primary": (o, d, cl, cnt), "bounce": (ro, rd, bcl, bcnt)}
    err, ms = 0.0, {}
    for name, args in waves.items():
        one = ct.closest_hit(tables, *args, rows_table)
        for merge in (2, 4):
            k = ct.closest_hit_merged(tables, *args, rows_table, merge=merge)
            p = ct.closest_hit_merged_plain(tables, *args, rows_table, merge)
            err = max(err, compare_hits(f"closest_hit_merged {name} merge "
                                        f"{merge}", k, p))
            compare_hits(f"closest_hit_merged {name} merge {merge} vs "
                         "closest_hit", k, one)
        # in turns: K1, K7 at 2, K7 at 4, and K1 again
        ms[name, 1] = cuda_ms(lambda: ct.closest_hit(tables, *args,
                                                     rows_table))
        for merge in (2, 4):
            ms[name, merge] = cuda_ms(lambda: ct.closest_hit_merged(
                tables, *args, rows_table, merge=merge))
        ms[name, "k1_again"] = cuda_ms(lambda: ct.closest_hit(
            tables, *args, rows_table))
    ms_plain = cuda_ms(lambda: ct.closest_hit_merged_plain(
        tables, o, d, cl, cnt, rows_table, 2))
    b = walk_bound(tables, cl, cnt, (o, d), k1, act.reshape(-1, TILE),
                   rows_table=rows_table)
    bb = walk_bound(tables, bcl, bcnt, (ro, rd), k1, ract.reshape(-1, TILE),
                    rows_table=rows_table)
    for name, bound, c in (("primary", b, cnt), ("bounce", bb, bcnt)):
        print(f"[variants] {name} ({c.shape[0]} tiles, {int((c > 0).sum())} "
              f"live, {int(c.sum())} walked entries): K7 == plain == K1 bit "
              f"for bit at merge 2 and 4; K1 {ms[name, 1]:.3f} ms (again "
              f"{ms[name, 'k1_again']:.3f}), K7 merge 2 {ms[name, 2]:.3f} ms, "
              f"merge 4 {ms[name, 4]:.3f} ms; bound {bound['bound_ms']:.4f} "
              f"ms ({bound['bound_by']}), library call none")
    print(f"[variants] K7 plain version (merge 2, primary): {ms_plain:.3f} ms")

    # the CLI frame: in process with the default K1, in a child with the
    # merge (crt_tpu and the port read CRT_TILE_MERGE when imported)
    with tempfile.TemporaryDirectory() as tmp:
        scene_path = os.path.join(tmp, "bench.crtscene")
        with open(scene_path, "w") as f:
            json.dump(make_test_scene_dict(**BENCH), f)
        default_ppm = os.path.join(tmp, "default.ppm")
        merged_ppm = os.path.join(tmp, "merged.ppm")
        reset_launches()
        rc = cli.main([scene_path, default_ppm, "--device", str(device)])
        default_counts = read_launches()
        counts = cli_child([scene_path, merged_ppm, "--device", str(device)],
                           {"CRT_TILE_MERGE": "2"})
        with open(default_ppm) as f1, open(merged_ppm) as f2:
            same = f1.read() == f2.read()
    print(f"[variants] CLI default frame: launches {default_counts}; CLI "
          f"with CRT_TILE_MERGE=2 (child): launches {counts}")
    check(rc == 0 and default_counts["closest_hit"] == 4,
          f"the default CLI frame launched {default_counts}")
    check(counts["closest_hit_merged"] == 4 and counts["closest_hit"] == 0
          and counts["occlusion_w"] == 4,
          f"the CRT_TILE_MERGE=2 frame launched {counts}: expected 4 K7, no "
          "K1 and 4 shadow passes")
    check(same, "the CRT_TILE_MERGE=2 PPM differs from the default frame's")
    default = render_image(scene)
    saved = ct._TILE_MERGE
    ct._TILE_MERGE = 2
    try:
        merged = render_image(scene)
    finally:
        ct._TILE_MERGE = saved
    check(torch.equal(merged, default), "the merged frame's floats differ "
          "from the default frame's")
    print("[variants] the CRT_TILE_MERGE=2 PPM equals the default frame's "
          "byte for byte, and in process the float images are bit-equal")
    stats = dict(max_abs_err=err, ms=ms["primary", 2], plain_ms=ms_plain,
                 library_ms=None, ms_merge4=ms["primary", 4],
                 ms_bounce=ms["bounce", 2], k1_ms=ms["primary", 1],
                 **{k: b[k] for k in ("bound_ms", "bound_by")})
    return {"closest_hit_merged": stats}, counts["closest_hit_merged"]


def assert_grads_close(name, got, want, rtol, atol_scale):
    for k in want:
        check(bool(torch.isfinite(got[k]).all()), f"{name}: {k} not finite")
        a, b = got[k].detach().cpu().double(), want[k].detach().cpu().double()
        scale = float(b.abs().max())
        diff = (a - b).abs()
        print(f"[train] {name}: d/d{k} max |diff| {float(diff.max()):.3e} "
              f"(largest entry {scale:.3e})")
        check(bool((diff <= atol_scale * scale + rtol * b.abs()).all()),
              f"{name}: d/d{k} differs beyond rtol {rtol} / atol "
              f"{atol_scale} of the largest entry")


def phase_train(device):
    from crt_tpu_torch import RenderSettings, fit_scene, render_image
    from crt_tpu_torch.scene.procedural import make_test_scene

    W, H = BENCH["width"], BENCH["height"]
    scene = make_test_scene(**BENCH, device=device)

    # the training half of the main path, through the kernels
    reset_launches()
    value, grads = image_sum_grads(scene)
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"[train] value_and_grad of the {W}x{H} image sum: value "
          f"{float(value):.6e}; kernel launches {launches}")
    check(launches == {"closest_hit": 4, "occlusion_w": 4, "segsum": 4},
          f"the training path launched {launches}, expected 4, 4 and 4")
    for k, gk in grads.items():
        check(tuple(gk.shape) == tuple(getattr(scene, k).shape)
              and bool(torch.isfinite(gk).all()) and bool(gk.abs().max() > 0),
              f"d/d{k} is not a finite non-zero "
              f"{tuple(getattr(scene, k).shape)}")

    _, ref = image_sum_grads(scene, RenderSettings(backend="bruteforce"))
    assert_grads_close("cluster vs bruteforce backend", grads, ref,
                       rtol=1e-3, atol_scale=1e-4)

    groups = TRAINED + ("light_position", "tex_color_a", "cam_rotation")
    small = make_test_scene(64, 36, num_quads=12, device="cpu")
    _, cpu_grads = image_sum_grads(small, keys=groups)
    _, gpu_grads = image_sum_grads(small.to(device), keys=groups)
    assert_grads_close("small scene, card vs CPU", gpu_grads, cpu_grads,
                       rtol=1e-4, atol_scale=2e-4)

    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: image_sum_grads(scene), warmup=2, reps=5)
    peak = torch.cuda.max_memory_allocated()
    ms_fwd = cuda_ms(lambda: render_image(scene), warmup=1, reps=5)
    print(f"[train] forward+backward frame {ms:.3f} ms = "
          f"{W * H / ms / 1e3:.3f} Mrays/s (forward alone {ms_fwd:.3f} ms); "
          f"peak memory allocated {peak / 2**30:.3f} GiB")

    # fit_scene: three Adam steps back toward the scene's own clean render
    target = render_image(scene)
    gen = torch.Generator(device="cpu").manual_seed(0)

    def noise(t):
        return torch.randn(tuple(t.shape), generator=gen).to(device)

    start = {
        "tex_color_a": (scene.tex_color_a + 0.2 * noise(scene.tex_color_a)
                        ).clamp(0.05, 1.0),
        "light_intensity": scene.light_intensity * 0.8,
        "vertices": scene.vertices + 0.02 * noise(scene.vertices),
    }
    stamps = []

    def on_step(i, loss):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reset_launches()
    params, losses = fit_scene(scene, target, params=start, steps=3,
                               callback=on_step)
    fit_launches = read_launches()
    step_ms = [(b - a) * 1e3 for a, b in zip([t0] + stamps, stamps)]
    print(f"[train] fit_scene, 3 Adam steps: losses "
          f"{[f'{x:.6e}' for x in losses]}; step ms "
          f"{[f'{x:.1f}' for x in step_ms]}; kernel launches {fit_launches}")
    check(len(losses) == 3 and losses[0] > losses[1] > losses[2] > 0,
          f"fit_scene's loss did not fall at every step: {losses}")
    # per step: 4 traces, 4 shadow passes, and the segment sum as the
    # backward of 4 packed-row reads and 4 texture-colour reads
    check(fit_launches == {"closest_hit": 12, "occlusion_w": 12,
                           "segsum": 24},
          f"fit_scene launched {fit_launches}, expected 12, 12 and 24")
    check(all(bool(torch.isfinite(v).all()) for v in params.values()),
          "fit_scene returned non-finite parameters")
    return launches


GLASS = dict(BENCH, with_refractive=True)
GLASS_TRAINED = TRAINED + ("mat_ior",)


def record_glass_frame(scene):
    """The kernel inputs of one real frame of the iterative wavefront, in
    call order: ``traces`` (o, d, act) of each bounce's pool trace,
    ``shadows`` (point, shadow_o, lights, act [Ll, B*R], slack) of each
    bounce's glass-flag pass at pool width, ``march`` (o, d, act) of every
    segment of the bend-walk."""
    from crt_tpu_torch import RenderSettings
    from crt_tpu_torch.ops.shade_iter import (
        default_banks, shade_wavefront_iter,
    )
    from crt_tpu_torch.renderer import make_trace_fn

    st = RenderSettings()
    trace = make_trace_fn(scene, st)
    o, d = primary_wavefront(scene)
    width = default_banks(scene, st) * o.shape[0]
    rec = {"traces": [], "shadows": [], "march": []}

    def recording(ro, rd, active=None):
        rec["traces" if ro.shape[0] == width else "march"].append(
            (ro.detach().contiguous(), rd.detach().contiguous(),
             active.detach().clone()))
        return trace(ro, rd, active)

    def recording_glass(point, shadow_o, lights, act, slack):
        rec["shadows"].append((point.detach().contiguous(),
                               shadow_o.detach().contiguous(),
                               lights.detach().contiguous(),
                               act.detach().clone(), slack))
        return trace.shadow_apex_w_glass(point, shadow_o, lights, act, slack)

    recording.shadow_apex_w = trace.shadow_apex_w
    recording.shadow_apex_w_glass = recording_glass
    recording.rank = trace.rank
    with torch.no_grad():
        shade_wavefront_iter(scene, st, recording, o, d)
    bounces = st.max_ray_depth + 1
    check(len(rec["traces"]) == bounces and len(rec["shadows"]) == bounces
          and all(c[0].shape[0] == width for c in rec["shadows"]),
          f"{len(rec['traces'])} pool traces and {len(rec['shadows'])} "
          "pool-width glass-flag passes in a frame, expected one of each "
          "per bounce")
    check(len(rec["march"]) > 0, "the frame marched no shadow lane")
    return rec


def phase_glass_kernels(device):
    from crt_tpu_torch.ops.binning import bin_apex_shared, bin_rays
    from crt_tpu_torch.ops.cluster_tables import (
        build_cluster_tables, glass_subset,
    )
    from crt_tpu_torch.ops.cluster_trace import (
        closest_hit, closest_hit_compact, closest_hit_compact_plain,
        closest_hit_plain, occlusion_w, occlusion_w_plain,
    )
    from crt_tpu_torch.ops.intersect import Hit
    from crt_tpu_torch.scene.procedural import make_test_scene
    from crt_tpu_torch.scene.types import RenderSettings

    scene = make_test_scene(**GLASS, device=device)
    st = RenderSettings()
    tables = build_cluster_tables(scene)
    gm, gmin, gmax = glass_subset(scene, tables)
    o, d = primary_wavefront(scene)
    cl, cnt = bin_rays(tables, o, d, TILE)
    t, tri, _ = closest_hit(tables, o, d, cl, cnt)
    print(f"[glass] refractive bench scene: {scene.num_triangles} triangles "
          f"({int(gm.sum())} refractive) in {tables.n.shape[0]} clusters")

    w = depth0_shadow_wavefront(scene, st, o, d, Hit(t=t, tri=tri))
    point, shadow_o, lights, act_lr = (w["point"], w["shadow_o"], w["lights"],
                                       w["act"])
    slack = 2.0 * st.shadow_bias
    rays = (shadow_o, point, lights)
    stats = {}

    def glass_mode(name, point, shadow_o, lights, act_lr, slack):
        """K2's glass-flag mode vs its plain version on one shadow
        wavefront, lane for lane, both outputs; times and bound."""
        rays = (shadow_o, point)
        gcl, gcnt = bin_apex_shared(tables, shadow_o, lights, act_lr, TILE,
                                    slack, glass_boxes=(gmin, gmax))
        args = (tables, shadow_o, point, lights, gcl, gcnt)
        kw = dict(member_mask=gm, glass_flag=True)
        ko, kg = occlusion_w(*args, **kw)
        po, pg = occlusion_w_plain(*args, **kw)
        n_bad = int(((ko != po) | (kg != pg)).sum())
        check(n_bad == 0, f"occlusion_w glass mode, {name}: {n_bad} lanes "
              "differ from the plain version")
        ms = cuda_ms(lambda: occlusion_w(*args, **kw))
        ms_p = cuda_ms(lambda: occlusion_w_plain(*args, **kw), warmup=1,
                       reps=3)
        # a lane may leave the walk only once it is blocked and flagged
        b = walk_bound(tables, gcl, gcnt, rays, (ko, kg),
                       act_lr.reshape(-1, TILE),
                       blocked=(ko & kg).reshape(-1, TILE), small=(lights, gm))
        tests, ray_bytes = b.pop("member_tests"), b.pop("ray_bytes")
        routed = act_lr.reshape(-1) & kg
        print(f"[glass] occlusion_w glass mode, {name}: {ko.numel()} lanes in "
              f"{gcnt.numel()} tiles ({int((gcnt > 0).sum())} live, "
              f"{int(gcnt.sum())} walked entries), {int(ko.sum())} blocked, "
              f"{int(kg.sum())} flagged ({int(routed.sum())} of "
              f"{int(act_lr.sum())} active lanes routed to the march), both "
              f"outputs equal; kernel {ms:.3f} ms, plain {ms_p:.3f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}, {tests} member "
              f"tests, {ray_bytes} ray bytes needed)")
        return dict(max_abs_err=0.0, ms=ms, plain_ms=ms_p, library_ms=None,
                    **b), kg

    _, kg = glass_mode("depth-0 wavefront", point, shadow_o, lights, act_lr,
                       slack)

    ucl, ucnt = bin_apex_shared(tables, shadow_o, lights, act_lr, TILE, slack,
                                boxes=(gmin, gmax), capped=False)
    kw = dict(capped=False, member_mask=gm)
    ku = occlusion_w(tables, *rays, ucl, ucnt, **kw)
    pu = occlusion_w_plain(tables, *rays, ucl, ucnt, **kw)
    n_bad = int((ku != pu).sum())
    check(n_bad == 0, f"occlusion_w uncapped masked mode: {n_bad} lanes "
          "differ from the plain version")
    act = act_lr.reshape(-1)
    check(bool(((ku & act) == (kg & act)).all()),
          "the uncapped gate and the router's glass flag disagree on an "
          "active lane")
    ms = cuda_ms(lambda: occlusion_w(tables, *rays, ucl, ucnt, **kw))
    ms_p = cuda_ms(lambda: occlusion_w_plain(tables, *rays, ucl, ucnt, **kw),
                   warmup=1, reps=3)
    b = walk_bound(tables, ucl, ucnt, (shadow_o, point), (ku,),
                   act_lr.reshape(-1, TILE), blocked=ku.reshape(-1, TILE),
                   small=(lights, gm))
    tests, ray_bytes = b.pop("member_tests"), b.pop("ray_bytes")
    print(f"[glass] occlusion_w uncapped member-masked mode: "
          f"{int((ucnt > 0).sum())} live tiles, {int(ucnt.sum())} walked "
          f"entries, {int(ku.sum())} lanes hit, equal, and equal to the glass "
          f"flag on the active lanes; kernel {ms:.3f} ms, plain {ms_p:.3f} "
          f"ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}, {tests} "
          f"member tests, {ray_bytes} ray bytes needed)")
    stats["occlusion_w_uncapped"] = dict(max_abs_err=0.0, ms=ms,
                                         plain_ms=ms_p, library_ms=None, **b)

    # one real frame's kernel inputs, at the main path's own shapes
    rec = record_glass_frame(scene)

    # the second bounce's glass-flag pass: the 8-bank pool under 2 lights
    stats["occlusion_w_glass"], _ = glass_mode("bounce-1 pool",
                                               *rec["shadows"][1])

    # the second bounce's pool trace: 8 banks, most lanes dead
    po_, pd_, pact = rec["traces"][1]
    pcl, pcnt = bin_rays(tables, po_, pd_, TILE, pact)
    k4 = closest_hit_compact(tables, po_, pd_, pcl, pcnt)
    k1 = closest_hit(tables, po_, pd_, pcl, pcnt)
    p4 = closest_hit_compact_plain(tables, po_, pd_, pcl, pcnt)
    p1 = closest_hit_plain(tables, po_, pd_, pcl, pcnt)
    err = compare_hits("closest_hit_compact vs plain", k4, p4)
    compare_hits("closest_hit_compact vs closest_hit", k4, k1)
    compare_hits("closest_hit on the pool vs plain", k1, p1)
    del p1
    def k4_call():
        return closest_hit_compact(tables, po_, pd_, pcl, pcnt)

    def k1_call():
        return closest_hit(tables, po_, pd_, pcl, pcnt)

    ms, ms_1 = cuda_ms(k4_call), cuda_ms(k1_call)
    many, many_1 = cuda_ms_many(k4_call), cuda_ms_many(k1_call)
    dev, dev_1 = device_ms(k4_call), device_ms(k1_call)
    ms_p = cuda_ms(lambda: closest_hit_compact_plain(tables, po_, pd_, pcl,
                                                     pcnt), warmup=1, reps=3)
    # the tile list and the live count are written and read by the launch
    perm = torch.empty((pcnt.numel() + 1,), dtype=torch.int32, device=device)
    b = walk_bound(tables, pcl, pcnt, (po_, pd_), k4[:2],
                   pact.reshape(-1, TILE), small=(perm,))
    tests, ray_bytes = b.pop("member_tests"), b.pop("ray_bytes")
    print(f"[glass] closest_hit_compact on the bounce-1 pool: "
          f"{po_.shape[0]} lanes in {pcnt.numel()} tiles "
          f"({int((pcnt > 0).sum())} live, {int(pact.sum())} active lanes, "
          f"{int(pcnt.sum())} walked entries), bit-equal to its plain version "
          f"and to closest_hit, which equals its own plain version there; "
          f"kernel {ms:.3f} ms a single launch, {many:.4f} ms in 10 back "
          f"to back, device time {dev:.4f} ms; closest_hit on the same lists "
          f"{ms_1:.3f}, {many_1:.4f}, {dev_1:.4f} ms; plain {ms_p:.3f} ms, "
          f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}, {tests} member "
          f"tests, {ray_bytes} ray bytes needed)")
    stats["closest_hit_compact"] = dict(
        max_abs_err=err, ms=ms, ms_many=many, device_ms=dev,
        ms_closest_hit=ms_1, ms_many_closest_hit=many_1,
        device_ms_closest_hit=dev_1, plain_ms=ms_p, library_ms=None, **b)

    # the widest segment of the bend-walk: the live 1024-lane blocks
    mo, md, mact = max(rec["march"], key=lambda c: int(c[2].sum()))
    check(mo.shape[0] % TILE == 0, "a march wavefront is not whole tiles")
    mcl, mcnt = bin_rays(tables, mo, md, TILE, mact)
    compare_hits("closest_hit on a march segment vs plain",
                 closest_hit(tables, mo, md, mcl, mcnt),
                 closest_hit_plain(tables, mo, md, mcl, mcnt))
    print(f"[glass] closest_hit on the widest of {len(rec['march'])} march "
          f"segments: {mo.shape[0]} lanes in {mcnt.numel()} tiles "
          f"({int(mact.sum())} marching), bit-equal to its plain version")
    return stats


def profile_frame(fn, top=0, tag="[refract]",
                  tags=("closest_hit", "occlusion_w")):
    """(device kernel ms, device launches, ms by tag) of one call of fn();
    prints the ``top`` largest device kernels and the share of the
    hand-written kernels whose names contain one of ``tags``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    rows = [ev for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA]
    us = sum(dev_us(ev) for ev in rows)
    check(us > 0, "the profiler recorded no device time")
    by_tag = {}
    for name in tags:
        mine = [ev for ev in rows if name in ev.key]
        by_tag[name] = sum(dev_us(ev) for ev in mine) / 1e3
        if top:
            print(f"{tag}   {name}: {by_tag[name]:.3f} ms over "
                  f"{sum(ev.count for ev in mine)} launches "
                  f"({100 * by_tag[name] * 1e3 / us:.2f} % of device time)")
    if top:
        for ev in sorted(rows, key=dev_us, reverse=True)[:top]:
            print(f"{tag}   {dev_us(ev) / 1e3:9.3f} ms  {ev.count:6d} x  "
                  f"{ev.key[:90]}")
    return us / 1e3, sum(ev.count for ev in rows), by_tag


def host_ms(fn, warmup=1, reps=5):
    """Median (wall ms, enqueue ms) of fn() on the host clock; the wall
    ends in a synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    walls, enqueues = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        enqueues.append((t1 - t0) * 1e3)
    return statistics.median(walls), statistics.median(enqueues)


def phase_refract(device):
    from crt_tpu_torch import RenderSettings, render_image
    from crt_tpu_torch.frontend import cli
    from crt_tpu_torch.ops.shade_iter import default_banks
    from crt_tpu_torch.renderer import make_trace_fn
    from crt_tpu_torch.scene.procedural import (
        make_test_scene, make_test_scene_dict,
    )

    W, H = GLASS["width"], GLASS["height"]
    with tempfile.TemporaryDirectory() as tmp:
        scene_path = os.path.join(tmp, "glass.crtscene")
        out_path = os.path.join(tmp, "glass.ppm")
        with open(scene_path, "w") as f:
            json.dump(make_test_scene_dict(**GLASS), f)
        reset_launches()
        rc = cli.main([scene_path, out_path, "--device", str(device)])
        launches = read_glass_launches()
        check(rc == 0, f"CLI exited {rc}")
        with open(out_path) as f:
            tokens = f.read().split()
    check(tokens[:4] == ["P3", str(W), str(H), "255"]
          and len(tokens) == 4 + W * H * 3, "bad PPM of the glass frame")
    scene = make_test_scene(**GLASS, device=device)
    st = RenderSettings()
    bounces = st.max_ray_depth + 1
    print(f"[refract] CLI wrote the {W}x{H} glass frame "
          f"({default_banks(scene, st)} banks, {bounces} bounces); launches "
          f"{launches}")
    # per bounce one pool trace and one glass-flag pass; the march adds one
    # closest hit per segment it walked, between none and depth + 1 a pass
    check(launches["occlusion_w_glass"] == bounces
          and launches["closest_hit"] == bounces + launches["march_traces"]
          and 0 < launches["march_traces"] <= bounces * bounces
          and launches["occlusion_w"] == 0
          and launches["occlusion_w_uncapped"] == 0
          and launches["closest_hit_compact"] == 0
          and launches["segsum"] == 0,
          f"the glass frame launched {launches}: not what the scan schedule "
          "implies")

    img = render_image(scene)
    reset_launches()
    compact = render_image(scene, RenderSettings(compact_bounces=True))
    c_launches = read_glass_launches()
    check(torch.equal(compact, img),
          "compact_bounces=True changed the image")
    check(c_launches["closest_hit"] == 0
          and c_launches["closest_hit_compact"] == launches["closest_hit"]
          and c_launches["live_tiles"] == c_launches["closest_hit_compact"]
          and c_launches["occlusion_w_glass"] == bounces,
          f"compact_bounces launched {c_launches}")
    print(f"[refract] compact_bounces=True: image bit-equal, every trace a "
          f"compacted launch: {c_launches}")

    # the router's flag vs the separate uncapped gate, through the factory
    trace = make_trace_fn(scene, st)
    o, d = primary_wavefront(scene)
    hit = trace(o, d)
    point = o + d * torch.where(hit.valid, hit.t, 0.0)[:, None]
    shadow_o = point + st.shadow_bias * torch.tensor([0.0, 1.0, 0.0],
                                                     device=device)
    act = hit.valid[None].expand(scene.num_lights, -1)
    reset_launches()
    _, flag = trace.shadow_apex_w_glass(point, shadow_o, scene.light_position,
                                        act, 2.0 * st.shadow_bias)
    gate = trace.refr_ray_hit_w(point, shadow_o, scene.light_position, act,
                                2.0 * st.shadow_bias)
    gate_launches = read_glass_launches()
    check(torch.equal(flag & act, gate & act),
          "router flag and uncapped gate disagree")
    print(f"[refract] router cross-check through the trace factory: "
          f"{int((flag & act).sum())} of {int(act.sum())} lanes flagged by "
          f"both routes; launches glass {gate_launches['occlusion_w_glass']}, "
          f"uncapped {gate_launches['occlusion_w_uncapped']}")

    ref = render_image(scene, RenderSettings(backend="bruteforce"))
    check(tuple(img.shape) == (H, W, 3) and bool(torch.isfinite(img).all()),
          "glass image is not a finite [H, W, 3]")
    close = ((img - ref).abs() <= 1e-5 + 1e-4 * ref.abs()).all(dim=-1)
    frac = float(close.float().mean())
    print(f"[refract] cluster vs bruteforce on the card: max |diff| "
          f"{float((img - ref).abs().max()):.3e}, {int((~close).sum())} px "
          f"outside rtol 1e-4 / atol 1e-5 ({frac * 100:.4f} % inside)")
    check(frac >= 0.9999, "fewer than 99.99 % of glass pixels agree with "
          "the bruteforce backend")
    del ref, compact

    small = make_test_scene(96, 64, num_quads=8, with_refractive=True,
                            device="cpu")
    for kw in (dict(), dict(wavefront_sched="grow"),
               dict(wavefront="recursive")):
        cpu_img = render_image(small, RenderSettings(**kw))
        gpu_img = render_image(small.to(device), RenderSettings(**kw)).cpu()
        diff = float((cpu_img - gpu_img).abs().max())
        print(f"[refract] small glass scene {kw or 'default'}, card vs CPU: "
              f"max |diff| {diff:.3e}")
        check(torch.allclose(gpu_img, cpu_img, rtol=1e-5, atol=1e-6),
              f"small glass scene {kw} on the card disagrees with the CPU")

    variants = (("scan", RenderSettings()),
                ("grow", RenderSettings(wavefront_sched="grow")),
                ("scan + compact_bounces",
                 RenderSettings(compact_bounces=True)),
                ("recursive", RenderSettings(wavefront="recursive")),
                ("scan in 8 chunks", RenderSettings(chunk_pixels=1 << 18)))
    for name, vst in variants:
        torch.cuda.reset_peak_memory_stats()
        wall, enq = host_ms(lambda: render_image(scene, vst))
        peak = torch.cuda.max_memory_allocated() / 2**30
        reset_launches()
        dev_ms, dev_launches, _ = profile_frame(
            lambda: render_image(scene, vst), top=8 if name == "scan" else 0)
        n = read_glass_launches()
        print(f"[refract] forward frame, {name}: {wall:.3f} ms = "
              f"{W * H / wall / 1e3:.3f} Mrays/s (host enqueue {enq:.3f} "
              f"ms); profiled frame: device kernels {dev_ms:.3f} ms in "
              f"{dev_launches} launches; closest hits "
              f"{n['closest_hit'] + n['closest_hit_compact']}, glass passes "
              f"{n['occlusion_w_glass']}, host syncs "
              f"{n['march_host_syncs']}; peak {peak:.3f} GiB")

    # gradients through refraction
    reset_launches()
    value, grads = image_sum_grads(scene, keys=GLASS_TRAINED)
    torch.cuda.synchronize()
    g_launches = read_glass_launches()
    print(f"[refract] value_and_grad of the glass image sum: value "
          f"{float(value):.6e}; launches {g_launches}")
    # per bounce the packed rows and the ior row of build_packed
    check(g_launches["segsum"] == 2 * bounces
          and g_launches["occlusion_w_glass"] == bounces,
          f"the glass backward launched {g_launches}")
    for k, gk in grads.items():
        check(bool(torch.isfinite(gk).all()) and bool(gk.abs().max() > 0),
              f"glass d/d{k} is not finite and non-zero")
    _, ref_grads = image_sum_grads(scene, RenderSettings(backend="bruteforce"),
                                   keys=GLASS_TRAINED)
    assert_grads_close("glass, cluster vs bruteforce backend", grads,
                       ref_grads, rtol=1e-3, atol_scale=1e-4)
    del ref_grads
    for name, vst in (("scan", RenderSettings()),
                      ("scan + remat_shading",
                       RenderSettings(remat_shading=True)),
                      ("grow", RenderSettings(wavefront_sched="grow"))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        wall, enq = host_ms(
            lambda: image_sum_grads(scene, vst, keys=GLASS_TRAINED), reps=3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"[refract] forward+backward frame, {name}: {wall:.3f} ms = "
              f"{W * H / wall / 1e3:.3f} Mrays/s (host enqueue {enq:.3f} "
              f"ms); peak {peak:.3f} GiB")
    _, remat = image_sum_grads(scene, RenderSettings(remat_shading=True),
                               keys=GLASS_TRAINED)
    assert_grads_close("glass, remat_shading vs not", remat, grads,
                       rtol=1e-4, atol_scale=1e-5)

    # the small-table gather that feeds refraction, 65,536 triangles on one
    # material: build_packed's read through packed_gather (its backward the
    # segment sum), and plain indexing (an index_put_ accumulate) beside it
    from crt_tpu_torch.ops.segsum import packed_gather

    ior = torch.ones((3,), device=device, requires_grad=True)
    mat = torch.zeros((65536,), dtype=torch.long, device=device)

    def ior_gather(read):
        def run():
            ior.grad = None
            read().sum().backward()
        return run

    ms_new = cuda_ms(ior_gather(lambda: packed_gather(ior[None, :], mat)))
    ms_old = cuda_ms(ior_gather(lambda: ior[mat]))
    print(f"[refract] mat_ior[tri_material] at 65,536 triangles on one "
          f"material, forward+backward: through packed_gather (as "
          f"build_packed reads it) {ms_new:.3f} ms, by plain indexing "
          f"{ms_old:.3f} ms")
    return launches, c_launches


BIG = dict(num_triangles=1_000_000, width=1920, height=1080)
MID = dict(BIG, num_triangles=65536)


def depth0_shadow_wavefront(scene, settings, o, d, hit, kernel_rows=None):
    """The depth-0 shadow wavefront of a frame, as ``_occlusion_masks``
    builds it: point, shadow_o [R, 3]; lights [Ll, 3]; ldir [Ll, R, 3]; r2,
    act [Ll, R] (diffuse hits facing the light)."""
    from crt_tpu_torch.ops import vecmath
    from crt_tpu_torch.ops.shade import hit_attributes
    from crt_tpu_torch.scene.types import MATERIAL_DIFFUSE

    attrs = hit_attributes(scene, o, d, hit, kernel_rows=kernel_rows)
    point, normal = attrs.point.contiguous(), attrs.normal
    lights = scene.light_position.contiguous()
    light_vec = lights[:, None, :] - point[None]
    ldir = vecmath.safe_normalize(light_vec)
    facing = vecmath.dot(ldir, normal[None].expand_as(light_vec)) > 0.0
    is_diffuse = attrs.valid & (attrs.mat_type == MATERIAL_DIFFUSE)
    return dict(point=point,
                shadow_o=(point + normal * settings.shadow_bias).contiguous(),
                lights=lights, ldir=ldir,
                r2=vecmath.length_squared(light_vec),
                act=is_diffuse[None] & facing)


def flat_shadow(w):
    """The stacked [Ll * R] form of a shadow wavefront: o, d, r2, active."""
    Ll, R = w["r2"].shape
    return (w["shadow_o"].expand(Ll, R, 3).reshape(-1, 3).contiguous(),
            w["ldir"].reshape(-1, 3).contiguous(),
            w["r2"].reshape(-1).contiguous(), w["act"].reshape(-1))


def masks_equal(name, got, want):
    n_bad = int((got != want).sum())
    check(n_bad == 0, f"{name}: {n_bad} lanes differ from the plain version")


def phase_occlusion_d(device):
    """K5 and K6 on the opaque bench frame's depth-0 shadow wavefront."""
    from crt_tpu_torch.ops.binning import bin_apex_shared, bin_rays
    from crt_tpu_torch.ops.cluster_tables import build_cluster_tables
    from crt_tpu_torch.ops.cluster_trace import (
        closest_hit, occlusion_d, occlusion_d_plain, occlusion_w,
    )
    from crt_tpu_torch.ops.intersect import Hit
    from crt_tpu_torch.scene.procedural import make_test_scene
    from crt_tpu_torch.scene.types import RenderSettings

    scene = make_test_scene(**BENCH, device=device)
    st = RenderSettings()
    tables = build_cluster_tables(scene)
    o, d = primary_wavefront(scene)
    t, tri, _ = closest_hit(tables, o, d, *bin_rays(tables, o, d, TILE))
    w = depth0_shadow_wavefront(scene, st, o, d, Hit(t=t, tri=tri))
    o_f, d_f, r2_f, a_f = flat_shadow(w)
    slack = 2.0 * st.shadow_bias
    tpl = o.shape[0] // TILE
    apex = w["lights"].repeat_interleave(tpl, dim=0)
    act_t = a_f.reshape(-1, TILE)

    cl, cnt = bin_rays(tables, o_f, d_f, TILE, a_f, apex=apex,
                       apex_slack=slack)
    k5_args = (tables, w["shadow_o"], d_f, r2_f, cl, cnt, TILE)
    k5 = occlusion_d(*k5_args, tile_mod=tpl)
    masks_equal("occlusion_d (K5)", k5,
                occlusion_d_plain(*k5_args, tile_mod=tpl))
    gl, gcnt = bin_rays(tables, o_f, d_f, TILE, a_f)
    k6_args = (tables, o_f, d_f, r2_f, gl, gcnt, TILE)
    k6 = occlusion_d(*k6_args, exit=True, active=a_f)
    masks_equal("occlusion_d exit mode (K6)", k6,
                occlusion_d_plain(*k6_args, seed=~a_f))
    check(bool((k5[a_f] == k6[a_f]).all()),
          "K5 and K6 disagree on an active lane")
    check(bool(k6[~a_f].all()), "K6 left an inactive lane unblocked")
    scl, scnt = bin_apex_shared(tables, w["shadow_o"], w["lights"], w["act"],
                                TILE, slack)
    k2 = occlusion_w(tables, w["shadow_o"], w["point"], w["lights"], scl,
                     scnt)
    n_k2 = int((k2[a_f] != k5[a_f]).sum())

    ms5 = cuda_ms(lambda: occlusion_d(*k5_args, tile_mod=tpl))
    ms5p = cuda_ms(lambda: occlusion_d_plain(*k5_args, tile_mod=tpl))
    ms6 = cuda_ms(lambda: occlusion_d(*k6_args, exit=True, active=a_f))
    ms6p = cuda_ms(lambda: occlusion_d_plain(*k6_args, seed=~a_f))
    b5 = walk_bound(tables, cl, cnt, (w["shadow_o"], d_f, r2_f[:, None]),
                    (k5,), act_t, blocked=k5.reshape(-1, TILE))
    b6 = walk_bound(tables, gl, gcnt,
                    (o_f, d_f, r2_f[:, None], a_f[:, None]), (k6,), act_t,
                    blocked=k6.reshape(-1, TILE))
    tests5, tests6 = b5.pop("member_tests"), b6.pop("member_tests")
    b5.pop("ray_bytes"), b6.pop("ray_bytes")
    print(f"[occlusion-d] bench scene depth-0 shadow wavefront: {a_f.numel()} "
          f"lanes in {cnt.numel()} tiles, {int(a_f.sum())} active, "
          f"{int((k5 & a_f).sum())} of them blocked; K5 == plain and K6 == "
          f"plain on every lane, K5 == K6 on the active lanes; K5 and K2's "
          f"capped mode differ on {n_k2} active lanes")
    print(f"[occlusion-d] K5 (shaft lists, {int((cnt > 0).sum())} live tiles,"
          f" {int(cnt.sum())} walked entries): kernel {ms5:.3f} ms, plain "
          f"{ms5p:.3f} ms, bound {b5['bound_ms']:.4f} ms ({b5['bound_by']}, "
          f"{tests5} member tests needed), library call none")
    print(f"[occlusion-d] K6 (generic lists, {int((gcnt > 0).sum())} live "
          f"tiles, {int(gcnt.sum())} walked entries): kernel {ms6:.3f} ms, "
          f"plain {ms6p:.3f} ms, bound {b6['bound_ms']:.4f} ms "
          f"({b6['bound_by']}, {tests6} member tests needed), library call "
          "none")
    return {"occlusion_d": dict(max_abs_err=0.0, ms=ms5, plain_ms=ms5p,
                                library_ms=None, lanes_differing_from_k2=n_k2,
                                **b5),
            "occlusion_d_exit": dict(max_abs_err=0.0, ms=ms6, plain_ms=ms6p,
                                     library_ms=None, **b6)}


def stream_bound(st, pair_sc, bits, start, ray_bytes_per_lane, outputs,
                 active, tile_rays, blocked=None, with_ids=False) -> dict:
    """Bound of a streaming kernel from what this run gave it.

    Bytes: the pair list (supercluster index and member mask per pair) and
    the tile ranges once, every live member cluster's slice of the fused
    table once (16 x 18 floats, and its 16 ids for the closest hit) however
    many tiles walk it, the per-lane inputs of the tiles that have a pair,
    every output in full.  Operations: the member tests the answer needs,
    counted as ``walk_bound`` counts them.  ``floor_ms`` is what those
    tests cost at the no-FMA floor (``NOFMA_SLOTS_PER_MEMBER``)."""
    from crt_tpu_torch.ops.stream_trace import pair_lists

    cl, cnt = pair_lists(pair_sc, bits, start, st.sc)
    on_list = torch.arange(cl.shape[1], device=cl.device) < cnt[:, None]
    touched = int(torch.unique(cl[on_list]).numel())
    table_bytes = touched * 16 * (18 * 4 + (4 if with_ids else 0))
    live_tiles = int((cnt > 0).sum())
    num_bytes = (nbytes(pair_sc, bits, start, *outputs) + table_bytes
                 + live_tiles * tile_rays * ray_bytes_per_lane)
    members = (st.tables.tri_id >= 0).sum(dim=1)
    tile_members = (members[cl.long()] * on_list).sum(dim=1)
    full = active if blocked is None else active & ~blocked
    tests = int((full.sum(dim=1) * tile_members).sum())
    if blocked is not None:
        tests += int((active & blocked).sum())
    return {**bound_ms(num_bytes, tests * FLOPS_PER_MEMBER),
            "floor_ms": tests * NOFMA_SLOTS_PER_MEMBER / H100_FP32_ISSUE * 1e3,
            "member_tests": tests, "pairs": int(pair_sc.shape[0]),
            "live_members": int(cnt.sum()), "clusters_touched": touched,
            "longest_list": int(cnt.max())}


def bruteforce_agreement(name, scene, o, d, t, tri, gen, device, n=8192):
    """(t, tri) vs the all-pairs backend on ``n`` sampled rays."""
    from crt_tpu_torch.ops import intersect

    rays = torch.randperm(o.shape[0], generator=gen)[:n].to(device)
    td = intersect.build_triangle_data(
        scene.vertices, scene.tri_vidx,
        scene.mat_backface[scene.tri_material.long()])
    bf = intersect.closest_hit_bruteforce(td, o[rays], d[rays], ray_chunk=256)
    same = tri[rays] == bf.tri
    n_dis = int((~same).sum())
    both = same & (bf.tri >= 0)
    rel = ((t[rays][both] - bf.t[both]).abs()
           / bf.t[both].abs().clamp(min=1e-30))
    max_rel = float(rel.max()) if bool(both.any()) else 0.0
    print(f"{name} vs bruteforce on {n} rays: {n_dis} tri disagreements, max "
          f"rel t diff {max_rel:.3e} where tri agree ({int(both.sum())} hits)")
    check(n_dis <= n // 1024, f"{n_dis} of {n} rays disagree with bruteforce")
    check(max_rel <= 1e-5, f"t differs from bruteforce by {max_rel:.3e}")


PLAIN_TILES = 32


def tile_subset(pick, pair_sc, bits, start, *per_lane):
    """The sub-problem of the tiles ``pick`` (sorted ids): their pairs with
    the tile ranges renumbered, and their lanes of each per-lane array."""
    dev = pick.device
    lo = start[pick].long()
    n = start[pick + 1].long() - lo
    new_start = torch.cat([n.new_zeros((1,)), n.cumsum(dim=0)])
    idx = (torch.repeat_interleave(lo - new_start[:-1], n)
           + torch.arange(int(new_start[-1]), device=dev))
    lanes = (pick[:, None] * TILE + torch.arange(TILE, device=dev)).reshape(-1)
    return ((pair_sc[idx].contiguous(), bits[idx].contiguous(),
             new_start.to(torch.int32)),
            [x[lanes].contiguous() for x in per_lane], lanes)


def pick_live_tiles(start, gen):
    """``PLAIN_TILES`` seeded tiles among those that own a pair."""
    live = torch.nonzero(start[1:] > start[:-1])[:, 0]
    keep = torch.randperm(live.shape[0], generator=gen)[:PLAIN_TILES]
    return live[keep.to(live.device)].sort().values


SMALL_CHUNK = 8  # the forced item length, against the default
SWEEP_CHUNKS = (16, 32, 64, 128, 256, 512)


def same_bits(name, got, want):
    """Every tensor of ``got`` has the bits of its ``want``, lane for lane
    (a float by its bits: -0.0 differs from +0.0)."""
    for g, w in zip(got, want):
        check(torch.equal(g.view(torch.uint8), w.view(torch.uint8)),
              f"{name}: the bits differ")


def chunk_sweep(fn) -> dict:
    """CUDA-event times of fn(chunk) over SWEEP_CHUNKS."""
    return {c: cuda_ms(lambda: fn(c)) for c in SWEEP_CHUNKS}


def fmt_sweep(sweep) -> str:
    return ", ".join(f"{c}: {ms:.3f} ms" for c, ms in sweep.items())


def timed_once(fn):
    """(result, ms) of one call on the host clock, synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_stream_kernels(device):
    """K8 and K9 at the 1,000,000-triangle frame's shapes, and against K1
    and K5 at 65,536 triangles."""
    from crt_tpu_torch.ops import stream_binning as sb
    from crt_tpu_torch.ops import stream_trace as stt
    from crt_tpu_torch.ops.binning import bin_rays, tile_bounds
    from crt_tpu_torch.ops.cluster_tables import build_cluster_tables
    from crt_tpu_torch.ops.cluster_trace import closest_hit, occlusion_d
    from crt_tpu_torch.ops.intersect import Hit
    from crt_tpu_torch.scene.procedural import make_big_scene
    from crt_tpu_torch.scene.types import RenderSettings

    settings = RenderSettings()
    slack = 2.0 * settings.shadow_bias
    gen = torch.Generator(device="cpu").manual_seed(0)
    stats = {}

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene = make_big_scene(**BIG, seed=0, device=device)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tables = build_cluster_tables(scene)
    st = stt.build_stream_tables(tables)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ms_tables = cuda_ms(lambda: stt.build_stream_tables(
        build_cluster_tables(scene)), warmup=1, reps=3)
    o, d = primary_wavefront(scene)
    R = o.shape[0]
    tiles = R // TILE
    print(f"[stream-kernels] big scene: {scene.num_triangles} triangles in "
          f"{tables.n.shape[0]} clusters, {st.sc_min.shape[0]} superclusters "
          f"of {st.sc}; made in {t1 - t0:.2f} s (host), tables first built in "
          f"{t2 - t1:.2f} s, then {ms_tables:.3f} ms a build")

    # ---- K8 on the primary wavefront
    bounds = tile_bounds(o, d, TILE, None)
    pair_sc, bits, start = stt.bin_stream_pairs(st, bounds)
    ms_pa = cuda_ms(lambda: stt.bin_stream_pairs(st, bounds))
    k8_args = (st.fused, st.tables.tri_id, o, d, pair_sc, bits, start, st.sc,
               TILE)
    t, tri = stt.closest_hit_stream(*k8_args)
    ms_k8 = cuda_ms(lambda: stt.closest_hit_stream(*k8_args))
    same_bits(f"closest_hit_stream chunk={SMALL_CHUNK} vs the default chunk "
              "on every lane", stt.closest_hit_stream(
                  *k8_args, chunk=SMALL_CHUNK), (t, tri))
    # The plain version walks every tile of a chunk to the chunk's longest
    # list, one walk position at a time: tens of seconds over all tiles at
    # this size.  It is held on PLAIN_TILES seeded tiles, where the kernel
    # must also repeat what its full launch gave those tiles.
    pick = pick_live_tiles(start, gen)
    sub, (so, sd), lanes = tile_subset(pick, pair_sc, bits, start, o, d)
    sub_args = (st.fused, st.tables.tri_id, so, sd, *sub, st.sc, TILE)
    kt, ktri = stt.closest_hit_stream(*sub_args)
    (pt, ptri), ms_k8p = timed_once(
        lambda: stt.closest_hit_stream_plain(*sub_args))
    err = compare_hits("closest_hit_stream", (kt, ktri, None),
                       (pt, ptri, None))
    compare_hits("closest_hit_stream, full launch vs sampled tiles",
                 (t[lanes], tri[lanes], None), (kt, ktri, None))
    ms_k8s = cuda_ms(lambda: stt.closest_hit_stream(*sub_args))
    act = torch.ones((tiles, TILE), dtype=torch.bool, device=device)
    b = stream_bound(st, pair_sc, bits, start, 24, (t, tri), act, TILE,
                     with_ids=True)
    print(f"[stream-kernels] K8 primary: {b['pairs']} pairs over {tiles} "
          f"tiles, {b['live_members']} live members (longest tile list "
          f"{b['longest_list']} clusters, {b['clusters_touched']} distinct "
          f"clusters touched), hits {int((tri >= 0).sum())} of {R}; Phase A "
          f"{ms_pa:.3f} ms, kernel {ms_k8:.3f} ms, bound {b['bound_ms']:.4f} "
          f"ms ({b['bound_by']}, {b['member_tests']} member tests needed), "
          f"no-FMA floor {b['floor_ms']:.3f} ms, library call none; "
          f"chunk={SMALL_CHUNK} bit-equal to the default chunk on all {R} "
          f"lanes; on {PLAIN_TILES} sampled tiles (list lengths up to "
          f"{int((sub[2][1:] - sub[2][:-1]).max())} pairs) bit-equal to "
          f"the plain version: kernel {ms_k8s:.3f} ms, plain {ms_k8p:.1f} ms "
          "(one run)")
    bruteforce_agreement("[stream-kernels] K8", scene, o, d, t, tri, gen,
                         device)
    stats["closest_hit_stream"] = dict(
        max_abs_err=err, ms=ms_k8, plain_ms=ms_k8p, plain_tiles=PLAIN_TILES,
        ms_on_plain_tiles=ms_k8s, library_ms=None, phase_a_ms=ms_pa,
        **{k: b[k] for k in ("bound_ms", "bound_by", "floor_ms")})

    # ---- K10 (lane) and K11 (rows) on the same launch
    layout_tables = {"lane": stt.lane_slab(st.fused, st.sc),
                     "rows": st.tables}
    for layout, table in layout_tables.items():
        full = (table, st.tables.tri_id, o, d, pair_sc, bits, start, st.sc,
                TILE)
        lt, ltri = stt.closest_hit_stream(*full, layout=layout)
        compare_hits(f"closest_hit_stream {layout} vs fused, every lane",
                     (lt, ltri, None), (t, tri, None))
        same_bits(f"closest_hit_stream {layout} chunk={SMALL_CHUNK} vs the "
                  "default chunk on every lane", stt.closest_hit_stream(
                      *full, layout=layout, chunk=SMALL_CHUNK), (lt, ltri))
        lsub = (table, st.tables.tri_id, so, sd, *sub, st.sc, TILE)
        kt, ktri = stt.closest_hit_stream(*lsub, layout=layout)
        (pt, ptri), ms_p = timed_once(
            lambda: stt.closest_hit_stream_plain(*lsub, layout))
        lerr = compare_hits(f"closest_hit_stream {layout}", (kt, ktri, None),
                            (pt, ptri, None))
        ms = cuda_ms(lambda: stt.closest_hit_stream(*full, layout=layout))
        ms_s = cuda_ms(lambda: stt.closest_hit_stream(*lsub, layout=layout))
        stats[f"closest_hit_stream_{layout}"] = dict(
            max_abs_err=lerr, ms=ms, plain_ms=ms_p, plain_tiles=PLAIN_TILES,
            ms_on_plain_tiles=ms_s, library_ms=None,
            **{k: b[k] for k in ("bound_ms", "bound_by", "floor_ms")})
        print(f"[stream-kernels] K8 in the {layout} layout: bit-equal to the "
              f"fused launch on all {R} lanes, chunk={SMALL_CHUNK} to the "
              f"default chunk, and to its plain version on the "
              f"{PLAIN_TILES} sampled tiles; kernel {ms:.3f} ms (on the "
              f"sampled tiles {ms_s:.3f} ms), plain {ms_p:.1f} ms (one run), "
              f"bound {b['bound_ms']:.4f} ms, floor {b['floor_ms']:.3f} ms")
    ms_k8b = cuda_ms(lambda: stt.closest_hit_stream(*k8_args))
    stats["closest_hit_stream"]["ms_after_layouts"] = ms_k8b
    print(f"[stream-kernels] K8 fused timed again after the layouts: "
          f"{ms_k8b:.3f} ms (first {ms_k8:.3f} ms)")
    sweep = chunk_sweep(lambda c: stt.closest_hit_stream(*k8_args, chunk=c))
    stats["closest_hit_stream"]["chunk_sweep_ms"] = sweep
    print(f"[stream-kernels] K8 fused by chunk length (live members an "
          f"item; default {stt.CHUNK_MEMBERS}): {fmt_sweep(sweep)}")

    # ---- K9 on the depth-0 shadow wavefront: one phase, then two
    w = depth0_shadow_wavefront(scene, settings, o, d, Hit(t=t, tri=tri))
    o_f, d_f, r2_f, a_f = flat_shadow(w)
    apex = w["lights"].repeat_interleave(tiles, dim=0)
    sbounds = tile_bounds(o_f, d_f, TILE, a_f)
    hull = sb.pair_mask(st.sc_min, st.sc_max, sbounds, apex, slack)

    def lane_exact():
        return sb.lane_exact_sc_mask(o_f, d_f, r2_f, a_f, slack, st.sc_min,
                                     st.sc_max, TILE, where=hull)

    extra = lane_exact()
    ms_le = cuda_ms(lane_exact, warmup=1, reps=3)
    print(f"[stream-kernels] shadow wavefront: {int(a_f.sum())} of "
          f"{a_f.numel()} lanes active; the shaft hull admits "
          f"{int(hull.sum())} pairs, the per-lane test keeps "
          f"{int((hull & extra).sum())} of them in {ms_le:.3f} ms")

    calls = []
    real = stt.occlusion_stream

    def recording(*args):
        calls.append(args)
        return real(*args)

    stt.occlusion_stream = recording
    try:
        single = stt.occluded_stream_flat(st, o_f, d_f, r2_f, a_f, apex,
                                          slack, TILE, layout="fused")
        two = stt.occluded_stream_twophase(
            st, w["shadow_o"], w["ldir"], w["r2"], w["lights"], w["act"],
            slack, TILE, phase1_k=settings.stream_shadow_k, layout="fused")
    finally:
        stt.occlusion_stream = real
    check(len(calls) == 3, f"{len(calls)} K9 launches recorded, expected 3")
    check(bool((two.reshape(-1)[a_f] == single[a_f]).all()),
          "the two-phase resolve differs from the single phase on an active "
          "lane")
    check(bool(single[~a_f].all()), "K9 left an inactive lane unblocked")
    layout_ms = {}
    for name, args in zip(("single phase", "phase 1", "phase 2"), calls):
        fused, ko, kd, kr2, seed, kpsc, kbits, kstart, ksc = args[:9]
        k9 = real(*args)
        ms = cuda_ms(lambda: real(*args))
        masks_equal(f"occlusion_stream, {name}, chunk={SMALL_CHUNK} vs the "
                    "default chunk on every lane",
                    real(*args, chunk=SMALL_CHUNK), k9)
        pick = pick_live_tiles(kstart, gen)
        sub, per_lane, lanes = tile_subset(pick, kpsc, kbits, kstart, ko, kd,
                                           kr2, seed)
        sub_args = (fused, *per_lane, *sub, ksc, TILE)
        k9s = real(*sub_args)
        p9, ms_p = timed_once(lambda: stt.occlusion_stream_plain(*sub_args))
        masks_equal(f"occlusion_stream, {name}", k9s, p9)
        masks_equal(f"occlusion_stream, {name}, full launch vs sampled "
                    "tiles", k9[lanes], k9s)
        ms_s = cuda_ms(lambda: real(*sub_args))
        b = stream_bound(st, kpsc, kbits, kstart, 29, (k9,),
                         ~seed.reshape(-1, TILE), TILE,
                         blocked=k9.reshape(-1, TILE))
        print(f"[stream-kernels] K9 {name}: {b['pairs']} pairs, "
              f"{b['live_members']} live members (longest tile list "
              f"{b['longest_list']}), {int((~seed).sum())} active lanes, "
              f"{int((k9 & ~seed).sum())} of them blocked; kernel {ms:.3f} "
              f"ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}, "
              f"{b['member_tests']} member tests needed), no-FMA floor "
              f"{b['floor_ms']:.3f} ms, library call none; chunk="
              f"{SMALL_CHUNK} equal to the default chunk on all {k9.numel()} "
              f"lanes; on {PLAIN_TILES} sampled tiles equal to the plain "
              f"version lane for lane: kernel {ms_s:.3f} ms, plain "
              f"{ms_p:.1f} ms (one run)")
        key = {"single phase": "occlusion_stream_single",
               "phase 1": "occlusion_stream_phase1",
               "phase 2": "occlusion_stream"}[name]
        stats[key] = dict(max_abs_err=0.0, ms=ms, plain_ms=ms_p,
                          plain_tiles=PLAIN_TILES, ms_on_plain_tiles=ms_s,
                          library_ms=None,
                          **{k: b[k] for k in ("bound_ms", "bound_by",
                                               "floor_ms")})
        if name == "phase 2":
            sweep = chunk_sweep(lambda c: real(*args, chunk=c))
            stats[key]["chunk_sweep_ms"] = sweep
            print(f"[stream-kernels] K9 phase 2 fused by chunk length: "
                  f"{fmt_sweep(sweep)}")
        # K10 and K11 on the frame's launches
        for layout, table in layout_tables.items():
            lfull = (table, *args[1:9], TILE)
            lk9 = real(*lfull, layout=layout)
            masks_equal(f"occlusion_stream {layout}, {name}, vs fused on "
                        "every lane", lk9, k9)
            masks_equal(f"occlusion_stream {layout}, {name}, chunk="
                        f"{SMALL_CHUNK} vs the default chunk on every lane",
                        real(*lfull, layout=layout, chunk=SMALL_CHUNK), lk9)
            lsub = (table, *per_lane, *sub, ksc, TILE)
            lp9, lms_p = timed_once(
                lambda: stt.occlusion_stream_plain(*lsub, layout))
            masks_equal(f"occlusion_stream {layout}, {name}",
                        real(*lsub, layout=layout), lp9)
            lms = cuda_ms(lambda: real(*lfull, layout=layout))
            lms_s = cuda_ms(lambda: real(*lsub, layout=layout))
            layout_ms[layout, name] = (lms, lms_p, lms_s)
            print(f"[stream-kernels] K9 {name} in the {layout} layout: "
                  f"equal to the fused launch on all {k9.numel()} lanes, "
                  f"chunk={SMALL_CHUNK} to the default chunk, and to its "
                  f"plain version on the {PLAIN_TILES} sampled tiles; kernel "
                  f"{lms:.3f} ms (fused {ms:.3f}; on the sampled tiles "
                  f"{lms_s:.3f} ms), plain {lms_p:.1f} ms (one run), bound "
                  f"{b['bound_ms']:.4f} ms, floor {b['floor_ms']:.3f} ms")
    print("[stream-kernels] two-phase == single phase on every active lane")
    # the frame launches phase 1 and phase 2; each entry carries phase 2's
    # time and bound, the other two beside it
    p1 = stats.pop("occlusion_stream_phase1")
    one = stats.pop("occlusion_stream_single")
    stats["occlusion_stream"].update(
        ms_phase1=p1["ms"], bound_ms_phase1=p1["bound_ms"],
        floor_ms_phase1=p1["floor_ms"],
        ms_phase1_on_plain_tiles=p1["ms_on_plain_tiles"],
        ms_single_phase=one["ms"], bound_ms_single_phase=one["bound_ms"],
        floor_ms_single_phase=one["floor_ms"])
    for layout in layout_tables:
        lms, lms_p, lms_s = layout_ms[layout, "phase 2"]
        stats[f"occlusion_stream_{layout}"] = dict(
            max_abs_err=0.0, ms=lms, plain_ms=lms_p, plain_tiles=PLAIN_TILES,
            ms_on_plain_tiles=lms_s, library_ms=None,
            ms_phase1=layout_ms[layout, "phase 1"][0],
            ms_single_phase=layout_ms[layout, "single phase"][0],
            **{k: stats["occlusion_stream"][k]
               for k in ("bound_ms", "bound_by", "floor_ms")})
    del calls, w, o_f, d_f, r2_f, a_f, hull, extra, single, two

    # ---- a scene both backends hold: K8 == K1, K9 == K5
    mid = make_big_scene(**MID, seed=0, device=device)
    mtab = build_cluster_tables(mid)
    mst = stt.build_stream_tables(mtab)
    mo, md = primary_wavefront(mid)
    hit, _ = stt.closest_hit_stream_flat(mst, mo, md)
    k1 = closest_hit(mtab, mo, md, *bin_rays(mtab, mo, md, TILE))
    compare_hits("streaming hits vs closest_hit at 65,536 triangles",
                 (hit.t, hit.tri, None), (k1[0], k1[1], None))
    w = depth0_shadow_wavefront(mid, settings, mo, md, hit)
    o_f, d_f, r2_f, a_f = flat_shadow(w)
    apex = w["lights"].repeat_interleave(tiles, dim=0)
    k9 = stt.occluded_stream_flat(mst, o_f, d_f, r2_f, a_f, apex, slack, TILE)
    cl, cnt = bin_rays(mtab, o_f, d_f, TILE, a_f, apex=apex, apex_slack=slack)
    k5 = occlusion_d(mtab, w["shadow_o"], d_f, r2_f, cl, cnt, TILE,
                     tile_mod=tiles)
    check(bool((k9[a_f] == k5[a_f]).all()),
          "K9 and K5 disagree on an active lane at 65,536 triangles")
    print(f"[stream-kernels] 65,536 triangles: streaming hits == "
          f"closest_hit's on all {mo.shape[0]} lanes (t and tri bit-equal); "
          f"K9 == K5 on all {int(a_f.sum())} active shadow lanes "
          f"({int((k9 & a_f).sum())} blocked)")
    return stats


def ray_colors(img, scene):
    """An [H, W, 3] image back in ray order: (colors [R, 3], inside [R])."""
    from crt_tpu_torch.renderer import make_tiler

    rx, ry, _ = make_tiler(scene.height, scene.width, device=img.device)
    inside = (rx < scene.width) & (ry < scene.height)
    x = rx.long().clamp(max=scene.width - 1)
    y = ry.long().clamp(max=scene.height - 1)
    return img[y, x], inside


def image_agreement(name, img, ref, min_frac=0.9999):
    close = ((img - ref).abs() <= 1e-5 + 1e-4 * ref.abs()).all(dim=-1)
    frac = float(close.float().mean())
    print(f"{name}: max |diff| {float((img - ref).abs().max()):.3e}, "
          f"{int((~close).sum())} of {close.numel()} px outside rtol 1e-4 / "
          f"atol 1e-5 ({frac * 100:.4f} % inside)")
    check(frac >= min_frac,
          f"{name}: fewer than {min_frac * 100:.2f} % of pixels agree")


def phase_a_ms(fn) -> float:
    """Device time of the streaming Phase A inside one call of fn(): CUDA
    events around every call of its functions, host gaps included."""
    from crt_tpu_torch.ops import stream_binning as sb
    from crt_tpu_torch.ops import stream_trace as stt

    spans = []
    depth = [0]  # one of these functions calls another: time the outer one

    def bracket(real):
        def timed(*args, **kw):
            if depth[0]:
                return real(*args, **kw)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            depth[0] += 1
            start.record()
            try:
                out = real(*args, **kw)
            finally:
                depth[0] -= 1
            end.record()
            spans.append((start, end))
            return out
        return timed

    patched = ((stt, "tile_bounds"), (stt, "bin_stream_pairs"),
               (sb, "pair_mask"), (sb, "lane_exact_sc_mask"))
    saved = [(mod, name, getattr(mod, name)) for mod, name in patched]
    for mod, name, real in saved:
        setattr(mod, name, bracket(real))
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)
    return sum(a.elapsed_time(b) for a, b in spans)


def phase_big(device):
    """The large-scene main path: render_image of the 1,000,000-triangle
    1080p frame with default settings."""
    from crt_tpu_torch import RenderSettings, render_image
    from crt_tpu_torch import renderer
    from crt_tpu_torch.ops import intersect
    from crt_tpu_torch.ops.shade import shade_wavefront
    from crt_tpu_torch.scene.procedural import make_big_scene

    W, H = BIG["width"], BIG["height"]
    scene = make_big_scene(**BIG, seed=0, device=device)
    reset_launches()
    img = render_image(scene)
    torch.cuda.synchronize()
    launches = read_stream_launches()
    print(f"[big] render_image of {scene.num_triangles} triangles at {W}x{H},"
          f" default settings: launches {launches}")
    check(launches["closest_hit_stream"] == 1
          and launches["occlusion_stream"] == 2
          and launches["closest_hit"] == 0 and launches["occlusion_w"] == 0
          and launches["occlusion_d"] == 0 and launches["segsum"] == 0,
          f"the large frame launched {launches}: expected one streaming "
          "closest hit, the two launches of the two-phase shadow resolve and "
          "no cluster-backend kernel (auto must choose the streaming backend)")
    check(tuple(img.shape) == (H, W, 3) and bool(torch.isfinite(img).all()),
          "the large frame is not a finite [H, W, 3]")
    # the forward is deterministic: the closest hit's chunks combine through
    # atomics in any order, and must still give the same bits
    same_bits("[big] a second forward frame", (render_image(scene),), (img,))
    print("[big] a second forward frame equals the first bit for bit")

    # the all-pairs backend on sampled rays, shaded as the frame shades them
    gen = torch.Generator(device="cpu").manual_seed(1)
    o, d = primary_wavefront(scene)
    colors, inside = ray_colors(img, scene)
    rays = torch.nonzero(inside)[:, 0]
    rays = rays[torch.randperm(rays.shape[0], generator=gen)[:8192].to(device)]
    td = intersect.build_triangle_data(
        scene.vertices, scene.tri_vidx,
        scene.mat_backface[scene.tri_material.long()])

    def bf(origins, dirs, active=None):  # a [256, 4 T] product per chunk
        return intersect.closest_hit_bruteforce(td, origins, dirs,
                                                ray_chunk=256)

    with torch.no_grad():
        ref = shade_wavefront(scene, RenderSettings(), bf, o[rays], d[rays])
    # 8 of 8192, the allowance of the hit comparison above: the all-pairs
    # backend takes its dot products by matmul, and a ray grazing an edge
    # may find the other triangle
    image_agreement("[big] streaming frame vs the all-pairs backend on 8192 "
                    "sampled pixels", colors[rays], ref, min_frac=0.999)
    lit = (colors[rays] != scene.background_color).any(dim=-1)
    print(f"[big] {int(lit.sum())} of the 8192 sampled pixels hit geometry")

    # render_image through the all-pairs backend at this size, at 64x36: its
    # default ray chunk is sized from T so that the [chunk, 4 T] product fits
    small = make_big_scene(**dict(BIG, width=64, height=36), seed=0,
                           device=device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bf_img, bf_ms = timed_once(
        lambda: render_image(small, RenderSettings(backend="bruteforce")))
    bf_peak = torch.cuda.max_memory_allocated() / 2**30
    check(tuple(bf_img.shape) == (36, 64, 3)
          and bool(torch.isfinite(bf_img).all()),
          "the all-pairs frame at 64x36 is not a finite [36, 64, 3]")
    image_agreement("[big] 64x36, all-pairs backend vs streaming", bf_img,
                    render_image(small), min_frac=0.999)
    print(f"[big] render_image(backend=\"bruteforce\") of "
          f"{small.num_triangles} triangles at 64x36: {bf_ms:.1f} ms (one "
          f"run), ray chunk {intersect.default_ray_chunk(small.num_triangles)}"
          f", peak {bf_peak:.3f} GiB")
    del small, bf_img

    # time: the frame, and what a profiled frame spends where
    phase_a = phase_a_ms(lambda: render_image(scene))
    torch.cuda.reset_peak_memory_stats()
    wall, enq = host_ms(lambda: render_image(scene), warmup=2, reps=5)
    peak = torch.cuda.max_memory_allocated() / 2**30
    dev_ms, dev_launches, by_tag = profile_frame(
        lambda: render_image(scene), top=8, tag="[big]",
        tags=("closest_hit_stream", "occlusion_stream"))
    print(f"[big] forward frame {wall:.3f} ms = {W * H / wall / 1e3:.3f} "
          f"Mrays/s (host enqueue {enq:.3f} ms); profiled frame: device "
          f"kernels {dev_ms:.3f} ms in {dev_launches} launches, of which the "
          f"streaming kernels {sum(by_tag.values()):.3f} ms; Phase A (tile "
          f"bounds, pair and member lists, the per-lane test; CUDA events "
          f"around its calls in one frame) {phase_a:.3f} ms; "
          f"{launches['stream_pairs']} pairs listed, "
          f"{launches['stream_host_syncs']} host reads; peak {peak:.3f} GiB")

    # one value_and_grad of the frame
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    value, grads = image_sum_grads(scene)
    torch.cuda.synchronize()
    g_ms = (time.perf_counter() - t0) * 1e3
    g_launches = read_stream_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for k, gk in grads.items():
        check(tuple(gk.shape) == tuple(getattr(scene, k).shape)
              and bool(torch.isfinite(gk).all()) and bool(gk.abs().max() > 0),
              f"large frame: d/d{k} is not finite and non-zero")
    g2_ms, _ = host_ms(lambda: image_sum_grads(scene), warmup=0, reps=3)
    print(f"[big] value_and_grad of the frame's sum w.r.t. {TRAINED}: value "
          f"{float(value):.6e}, all finite; first run {g_ms:.1f} ms, then "
          f"{g2_ms:.3f} ms = {W * H / g2_ms / 1e3:.3f} Mrays/s; peak "
          f"{peak:.3f} GiB; segment-sum launches {g_launches['segsum']} "
          f"(T = {scene.num_triangles}), streaming kernels "
          f"{g_launches['closest_hit_stream']} + "
          f"{g_launches['occlusion_stream']}")
    check(g_launches["segsum"] == 1 and g_launches["closest_hit_stream"] == 1,
          f"the large frame's backward launched {g_launches}")
    del grads, img, colors, ref

    # both backends on scenes of growing size: what sets the auto threshold
    stream_st = RenderSettings(backend="stream")
    cluster_st = RenderSettings(backend="cluster")
    for n in (16384, 65536, 262144, BIG["num_triangles"]):
        sized = make_big_scene(**dict(BIG, num_triangles=n), seed=0,
                               device=device)
        clusters = -(-n // 16)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        s_ms, _ = host_ms(lambda: render_image(sized, stream_st), reps=3)
        s_peak = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            c_ms, _ = host_ms(lambda: render_image(sized, cluster_st), reps=3)
            c_txt = (f"{c_ms:.3f} ms (peak "
                     f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB)")
        except torch.cuda.OutOfMemoryError:
            c_ms = None
            c_txt = "out of memory"
        auto = renderer.make_trace_fn(sized, RenderSettings())
        picked = "cluster" if hasattr(auto, "with_rows") else "stream"
        print(f"[big] {n} triangles ({clusters} clusters): streaming backend "
              f"{s_ms:.3f} ms (peak {s_peak:.3f} GiB), cluster backend "
              f"{c_txt}; auto picks {picked}")
        if picked == "cluster" and (c_ms is None or c_ms > 1.25 * s_ms):
            print(f"[big]   note: auto keeps the cluster backend here "
                  f"(threshold {renderer.AUTO_STREAM_MIN_CLUSTERS} clusters) "
                  "though the streaming backend is over a quarter faster")
        if n == 65536:
            s_img = render_image(sized, stream_st)
            c_img = render_image(sized, cluster_st)
            image_agreement("[big] 65,536 triangles, streaming vs cluster "
                            "image on every pixel", s_img, c_img)
            n_diff = int((s_img != c_img).any(dim=-1).sum())
            print(f"[big]   {n_diff} px differ at all (hits are bit-equal; "
                  "the cluster backend's shadows test |n.w|, the streaming "
                  "backend's |n.d|)")
            _, sg = image_sum_grads(sized, stream_st)
            _, cg = image_sum_grads(sized, cluster_st)
            assert_grads_close("65,536 triangles, streaming vs cluster "
                               "backend", sg, cg, rtol=1e-3, atol_scale=1e-4)
            del s_img, c_img, sg, cg
        del sized, auto
    return launches, scene


def phase_layouts(device, scene):
    """The large-scene main path in the lane and rows table layouts:
    render_image of the 1,000,000-triangle frame with CRT_STREAM_LAYOUT set
    (the port reads it when render_image builds the trace)."""
    from crt_tpu_torch import render_image
    from crt_tpu_torch.ops import cluster_trace, stream_trace

    layouts = ("fused", "lane", "rows")
    images, launches, ms = {}, {}, {}
    saved = os.environ.get("CRT_STREAM_LAYOUT")
    try:
        for layout in layouts:
            os.environ["CRT_STREAM_LAYOUT"] = layout
            reset_launches()
            images[layout] = render_image(scene)
            torch.cuda.synchronize()
            launches[layout] = (
                dict(stream_trace.closest_hit_stream_layout_launches),
                dict(stream_trace.occlusion_stream_layout_launches),
                cluster_trace.closest_hit_launches)
            print(f"[layouts] CRT_STREAM_LAYOUT={layout}: closest-hit "
                  f"launches {launches[layout][0]}, any-hit launches "
                  f"{launches[layout][1]}")
            want = dict.fromkeys(layouts, 0)
            check(launches[layout] == ({**want, layout: 1},
                                       {**want, layout: 2}, 0),
                  f"the {layout} frame launched {launches[layout]}: expected "
                  f"one closest hit and two any-hit passes, all {layout}")
        # frame times in turns, forward then backward
        for rnd, order in enumerate((layouts, layouts[::-1])):
            for layout in order:
                os.environ["CRT_STREAM_LAYOUT"] = layout
                ms[layout, rnd], _ = host_ms(lambda: render_image(scene),
                                             warmup=1, reps=5)
    finally:
        if saved is None:
            os.environ.pop("CRT_STREAM_LAYOUT", None)
        else:
            os.environ["CRT_STREAM_LAYOUT"] = saved
    for layout in ("lane", "rows"):
        check(torch.equal(images[layout], images["fused"]),
              f"the {layout} frame differs from the fused frame")
    W, H = scene.width, scene.height
    for layout in layouts:
        print(f"[layouts] {layout}: frame {ms[layout, 0]:.3f} ms, then "
              f"{ms[layout, 1]:.3f} ms (median of 5, host clock around a "
              f"synchronize) = {W * H / ms[layout, 0] / 1e3:.3f} Mrays/s")
    print("[layouts] the lane and rows frames equal the fused frame bit for "
          "bit")
    return {f"{kind}_{layout}": launches[layout][i][layout]
            for layout in ("lane", "rows")
            for i, kind in enumerate(("closest_hit_stream",
                                      "occlusion_stream"))}


_CHILD = r"""
import json, sys
from crt_tpu_torch.frontend import cli
from crt_tpu_torch.ops import cluster_trace, stream_trace
rc = cli.main(sys.argv[1:])
print(json.dumps({"rc": rc,
    "closest_hit": cluster_trace.closest_hit_launches,
    "closest_hit_merged": cluster_trace.closest_hit_merged_launches,
    "occlusion_w": cluster_trace.occlusion_w_launches,
    "occlusion_d": cluster_trace.occlusion_d_mode_launches["compact"],
    "closest_hit_stream": stream_trace.closest_hit_stream_launches,
    "occlusion_stream": stream_trace.occlusion_stream_launches}))
"""


def cli_child(argv, env_extra):
    """The CLI in a child process (its environment decides the module
    flags) -> the kernel launch counts it printed on its last line."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, **env_extra)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run([sys.executable, "-c", _CHILD, *argv], env=env,
                          cwd=root, capture_output=True, text=True,
                          timeout=600)
    check(proc.returncode == 0, f"the CLI child failed:\n{proc.stderr[-2000:]}")
    counts = json.loads(proc.stdout.strip().splitlines()[-1])
    check(counts.pop("rc") == 0, "the CLI child's main returned non-zero")
    return counts


def phase_direction_form(device):
    """K5's and K6's render paths, and the streaming backend through the
    CLI, on the opaque bench frame."""
    from crt_tpu_torch import RenderSettings, render_image
    from crt_tpu_torch.io.ppm import quantize, read_ppm
    from crt_tpu_torch.ops.cluster_trace import make_cluster_trace_fn
    from crt_tpu_torch.ops.shade import shade_wavefront
    from crt_tpu_torch.renderer import make_tiler
    from crt_tpu_torch.scene.procedural import (
        make_test_scene, make_test_scene_dict,
    )

    W, H = BENCH["width"], BENCH["height"]
    scene = make_test_scene(**BENCH, device=device)
    with tempfile.TemporaryDirectory() as tmp:
        scene_path = os.path.join(tmp, "bench.crtscene")
        with open(scene_path, "w") as f:
            json.dump(make_test_scene_dict(**BENCH), f)
        k5_ppm = os.path.join(tmp, "k5.ppm")
        st_ppm = os.path.join(tmp, "stream.ppm")
        k5_counts = cli_child([scene_path, k5_ppm, "--device", str(device)],
                              {"CRT_APEX_W": "0"})
        st_counts = cli_child([scene_path, st_ppm, "--device", str(device),
                               "--backend", "pallas_stream"], {})
        k5_img = (read_ppm(k5_ppm) * 255).round().astype("int32")
        st_img = (read_ppm(st_ppm) * 255).round().astype("int32")
    print(f"[direction-form] CLI with CRT_APEX_W=0: launches {k5_counts}; "
          f"CLI with --backend pallas_stream: launches {st_counts}")
    check(k5_counts["occlusion_d"] == 4 and k5_counts["occlusion_w"] == 0
          and k5_counts["closest_hit"] == 4,
          f"the CRT_APEX_W=0 frame launched {k5_counts}: expected 4 closest "
          "hits, 4 direction-form shadow passes and no w-form pass")
    check(st_counts["closest_hit_stream"] == 4
          and st_counts["occlusion_stream"] == 8
          and st_counts["closest_hit"] == 0 and st_counts["occlusion_w"] == 0,
          f"the pallas_stream frame launched {st_counts}")
    check(k5_img.shape == (H, W, 3) and bool((k5_img == st_img).all()),
          "the streaming backend's frame differs from the cluster backend's "
          "direction-form frame")

    def levels(image):
        return quantize(image.cpu().numpy())

    default = levels(render_image(scene))
    brute = levels(render_image(scene, RenderSettings(backend="bruteforce")))
    for name, other in (("the default (w-form) cluster frame", default),
                        ("the all-pairs backend's frame", brute)):
        off = (abs(k5_img - other) > 1).any(axis=-1)
        print(f"[direction-form] CRT_APEX_W=0 frame == pallas_stream frame "
              f"bit for bit; vs {name}: {int(off.sum())} of {off.size} px "
              f"more than one 8-bit level apart, "
              f"{int((k5_img != other).any(axis=-1).sum())} px differ at all")
        check(off.mean() <= 1e-4, f"the direction-form frame is more than "
              f"one level off {name} on over 0.01 % of pixels")

    # K6: one frame shaded with the any-hit query as the shadow path
    rx, ry, untile = make_tiler(H, W, device=device)
    o, d = primary_wavefront(scene)
    with torch.no_grad():
        reset_launches()
        k6_img = untile(shade_wavefront(
            scene, RenderSettings(),
            make_cluster_trace_fn(scene, use_occlusion_kernel=True,
                                  apex_w=False), o, d))
        k6_counts = read_stream_launches()
        k5_float = untile(shade_wavefront(
            scene, RenderSettings(),
            make_cluster_trace_fn(scene, apex_w=False), o, d))
    print(f"[direction-form] shade_wavefront with use_occlusion_kernel=True: "
          f"launches {k6_counts}")
    check(k6_counts["occlusion_d_exit"] == 4 and k6_counts["occlusion_d"] == 0
          and k6_counts["occlusion_w"] == 0,
          f"the any-hit frame launched {k6_counts}: expected 4 K6 passes")
    check(torch.equal(k6_img, k5_float),
          "the any-hit (K6) frame differs from the direction-form (K5) frame")
    check(bool((levels(k5_float) == k5_img).all()),
          "the in-process direction-form frame differs from the CLI's")
    print("[direction-form] the K6 frame equals the K5 frame bit for bit")
    return {"occlusion_d": k5_counts["occlusion_d"],
            "occlusion_d_exit": k6_counts["occlusion_d_exit"]}


def phase_profile(device, frames=3):
    """torch.profiler over forward+backward frames of the benchmark scene."""
    from torch.profiler import ProfilerActivity, profile

    from crt_tpu_torch.scene.procedural import make_test_scene

    scene = make_test_scene(**BENCH, device=device)
    for _ in range(2):
        image_sum_grads(scene)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # unprofiled: host enqueue vs the wait for the device
    walls, enqueues = [], []
    for _ in range(frames):
        t0 = time.perf_counter()
        image_sum_grads(scene)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        enqueues.append((t1 - t0) * 1e3)
    print(f"[profile] forward+backward, unprofiled: wall median "
          f"{statistics.median(walls):.3f} ms, host enqueue median "
          f"{statistics.median(enqueues):.3f} ms; peak memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            image_sum_grads(scene)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3

    def device_us(ev):
        return getattr(ev, "self_device_time_total",
                       getattr(ev, "self_cuda_time_total", 0.0))

    # device-side rows only: a host op's row repeats its kernels' time
    kernels = [(device_us(ev), ev.count, ev.key)
               for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and device_us(ev) > 0]
    kernels.sort(reverse=True)
    total = sum(k[0] for k in kernels)
    launches = sum(k[1] for k in kernels)
    check(total > 0, "the profiler recorded no device time")
    print(f"[profile] {frames} profiled frames: wall {wall:.3f} ms, device "
          f"kernel time {total / 1e3:.3f} ms ({total / 1e3 / frames:.3f} per "
          f"frame, busy {total / 10 / wall:.1f} % of the profiled wall), "
          f"{launches} device launches ({launches // frames} per frame)")
    for us, count, key in kernels[:12]:
        print(f"[profile]   {us / 1e3:9.3f} ms  {count:6d} x  {key[:90]}")
    for tag in ("segment_accumulate", "closest_hit", "occlusion_w"):
        us = sum(k[0] for k in kernels if tag in k[2])
        n = sum(k[1] for k in kernels if tag in k[2])
        print(f"[profile] {tag}: {us / 1e3:.3f} ms over {n} launches "
              f"({100 * us / total:.2f} % of device time)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile forward+backward frames instead of "
                    "running the checks")
    ap.add_argument("--large", action="store_true",
                    help="run only the large-scene, table-layout and "
                    "direction-form phases (no JSON lines)")
    ap.add_argument("--parent", metavar="DIR",
                    help="time K1, K2, K3 and K4 at their redesign "
                    "shapes and profile the opaque and glass frames in "
                    "turns with the kernels built from "
                    "DIR/crt_tpu_torch/csrc (another checkout's, with this "
                    "one's interface), and nothing else (no JSON lines)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's card path cannot run",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    name = phase_device()
    phase_build()
    if args.profile:
        phase_profile(device)
        return 0
    if args.parent:
        from crt_tpu_torch.ops import cuda_lib

        info = cuda_lib.build(os.path.join(args.parent, "crt_tpu_torch",
                                           "csrc"))
        print(f"[turns] parent kernels {info.path}: {info.seconds:.2f} s in "
              "nvcc")
        parent = bind_parent(info.path)
        phase_shapes(device, parent)
        profile_turns(device, parent)
        print(f"[done] {time.perf_counter() - t0:.1f} s")
        return 0
    if args.large:
        phase_occlusion_d(device)
        phase_stream_kernels(device)
        _, big_scene = phase_big(device)
        torch.cuda.empty_cache()
        phase_layouts(device, big_scene)
        del big_scene
        phase_direction_form(device)
        print(f"[done] {time.perf_counter() - t0:.1f} s")
        return 0
    stats = phase_kernels(device)
    stats["segsum"] = phase_segsum(device)
    phase_scale(device)
    phase_shapes(device)
    torch.cuda.empty_cache()
    launches = phase_main_path(device)
    launches["segsum"] = phase_train(device)["segsum"]
    variants, launches["closest_hit_merged"] = phase_variants(device)
    stats.update(variants)
    stats.update(phase_glass_kernels(device))
    glass, compact = phase_refract(device)
    torch.cuda.empty_cache()
    stats.update(phase_occlusion_d(device))
    stats.update(phase_stream_kernels(device))
    torch.cuda.empty_cache()
    big, big_scene = phase_big(device)
    torch.cuda.empty_cache()
    launches.update(phase_layouts(device, big_scene))
    del big_scene
    torch.cuda.empty_cache()
    direction = phase_direction_form(device)
    # the glass frame's own paths: the CLI render (glass-flag passes) and
    # the render with compact_bounces (compacted launches).  No render path
    # takes the uncapped member-masked mode: its one caller is
    # trace.refr_ray_hit_w, the router's cross-check, whose launches are
    # printed by [refract] and not counted here.
    launches["occlusion_w_glass"] = glass["occlusion_w_glass"]
    launches["closest_hit_compact"] = compact["closest_hit_compact"]
    stats["closest_hit_compact"]["live_tiles_launches"] = compact["live_tiles"]
    launches["occlusion_w_uncapped"] = (glass["occlusion_w_uncapped"]
                                        + compact["occlusion_w_uncapped"])
    # the large frame's own path (render_image, default settings; with
    # CRT_STREAM_LAYOUT=lane and =rows for K10 and K11), the CRT_APEX_W=0
    # frame through the CLI (K5), and a frame shaded through a trace built
    # with use_occlusion_kernel=True (K6: a factory option that no setting
    # of render_image reaches, here or in crt_tpu).  K7's launches are the
    # CRT_TILE_MERGE=2 CLI frame's.
    launches["closest_hit_stream"] = big["closest_hit_stream"]
    launches["occlusion_stream"] = big["occlusion_stream"]
    launches.update(direction)
    off_path = ("occlusion_w_uncapped", "occlusion_d_exit")
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    described = (
        ("closest_hit", "crt_tpu_torch/csrc/closest_hit.cu",
         "crt_tpu/ops/pallas_trace.py:655"),
        ("occlusion_w", "crt_tpu_torch/csrc/occlusion_w.cu",
         "crt_tpu/ops/pallas_trace.py:831"),
        ("occlusion_w_glass", "crt_tpu_torch/csrc/occlusion_w.cu",
         "crt_tpu/ops/pallas_trace.py:831"),
        ("occlusion_w_uncapped", "crt_tpu_torch/csrc/occlusion_w.cu",
         "crt_tpu/ops/pallas_trace.py:831"),
        ("closest_hit_compact", "crt_tpu_torch/csrc/closest_hit.cu",
         "crt_tpu/ops/pallas_trace.py:696"),
        ("segsum", "crt_tpu_torch/csrc/segsum.cu",
         "crt_tpu/ops/pallas_segsum.py:75"),
        ("occlusion_d", "crt_tpu_torch/csrc/occlusion_d.cu",
         "crt_tpu/ops/pallas_trace.py:737"),
        ("occlusion_d_exit", "crt_tpu_torch/csrc/occlusion_d.cu",
         "crt_tpu/ops/pallas_trace.py:1351"),
        ("closest_hit_stream", "crt_tpu_torch/csrc/stream_trace.cu",
         "crt_tpu/ops/pallas_stream.py:576"),
        ("occlusion_stream", "crt_tpu_torch/csrc/stream_trace.cu",
         "crt_tpu/ops/pallas_stream.py:576"),
        ("closest_hit_merged", "crt_tpu_torch/csrc/closest_hit.cu",
         "crt_tpu/ops/pallas_trace.py:1598"),
        ("closest_hit_stream_lane", "crt_tpu_torch/csrc/stream_trace.cu",
         "crt_tpu/ops/pallas_stream.py:576"),
        ("occlusion_stream_lane", "crt_tpu_torch/csrc/stream_trace.cu",
         "crt_tpu/ops/pallas_stream.py:576"),
        ("closest_hit_stream_rows", "crt_tpu_torch/csrc/stream_trace.cu",
         "crt_tpu/ops/pallas_stream.py:669"),
        ("occlusion_stream_rows", "crt_tpu_torch/csrc/stream_trace.cu",
         "crt_tpu/ops/pallas_stream.py:783"),
    )
    kernels = [{"name": n, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[n], "on_a_render_path": n not in off_path,
                **stats[n]}
               for n, src, rep in described]
    check(all(k["launches"] > 0 for k in kernels
              if k["on_a_render_path"] or k["name"] == "occlusion_d_exit"),
          f"a kernel was never launched on its path: {launches}")
    check(launches["occlusion_w_uncapped"] == 0,
          f"a render path launched a mode that none should take: {launches}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

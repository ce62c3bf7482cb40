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
     hit (K1), the w-occlusion (K2), the segment sum (K3), the live-tile
     compacted closest hit (K4), the direction-form occlusion (K5 on
     shaft lists, K6 on generic lists seeded with the inactive lanes) and
     the tile-merged closest hit (K7, at merge 2 and 4 on K1's lists of
     the opaque primary, the mirror bounce and the 65,536-triangle
     primary) at the shapes of their redesign, each line tagged with the
     phase its
     inputs come from ([kernels]: the opaque primary, the masked mirror
     bounce (K1 and K4), the capped depth-0 shadow wavefront (K2, and K5 /
     K6 in the direction form), the depth-1 shadow pass of a real frame
     with the w form off (K5 / K6), the depth-0 cotangents of the packed
     rows and of the texture colours recorded from a real fit_scene
     backward;
     [glass]: the bounce-1 pool's trace (K1 and K4) and glass-flag pass
     on its live lanes, recorded from a real frame, the uncapped
     member-masked pass, the segment sums of a real glass backward over
     the packed rows of the pool and over the ior row; [scale]:
     the 65,536-triangle primary, the segment sum over its wide id band,
     and its depth-0 shadow wavefront, capped (K2) and in the direction
     form (K5 / K6)): K1, K2, K4, K5 and K6 bit-equal to the plain version
     on every lane (on 16 seeded tiles at 65,536 triangles), K4 and K7
     also to K1 (K7 to its plain version too, but at 65,536 triangles,
     where K1 is sampled) and K4's live-tile list to the plain one, K3
     within its tolerances of
     fp64 and of the plain version; list lengths, the kernel's time (10
     launches back to back between CUDA events, median of 5 after 2
     warm-ups; for K3-K6 also a single launch and the device time a
     profiler reads, which leaves the wrapper's host time out), the time
     of the same launch with every count zeroed (every tile dead: the
     fixed cost of the tiles and the output stores), for K1 with rows the
     time at kp = 0 (the rows epilogue), for K2, K5 and K6 the member
     tests a walk without any exit would do beside those the answer needs
     and the rays left after repacking, for K4 and K7 K1's times on the
     same lists, K4's tile list's device time, K7's share of sub-tiles
     that repeat their group's previous list and of groups all empty, for
     K3 the device time with
     every id -1, the bound and the no-FMA floor;
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
     loss must fall at every step); then precision: with TF32 switched on
     for the whole process (cuBLAS, cuDNN, matmul precision "medium"), the
     benchmark frame on the cluster and all-pairs backends and the 1080p
     GI frame bit-equal to the frames rendered with it off, the gradient
     within K3's tolerance of the one with it off (launch counts reset
     just before each render, read just after), the caller's settings
     read back unchanged after every render, and a product outside the
     renderer that shows the switch took effect;
  7. variants: on the forward benchmark frame's primary and masked
     mirror-bounce wavefronts (2,040 tiles) the tile-merged closest hit
     (K7) at merge 2 and 4 vs its plain version and vs the closest-hit
     kernel (K1), bit for bit, K1 and K7 timed in turns with the bound;
     then the CLI frame with the defaults (4 K1 launches) and the frame
     through a cluster tracer built with tile_merge=2 (4 K7 and no K1
     launches), whose float image equals the default one bit for bit;
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
     through the cluster tracer; frame times of the scan and grow schedules,
     of scan with compact_bounces, of the recursive tree and of scan in 8
     chunks, host syncs, device time and launches of a profiled frame,
     peak memory; then value_and_grad of the
     image sum with respect to vertices, light intensities, camera
     position and mat_ior (vs the all-pairs backend's, time and peak
     memory, with and without remat_shading; per bounce one segment sum
     for the packed rows and one for the ior row), and the backward of
     the mat_ior[tri_material] gather at 65,536 triangles on one material,
     through packed_gather as build_packed reads it and by plain indexing;
 10. gi: the GI frame (make_test_scene(1920, 1080, 64, gi_on=True), K = 4
     GI samples a diffuse hit, depth 3: 64 banks, the pool grown 1 -> 4 ->
     16 with the leaves shaded inline, in chunks of 2^24 / 16 pixels)
     through the CLI with --gi-rays 4
     (launch counts reset just before, read just after, and held to what
     the grow schedule implies: per chunk of the pool one closest hit and
     one capped shadow pass a bounce and K more at the leaf bounce), its
     PPM equal to render_image's; the image vs the all-pairs backend
     (>= 99.9 % of pixels within rtol 1e-4 / atol 1e-5: one flipped hit on
     any of a pixel's ~100 paths moves the pixel) and, on a small scene
     through both wavefronts, vs the CPU (>= 99 %: the card's f32 sin /
     cos may turn a hemisphere ray by an ulp); frame time, device time
     and launches of a profiled frame, peak memory; two render_progressive
     passes (pass 0 == render_image bit for bit, the mean of salts 0 and
     1); value_and_grad of the image sum with remat_shading (time, peak,
     launches), then with the default settings (each chunk shaded under a
     checkpoint and again in the backward: time, peak, launches, the
     gradients vs remat_shading's) and, on a 480x270 GI frame, vs the
     all-pairs backend's gradients; then [cluster-bin]: Phase A's kernel
     (csrc/cluster_bin.cu) on every bin_rays / bin_apex_shared call
     recorded from that GI frame (the grow pool's bounce shapes, 32 calls)
     and from the 1080p glass frame (16 calls), lists and counts bit-equal
     to the plain version, one launch a call, device times and bound;
 11. bitmap: the benchmark scene with its floor textured by
     docs/previews/12-01-textures.jpg (tiled by the floor's uvs, decoded
     by the stb_image-exact baseline decoder, loaded through
     scene_from_dict with asset_root docs/previews): the forward frame
     (launch counts reset just before, read just after: 4 and 4) vs the
     all-pairs backend, a small one on the card vs the CPU (>= 99.5 %: an
     ulp in u * w moves a texel edge); value_and_grad of the image sum
     with respect to bitmap_data and vertices (finite, non-zero); the
     segment sum at the texel ids of that backward (T = 230,400) vs its
     plain version and fp64, its time, device time and bound; frame
     times;
 12. aov: the five AOVs (bary, normal, depth, tri_id, albedo) of the
     opaque benchmark frame through render_aov on the cluster backend (one
     K1 launch each), and depth and tri_id of make_big_scene(65536)
     through backend="stream" (one K8 launch each): each vs the all-pairs
     backend's AOV on 8,192 sampled pixels (the same hit on >= 99.9 % of
     them, and bit for bit where the hit is the same); times;
 13. tree: the KD-tree backend (its walk one launch of csrc/tree_walk.cu)
     on the benchmark scene: its tree (nodes, leaves, leaf_size, the
     native builder, build time), the forward frame (each walk's lanes,
     launch, host reads (0) and leaf lanes; wall, device time, launches,
     peak memory; no cluster kernel) vs the cluster backend's image
     (>= 99.99 % of pixels within rtol 1e-4 / atol 1e-5) and 8,192 sampled
     primary hits vs the all-pairs backend, each of the frame's 8 walks
     through the kernel bit for bit vs the plain lock-step walk on the
     same tensors (kernel and plain times; the camera walk beside
     benchmark/harness/tree_bound.py's bound), value_and_grad of the image
     sum (time, peak, K3 launches) vs the cluster backend's gradients
     (rtol 1e-3 / atol 1e-4 of the largest entry), one primary trace of
     make_big_scene(65536) with its tree (kernel vs plain walk, bit for
     bit; time, device time) and 8,192 sampled hits vs K1's, and the CLI
     with --backend tree in a child process (a P3 image, no cluster
     kernel);
 14. utils: on the benchmark scene, render_with_stats (its trace count
     equal to the cluster kernels' launches of the same frame: its
     counting wrapper sends every pass, shadows too, through K1),
     binning_stats, trace_pixel of a mirror pixel vs the CPU's log of it
     (rtol 1e-5), check_finite, check_deterministic and
     check_grads_finite, and profile_render's Chrome trace (holding device
     kernels) in a temporary directory;
 15. occlusion-d: on the opaque bench frame's depth-0 shadow wavefront the
     direction-form occlusion kernel in its two launches, K5 (shaft lists,
     origin tiles stored once) and K6 (generic lists, seeded with the
     inactive lanes), vs the plain version lane for lane, K5 == K6 on the
     active lanes, the lanes on which K5 and the w-occlusion kernel differ
     (|n.d| against |n.w| in the parallel test), times and bounds;
 16. stream-kernels: make_big_scene(1,000,000) at 1920x1080 (62,500
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
 17. big, the large-scene main path: render_image of the 1,000,000-triangle
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
 18. layouts: the 1,000,000-triangle frame through streaming tracers
     built with layout=fused, lane and rows (launch counts reset just
     before, read just after: one closest hit and two any-hit launches, all
     of the layout's kernels); the lane and rows frames equal the fused one
     bit for bit; frame times in turns (median of 5, host clock around a
     synchronize);
 19. direction-form: the opaque bench frame through a cluster tracer
     built with shadow_kernel="d" and tile_merge=2 (4 K7 and 4 K5
     launches, no K1 and no w-form pass) and through the CLI in a child
     process with --backend pallas_stream (4 K8 + 8 K9): the two images
     equal to the 8-bit level, and within one level of the default frame
     and of the all-pairs backend's on all but 0.01 % of pixels; one frame
     shaded through a tracer built with shadow_kernel="anyhit" (4 K6
     launches), equal to the K5 frame through K1 and through K7;
 20. blender: the port's Blender add-on registered under the bpy stand-in
     of tests/mock_bpy.py; the opaque bench scene's dict imported through
     its importer (meshes, lights, camera), exported from the depsgraph and
     rendered by its engine on the card (launch counts reset just before,
     read just after: 4 K1 and 4 K2); the Combined pass equal, bit for
     bit, to render_scene_from_dict_array of the exported dict;
 21. tools: the repo's entry points outside the package
     (crt_tpu_torch/tools/): the Blender add-on staged as its zip,
     unpacked and registered under the bpy stand-in in a child process
     whose sys.path holds only the unpacked directory, tests/ and
     site-packages (crt_tpu_torch.__file__ must lie in the zip), the bench
     scene's dict imported and rendered (F12) by its engine on the card
     with the kernels built by nvcc from the zip's own sources into its
     own build/ (build and frame times, KD builder; 4 K1 + 4 K2), the
     Combined pass equal, bit for bit, to render_scene_from_dict_array
     here; render_turntable of the bench scene as a .crtscene, 4 frames
     (launch counts reset just before, read just after: 16 K1 + 16 K2;
     render and PNG ms per frame), each PNG decoded by io/png.py equal to
     quantize of its rig's render on every pixel; a 1080p file with row
     filters 0-4 in turn decoded with the C++ row filters (which decode
     must take by default) and with the NumPy ones, equal bytes, times
     beside the filter-0 decodes; golden_check (>= 0.999 of
     the pixels on both cases) and render_all (2 PPM, 2 PNG, 2 rows) on a
     corpus built here under a temporary CRT_REFERENCE: the opaque and the
     mirror variants of the test scene at 192x108 under two
     HEAD_GOLDEN_CASES names, their goldens rendered on the CPU; the CLI
     with no argument, which renders the reference CLI's default scene
     under that CRT_REFERENCE (the 1080p GI bench scene placed there: 16
     K1 + 16 K2, launch counts reset just before, read just after) to
     output.ppm, equal to the CLI given the file by path, and returns 1
     without CRT_REFERENCE;
     export_mesh_header of the bench scene (counts, header size); the
     float64 oracle on 4,096 seeded pixels of the mirror scene (>= 0.999
     within 2.5/255 of the render on the card);
 22. parallel: two gloo ranks on this card (this script again, with
     --parallel-rank; NCCL takes one rank a card), joined through a file
     store, each driving, with a warm-up call first, every count zeroed
     just before the counted call and read just after, and a plain call
     for the wall time and peak memory: the row-sharded
     bench frame (render_image_sharded: 4 K1 + 4 K2 a rank), its
     gradient (sharded_value_and_grad with respect to vertices, light
     intensities and camera position: 4 K3 a rank), the scene-partitioned
     bench frame on a 1 x 2 (rays x scene) mesh (the cluster backend on
     each rank's half of the clusters, min-combined: 8 K1 a rank, no K2)
     and the scene-partitioned make_big_scene(1,000,000) frame (the
     streaming backend on each half: 1 K8 + 2 K9 a rank); rank 0 holds
     the frames to render_image on the card (>= 99.99 % of pixels within
     rtol 1e-4 / atol 1e-5), the gradient to the one-process gradient
     (rtol 1e-3 / atol 1e-4 of the largest entry), and each rank holds
     the first K1 launch of its shard on the partitioned path, and the K8
     launch and both K9 launches of its shard on the 1M path (on
     PLAIN_TILES seeded tiles), to their plain versions bit for bit; each
     path's wall time, peak memory and all-reduce time (host seconds
     around gloo's host-staged collectives) per rank; a rank that fails
     stops both;
 23. a JSON line of the kernels, then the last line
     {"ok": true, "device": {...}}.  ``launches`` are those of the render
     paths, and ``parallel_launches`` / ``blender_launches`` each rank's
     on phase 22's paths / the engine's frame, ``tools_launches`` (K1 and
     K2) those of phase 21's add-on frame, turntable and default-scene
     CLI frame,
     ``precision_launches`` (K1, K2, K3, Phase A) those of phase 6's
     renders under each fp32 setting; Phase A's (cluster_bin) launches
     are those of the opaque, glass and GI CLI frames, by frame under
     ``main_path_launches``, its times and bound those of [cluster-bin];
     the uncapped member-masked mode of the w-occlusion kernel is on
     none of them (``on_a_render_path`` false, launches 0) and is listed
     for its comparison and times; K6 is reached through a tracer argument
     that no setting of render_image takes (``on_a_render_path`` false, the
     launches of phase 19's frame); K7's launches are those of phase 7's
     tile_merge=2 frame, K10's and K11's those of phase 18's frames.

``--profile`` runs, instead of phases 3 to 19, a torch.profiler pass over
three forward+backward frames: host enqueue time vs device kernel time,
the top device kernels, the segment-sum kernel's share and peak memory.
``--large`` runs phases 15 to 19 only.  ``--parent DIR`` builds the
kernels of another checkout (DIR/crt_tpu_torch/csrc, the same files)
beside this one's and runs only phase 4's K1-K7 shapes, K1, K2, K4-K7
also held to the other build's kernel on every lane (K3's
distance from it printed: its atomics add in another order) and every
time taken in turns (other, this, this, other), then profiles the opaque
forward and forward+backward frames, the opaque forward frame through
cluster tracers built with shadow_kernel="d" (4 K5), tile_merge=2 (4 K7)
and shadow_kernel="anyhit" (4 K6), the
glass scan frame and the glass scan frame with compact_bounces with each
build in the same turns (device time, launches, each redesigned kernel's
share); no JSON lines.  The
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
import atexit
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

BENCH = dict(width=1920, height=1080, num_quads=64)
TESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
TILE = 1024
TRAINED = ("vertices", "light_intensity", "cam_position")

# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory rate
# and dense fp32 rate outside the tensor cores.
H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12
# The member test of csrc/cluster_common.cuh: two 3-dots and a subtract for
# the plane, a divide, and per edge two 3-dots, a subtract, a multiply, an
# add.
FLOPS_PER_MEMBER = 5 + 5 + 1 + 1 + 3 * 13
# The no-FMA floor of a bit-exact member test: the kernels are built with
# -fmad=false, so each of the 50 multiplies and adds is an FP32 instruction
# of its own, and the IEEE divide is a sequence (a reciprocal at a quarter
# of the FP32 rate and about five FMA-class steps: ~9 issue slots).  At one
# FP32 instruction a lane a clock the card issues H100_FP32_FLOPS / 2 a
# second (the rate counts an FMA as two flops).
NOFMA_SLOTS_PER_MEMBER = 50 + 9
H100_FP32_ISSUE = H100_FP32_FLOPS / 2
# csrc/cluster_common.cuh CRT_VOTE_LIST: K5 / K6 pack repeated rays, and
# the any-hit walks repack, on longer lists only.
VOTE_LIST = 32
# csrc/cluster_common.cuh CRT_BATCH: clusters staged per batch barrier.
BATCH = 8


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


def smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_device():
    name = torch.cuda.get_device_name(0)
    print(f"[device] torch.cuda: {name}; count {torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi())  # name, power limit: as nvidia-smi prints them, on their own
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


@contextlib.contextmanager
def patched(owner, name, around):
    """Within the block, ``owner.name(*args, **kw)`` calls
    ``around(real, *args, **kw)``, ``real`` being the function replaced."""
    real = getattr(owner, name)
    setattr(owner, name, lambda *args, **kw: around(real, *args, **kw))
    try:
        yield
    finally:
        setattr(owner, name, real)


def keep_args(calls, keep=1):
    """An ``around`` for ``patched`` that appends the (args, kw) of the
    first ``keep`` calls to ``calls`` and calls through."""

    def around(real, *args, **kw):
        if len(calls) < keep:
            calls.append((args, kw))
        return real(*args, **kw)

    return around


def record_segsums(scene, keys=TRAINED):
    """(ids, g, T) of every segment sum that one real backward of the
    frame (value_and_grad of the image sum w.r.t. ``keys``) makes."""
    from crt_tpu_torch.ops import segsum

    calls = []

    def recording(real, ids, g, num_segments, *args, **kw):
        calls.append((ids, g, num_segments))
        return real(ids, g, num_segments, *args, **kw)

    with patched(segsum, "segment_accumulate", recording):
        image_sum_grads(scene, keys=keys)
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


def check_segsum(name, ids, g, T, tag="[kernels]"):
    """K3 vs plain, vs fp64 and vs itself on (ids [R], g [K, R]); times."""
    from crt_tpu_torch.ops import segsum

    K, R = g.shape
    out = segsum.segment_accumulate(ids, g, T)
    again = segsum.segment_accumulate(ids, g, T)
    torch.cuda.synchronize()
    rerun = float((out - again).abs().max())
    live = live_rays(ids, T)
    top = int(torch.bincount(ids[ids >= 0].long(), minlength=1).max())
    print(f"{tag} segsum {name}: K {K}, R {R}, T {T}, {live} live rays, "
          f"largest segment {top} rays; two launches differ by {rerun:.3e}")
    err, vs_plain = hold_segsum(f"{tag} segsum {name}", ids, g, T, out)

    col = torch.where((ids >= 0) & (ids < T), ids, T).long()

    def library():
        return torch.zeros((K, T + 1), device=g.device).index_add_(1, col, g)

    ms = cuda_ms(lambda: segsum.segment_accumulate(ids, g, T))
    ms_plain = cuda_ms(lambda: segsum.segment_accumulate_plain(ids, g, T))
    ms_lib = cuda_ms(library)
    b = segsum_bound(ids, g, T)
    print(f"{tag} segsum {name}: kernel {ms:.3f} ms, plain {ms_plain:.3f}"
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
                         height=BENCH["height"], seed=0, build_accel=False,
                         device=device)
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
                           height=height, seed=0, build_accel=False,
                           device=device)
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


RING_CLUSTERS = 24  # csrc/cluster_common.cuh CRT_STAGES * CRT_BATCH


def merge_counts(cl, cnt, merge):
    """What a K7 that reuses a staged list would turn on at ``merge``
    (measure/closest_hit_persistent.cu): (sub-tiles after the first of
    their group, those of them with a list, those whose list equals the
    previous sub-tile's (same count, same ids), those of them that fit the
    ring, groups, groups whose sub-tiles are all empty)."""
    c = cnt.reshape(-1, merge).long()
    on_list = (torch.arange(cl.shape[1], device=cl.device)
               < cnt[:, None]).reshape(c.shape[0], merge, -1)
    lists = torch.where(on_list, cl.reshape(c.shape[0], merge, -1), -1)
    same = (c[:, 1:] == c[:, :-1]) & (lists[:, 1:] == lists[:, :-1]).all(-1)
    same &= c[:, 1:] > 0
    return (c[:, 1:].numel(), int((c[:, 1:] > 0).sum()), int(same.sum()),
            int((same & (c[:, 1:] <= RING_CLUSTERS)).sum()), c.shape[0],
            int((c == 0).all(dim=1).sum()))


def k7_shape(tag, name, tables, o, d, k1, rows_table, merge):
    """K7 at ``merge`` on the lists of K1's shape ``k1``: bit-equal to K1
    on every lane and to its plain version (every lane, or K1's sampled
    tiles where K1 was sampled); timed beside K1 on the same lists."""
    from crt_tpu_torch.ops import cluster_trace as ct

    cl, cnt = k1["lists"]
    dead = torch.zeros_like(cnt)

    def run(lib=None, counts=cnt):
        return on(lib, lambda: ct.closest_hit_merged(
            tables, o, d, cl, counts, rows_table, merge=merge))

    def k1_run(lib=None):
        return on(lib, lambda: ct.closest_hit(tables, o, d, cl, cnt,
                                              rows_table))

    out = run()
    compare_hits(f"{tag} {name} vs K1", out, k1["out"])
    if "sampled" in k1["held"]:
        held = "bit-equal to K1 on every lane (K1 held to the plain version)"
    else:
        compare_hits(f"{tag} {name} vs plain", out,
                     ct.closest_hit_merged_plain(tables, o, d, cl, cnt,
                                                 rows_table, merge))
        held = "bit-equal to the plain version and to K1 on every lane"
    sub, live_sub, same, fits, groups, empty = merge_counts(cl, cnt, merge)
    return dict(
        tag=tag, name=name, kernel="K7", out=out, bound=k1["bound"],
        held=held,
        calls={"kernel": run, "single": run, "device": run,
               "dead": lambda lib=None: run(lib, dead),
               "dead device": lambda lib=None: run(lib, dead),
               "K1": k1_run, "K1 device": k1_run},
        timers={"single": cuda_ms, "device": device_ms,
                "dead device": device_ms, "K1 device": device_ms},
        text=(f"{k1['text']}, merge {merge}: {same} of {live_sub} live "
              f"sub-tiles after the first of their group ({sub} in all) "
              f"repeat the previous sub-tile's list ({fits} of them within "
              f"the ring's {RING_CLUSTERS} clusters); {empty} of {groups} "
              "groups all empty"))


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
    Ll = lights.shape[0]
    w = (lights[:, None, :] - point[None]).reshape(-1, 3)
    ray = torch.cat([shadow_o.repeat(Ll, 1), w], dim=1)
    packed, packed_tests = repacked_rays(ray, cnt, members)

    def run_done(counts):
        got = run(counts)
        return got[0] & got[1] if isinstance(got, tuple) else got

    walk = walk_text(run, run_done, cnt, b["member_tests"], ray,
                     model=gen is not None)
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
              f"any exit {packed_tests}; {walk}"))


def own_rays(ray, open_lanes=None, lead_only=False):
    """[R] the lanes that pack_rays gives a place: open (``open_lanes``,
    K6: the unseeded ones; None: all) and with a ray (``ray`` [R, k]: K2 o
    and w = light - p; K5 / K6 o, d and r2) that no earlier open lane of
    its warp has, bit for bit (``lead_only``: the parent's rule, that the
    warp's first open lane has not)."""
    bits = ray.contiguous().view(torch.int32).reshape(-1, 32, ray.shape[1])
    if open_lanes is None:
        open_lanes = torch.ones(bits.shape[:2], dtype=torch.bool,
                                device=ray.device)
    open_lanes = open_lanes.reshape(-1, 32)
    earlier = torch.ones(32, 32, dtype=torch.bool, device=ray.device).tril(-1)
    if lead_only:  # only the first open lane leads
        first = torch.nn.functional.one_hot(
            open_lanes.to(torch.int32).argmax(dim=1), 32).bool()
        lead = first[:, None, :] & earlier[None]
    own = []
    for w0 in range(0, bits.shape[0], 8192):  # 8,192 warps at a time
        w1 = w0 + 8192
        b = bits[w0:w1]
        same = (b[:, :, None, :] == b[:, None, :, :]).all(dim=3)
        ahead = (lead[w0:w1] if lead_only
                 else earlier & open_lanes[w0:w1, None, :])
        repeat = (same & ahead).any(dim=2)
        own.append(open_lanes[w0:w1] & ~repeat)
    return torch.cat(own).reshape(-1)


def packed_lanes(ray, cnt, open_lanes=None, lead_only=False):
    """[R] own_rays as pack_rays takes it on each tile: every earlier
    open lane's ray repeated on tiles whose list is longer than
    CRT_VOTE_LIST, the warp's first open lane's on the others (and
    everywhere with ``lead_only``, the parent's rule)."""
    lead = own_rays(ray, open_lanes, lead_only=True)
    if lead_only:
        return lead
    long_list = (cnt > VOTE_LIST).repeat_interleave(TILE)
    return torch.where(long_list, own_rays(ray, open_lanes), lead)


def repacked_rays(ray, cnt, members, open_lanes=None, pack_above=-1):
    """The packing of K2, K5 and K6: (rays walked, member tests of the
    warps they fill) on the tiles with a list.  ``ray`` [R, k] holds each
    lane's ray (K2: o and w = light - p; K5 / K6: o, d and r2); only the
    ``open_lanes`` (K6: the unseeded ones; None: all) are walked.  On a
    tile whose list is longer than ``pack_above`` clusters (K2: every
    tile; K5 / K6: CRT_VOTE_LIST) a lane whose ray is, bit for bit, an
    earlier open lane's of its warp is not walked (packed_lanes), and the
    other rays of each 256-lane unit fill ceil(n / 32) warps; on the
    others every warp with an open lane walks."""
    own = packed_lanes(ray, cnt, open_lanes).reshape(-1, 32)
    if open_lanes is None:
        open_lanes = torch.ones_like(own)
    open_lanes = open_lanes.reshape(-1, 32)
    per_unit = own.reshape(-1, 256).sum(dim=1)
    warps = torch.div(per_unit + 31, 32, rounding_mode="floor")
    unpacked = (cnt <= pack_above).repeat_interleave(TILE // 256)
    per_unit = torch.where(unpacked, open_lanes.reshape(-1, 256).sum(dim=1),
                           per_unit)
    warps = torch.where(unpacked,
                        open_lanes.reshape(-1, 8, 32).any(dim=2).sum(dim=1),
                        warps)
    live = (cnt > 0).repeat_interleave(TILE // 256)
    tests = warps * 32 * members.repeat_interleave(TILE // 256)
    return int(per_unit[live].sum()), int(tests[live].sum())


def done_batches(run_done, cnt):
    """[lanes] the batch barrier of an any-hit walk at which each lane is
    first done: the least b for which ``run_done(counts)`` ([lanes] bool:
    the kernel on every list cut to its first counts clusters) is True on
    lists cut to CRT_BATCH * b clusters; past the longest walk where
    never.  The outputs are ORs over the list in its order, so that is the
    lane's state at barrier b of the whole walk."""
    nb = (int(cnt.max()) + BATCH - 1) // BATCH
    first = None
    for b in range(nb + 1):
        done = run_done(torch.clamp(cnt, max=BATCH * b))
        if first is None:
            first = torch.full(done.shape, nb + 1, dtype=torch.int32,
                               device=done.device)
        first = torch.where(done & (first > b), b, first)
    return first


def walk_model(first, cnt, own=None, pack_above=-1, repack=True):
    """(lane tests, repacks) of an any-hit launch by WalkCount's rule
    (csrc/cluster_common.cuh walk_any_hit): at each batch barrier of a
    256-lane unit's walk, the warps with an unfinished lane test the
    batch's clusters, 32 x 16 member tests a cluster; the walk ends when no
    lane is unfinished.  On lists longer than CRT_VOTE_LIST, with
    ``repack``, the rays sit in copies of 8, 4, 2 or 1 warps that share
    each batch's clusters (so a copy's busy warps count the whole batch),
    and the unfinished lanes move to the front of a new layout when they
    would fill fewer warps than hold them or fit a smaller copy (without:
    the parent's rule).  ``first`` [lanes] is done_batches'; ``own``
    [lanes] (own_rays) the lanes pack_rays places in order on lists longer
    than ``pack_above`` (None: no packing), the other places holding no
    ray."""
    dev = first.device
    per_tile = TILE // 256
    c = cnt.repeat_interleave(per_tile)
    walked = c > 0
    at = first.reshape(-1, 256)[walked].clone()
    c = c[walked]
    if own is not None:
        own = own.reshape(-1, 256)[walked]
        order = torch.argsort((~own).to(torch.int8), dim=1, stable=True)
        placed = torch.gather(at, 1, order)
        placed = torch.where(
            torch.arange(256, device=dev) < own.sum(dim=1, keepdim=True),
            placed, 0)
        at = torch.where((c > pack_above)[:, None], placed, at)
    nb = (c + BATCH - 1) // BATCH
    long_list = c > VOTE_LIST
    group = torch.full_like(c, 256 // 32)  # warps a copy
    in_copy = torch.arange(256 // 32, device=dev)[None]
    tests = repacks = 0
    for bi in range(int(nb.max()) if nb.numel() else 0):
        done = at <= bi
        per_warp = (~done).reshape(-1, 256 // 32, 32).sum(dim=2)
        per_warp = torch.where(in_copy < group[:, None], per_warp, 0)
        live = per_warp.sum(dim=1)
        warps = (per_warp > 0).sum(dim=1)
        walking = (nb > bi) & (live > 0)
        busy = warps
        if repack:
            need = (live + 31) // 32
            regroup = torch.where(need <= 1, 1, torch.where(
                need <= 2, 2, torch.where(need <= 4, 4, 8)))
            moved = walking & long_list & ((need < warps) | (regroup < group))
            if bool(moved.any()):
                order = torch.argsort(done[moved].to(torch.int8), dim=1,
                                      stable=True)
                at[moved] = torch.gather(at[moved], 1, order)
                group = torch.where(moved, regroup, group)
                repacks += int(moved.sum())
                busy = torch.where(moved, need, warps)
        clusters = torch.clamp(c - BATCH * bi, max=BATCH)
        tests += int((busy * 32 * 16 * clusters)[walking].sum())
    return tests, repacks


def walk_counts(run):
    """(lane tests, repacks) that the kernel of ``run()`` counts
    (``crt.shadow.lane_tests``, ``crt.shadow.repacks``)."""
    from crt_tpu_torch.utils import trace as tracing

    with tracing.recording() as c:
        run()
    return c["crt.shadow.lane_tests"], c["crt.shadow.repacks"]


def walk_text(run, run_done, cnt, needed, ray, open_lanes=None,
              pack_above=-1, model=False) -> str:
    """The kernel's own lane tests and repacks beside the ``needed``
    member tests; on lists of at most CRT_VOTE_LIST clusters no repack.
    With ``model`` also walk_model's, held to the kernel's own, and the
    parent's rule's (first-lane packing, no repack); ``ray`` and
    ``open_lanes`` as own_rays takes them."""
    tests, repacks = walk_counts(run)
    if int(cnt.max()) <= VOTE_LIST:
        check(repacks == 0, f"{repacks} repacks on lists of at most "
              f"{VOTE_LIST} clusters")
    text = (f"lane tests {tests} ({tests / max(needed, 1):.2f}x needed), "
            f"repacks {repacks}")
    if model:
        first = done_batches(run_done, cnt)
        m_tests, m_repacks = walk_model(first, cnt,
                                        packed_lanes(ray, cnt, open_lanes),
                                        pack_above)
        check((m_tests, m_repacks) == (tests, repacks),
              f"the walk model reads lane tests {m_tests}, repacks "
              f"{m_repacks}; the kernel counted {tests}, {repacks}")
        p_tests, _ = walk_model(first, cnt,
                                packed_lanes(ray, cnt, open_lanes,
                                             lead_only=True),
                                pack_above, repack=False)
        text += (f" (as the walk model reads them); without the repack "
                 f"(the parent's rule) lane tests {p_tests} "
                 f"({p_tests / max(needed, 1):.2f}x needed)")
    return text


def direction_inputs(tables, shadow_o, ldir, r2, lights, act, slack):
    """K5's and K6's inputs on one shadow wavefront (shadow_o [R, 3], ldir
    [Ll, R, 3], r2 and act [Ll, R]), as the cluster tracer's ``shadow``
    with ``shadow_kernel`` "d" and "anyhit" builds them: the flat o, d, r2 and active lanes,
    K5's shaft lists (bin_rays' apex mode) and K6's generic lists."""
    from crt_tpu_torch.ops.binning import bin_rays

    Ll, R = r2.shape
    tpl = R // TILE
    o_f = shadow_o.expand(Ll, R, 3).reshape(-1, 3).contiguous()
    d_f = ldir.reshape(-1, 3).contiguous()
    a_f = act.reshape(-1)
    return dict(o=shadow_o.contiguous(), o_f=o_f, d_f=d_f,
                r2_f=r2.reshape(-1).contiguous(), a_f=a_f, tpl=tpl,
                shaft=bin_rays(tables, o_f, d_f, TILE, a_f,
                               apex=lights.repeat_interleave(tpl, dim=0),
                               apex_slack=slack),
                generic=bin_rays(tables, o_f, d_f, TILE, a_f))


def kd_shape(tag, name, tables, w, exit=False, gen=None):
    """K5 (shaft lists, origin tiles stored once) or K6 (``exit``: generic
    lists, seeded with the inactive lanes) on the direction_inputs ``w``
    of one shadow wavefront: equal to the plain version on every lane (on
    sampled tiles given ``gen``)."""
    from crt_tpu_torch.ops.cluster_trace import occlusion_d, occlusion_d_plain

    act = w["a_f"]
    if exit:
        cl, cnt = w["generic"]
        o, tpl, kw, seed = w["o_f"], 0, dict(exit=True, active=act), ~act
    else:
        cl, cnt = w["shaft"]
        o, tpl, seed = w["o"], w["tpl"], None
        kw = dict(tile_mod=tpl)
    d, r2 = w["d_f"], w["r2_f"]
    dead = torch.zeros_like(cnt)

    def run(lib=None, counts=cnt):
        return on(lib, lambda: occlusion_d(tables, o, d, r2, cl, counts,
                                           TILE, **kw))

    out = run()
    if gen is None:
        got = out
        want = occlusion_d_plain(tables, o, d, r2, cl, cnt, TILE, tpl, seed)
        held = "equal to the plain version on every lane"
    else:  # sampled tiles: the plain version walks long lists slowly
        pick = sample_tiles(cnt, gen)
        lane = torch.arange(TILE, device=cnt.device)
        rows = (pick[:, None] * TILE + lane).reshape(-1)
        src = (((pick % tpl) if tpl else pick)[:, None] * TILE
               + lane).reshape(-1)
        got = out[rows]
        want = occlusion_d_plain(
            tables, o[src].contiguous(), d[rows].contiguous(),
            r2[rows].contiguous(), cl[pick].contiguous(),
            cnt[pick].contiguous(), TILE, 0,
            None if seed is None else seed[rows].contiguous())
        held = f"equal to the plain version on {pick.numel()} sampled tiles"
    n_bad = int((got != want).sum())
    check(n_bad == 0, f"{tag} {name}: {n_bad} lanes differ from the plain "
          "version")
    rays = (o, d, r2[:, None]) + ((act[:, None],) if exit else ())
    b = walk_bound(tables, cl, cnt, rays, (out,), act.reshape(-1, TILE),
                   blocked=out.reshape(-1, TILE))
    members = tile_members(tables, cl, cnt)
    no_exit = int(members.sum()) * TILE
    ray = torch.cat([w["o_f"], d, r2[:, None]], dim=1)
    packed, packed_tests = repacked_rays(ray, cnt, members,
                                         act if exit else None,
                                         pack_above=VOTE_LIST)
    walk = walk_text(run, lambda counts: run(None, counts), cnt,
                     b["member_tests"], ray, act if exit else None,
                     pack_above=VOTE_LIST, model=gen is not None)
    lanes = cnt.numel() * TILE
    return dict(tag=tag, name=name, kernel="K6" if exit else "K5", out=(out,),
                bound=b, held=held,
                calls={"kernel": run, "single": run, "device": run,
                       "dead": lambda lib=None: run(lib, dead),
                       "dead device": lambda lib=None: run(lib, dead)},
                timers={"single": cuda_ms, "device": device_ms,
                        "dead device": device_ms},
                text=(f"{lanes} lanes in {cnt.numel()} tiles "
                      f"({int((cnt > 0).sum())} live), {int(act.sum())} "
                      f"active, list length mean "
                      f"{float(cnt.float().mean()):.3f} max {int(cnt.max())};"
                      f" {int((out & act).sum())} active lanes blocked; "
                      f"member tests without any exit {no_exit}, needed "
                      f"{b['member_tests']} "
                      f"({no_exit / max(b['member_tests'], 1):.2f}x); rays "
                      f"walked after repacking {packed} of "
                      f"{int((cnt > 0).sum()) * TILE} lanes of live tiles, "
                      f"member tests of their warps without any exit "
                      f"{packed_tests}; {walk}"))


def frame_with(scene, **kw):
    """The default forward frame of ``scene`` through a cluster tracer
    built with ``kw`` (``shadow_kernel``, ``tile_merge``)."""
    from crt_tpu_torch import RenderSettings
    from crt_tpu_torch.ops.cluster_trace import make_cluster_trace_fn
    from crt_tpu_torch.renderer import _render_flat

    with torch.no_grad():
        return _render_flat(scene, RenderSettings(),
                            trace_fn=make_cluster_trace_fn(scene, **kw))


def record_direction_frame(scene):
    """K5's inputs (shadow_o, ldir, r2, lights, act, slack) at each shading
    level of one real forward frame, shaded through a cluster tracer built
    with ``shadow_kernel="d"``, as its ``shadow`` takes them."""
    from crt_tpu_torch import RenderSettings
    from crt_tpu_torch.ops.cluster_trace import make_cluster_trace_fn
    from crt_tpu_torch.ops.shade import shade_wavefront

    trace = make_cluster_trace_fn(scene, shadow_kernel="d")
    real = trace.shadow
    calls = []

    def recording(point, shadow_o, lights, ldir, r2, act, slack):
        calls.append(tuple(x.detach().clone() if torch.is_tensor(x) else x
                           for x in (shadow_o, ldir, r2, lights, act, slack)))
        return real(point, shadow_o, lights, ldir, r2, act, slack)

    trace.shadow = recording
    st = RenderSettings()
    o, d = primary_wavefront(scene)
    with torch.no_grad():
        shade_wavefront(scene, st, trace, o, d)
    check(len(calls) == st.max_ray_depth + 1,
          f"a frame with the w form off made {len(calls)} direction-form "
          "shadow passes, expected one per shading level")
    return calls


def kernel_shapes(device):
    """K1-K7 at the shapes of PERF.md's redesign tables, in the order
    [kernels] (opaque bench frame; K5 / K6 also on the depth-1 shadow pass
    of a real frame with the w form off), [glass] (refractive bench frame,
    its bounce-1 pool's live lanes and backward recorded from a real
    frame), [scale]
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
    for merge in (2, 4):
        yield k7_shape("[kernels]", f"K7 opaque primary, merge {merge}",
                       tables, o, d, prim, rows_table, merge)
    k = prim["out"]
    refl_o, refl_d, refl_act = mirror_bounce(scene, st, o, d, k)
    bounce = k1_shape("[kernels]", "K1 opaque masked mirror bounce", tables,
                      refl_o, refl_d, refl_act, rows_table)
    yield bounce
    yield k4_shape("[kernels]", "K4 opaque masked mirror bounce", tables,
                   refl_o, refl_d, bounce, rows_table)
    for merge in (2, 4):
        yield k7_shape("[kernels]",
                       f"K7 opaque masked mirror bounce, merge {merge}",
                       tables, refl_o, refl_d, bounce, rows_table, merge)
    del bounce
    w = depth0_shadow_wavefront(scene, st, o, d, Hit(t=k[0], tri=k[1]),
                                kernel_rows=k[2])
    scl, scnt = bin_apex_shared(tables, w["shadow_o"], w["lights"], w["act"],
                                TILE, slack)
    yield k2_shape("[kernels]", "K2 capped, opaque depth-0 shadow", tables,
                   w["shadow_o"], w["point"], w["lights"], w["act"], scl,
                   scnt)
    # the same wavefront in the direction form, then the depth-1 (mirror
    # bounce) pass of a real frame shaded with the w form off
    for where, dw in (("depth-0", direction_inputs(
            tables, w["shadow_o"], w["ldir"], w["r2"], w["lights"], w["act"],
            slack)), ("depth-1 (mirror bounce)", direction_inputs(
                tables, *record_direction_frame(scene)[1]))):
        yield kd_shape("[kernels]", f"K5 opaque {where} shadow", tables, dw)
        yield kd_shape("[kernels]", f"K6 opaque {where} shadow", tables, dw,
                       exit=True)
    del prim, k, w, dw
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
    pool = k1_shape("[glass]", "K1 glass bounce-1 live lanes", tables, po, pd,
                    pact, None)
    yield pool
    yield k4_shape("[glass]", "K4 glass bounce-1 live lanes", tables, po, pd,
                   pool, None)
    del pool
    point, shadow_o, lights, act_lr, pslack = rec["shadows"][1]
    gcl, gcnt = bin_apex_shared(tables, shadow_o, lights, act_lr, TILE,
                                pslack, glass_boxes=(gmin, gmax))
    yield k2_shape("[glass]", "K2 glass-flag, bounce-1 live lanes", tables,
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
    scene = make_big_scene(**MID, seed=0, build_accel=False,
                           device=device)
    tables = build_cluster_tables(scene)
    rows_table = emit_rows_table(scene, tables)
    o, d = primary_wavefront(scene)
    prim = k1_shape("[scale]", "K1 65,536-triangle primary", tables, o, d,
                    None, rows_table, gen=gen)
    yield prim
    for merge in (2, 4):
        yield k7_shape("[scale]", f"K7 65,536-triangle primary, merge {merge}",
                       tables, o, d, prim, rows_table, merge)
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
    dw = direction_inputs(tables, w["shadow_o"], w["ldir"], w["r2"],
                          w["lights"], w["act"], slack)
    yield kd_shape("[scale]", "K5 65,536-triangle depth-0 shadow", tables,
                   dw, gen=gen)
    yield kd_shape("[scale]", "K6 65,536-triangle depth-0 shadow", tables,
                   dw, exit=True, gen=gen)


SHAPE_CALLS = {"kernel": "kernel", "single": "single launch",
               "device": "device time", "dead": "every count zeroed",
               "dead device": "device time with every count zeroed",
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
    """One shape of kernel_shapes: K1, K2, K4-K7 bit-equal to the plain
    version (every lane, or sampled tiles at 65,536 triangles), K4 and K7
    also to K1; K3 within its tolerances of fp64 and of the plain version
    (held by k3_shape).  Given ``parent`` (a library of another checkout's
    kernels, bind_parent), K1, K2, K4-K7 also equal to its kernels
    on every lane, K3 its distance printed.  Times of the shape's calls:
    cuda_ms_many unless the shape names another timer (a single launch,
    cuda_ms; device time, device_ms): the launch, the launch with every
    count zeroed (every tile dead: the fixed cost of the output stores and
    the tiles), K1 with rows at kp = 0, K4's tile list and K1 on K4's and
    K7's lists, K3 with every id -1; given ``parent``, each in turns: parent,
    new, new, parent.  Bound
    and, where the kernel tests members, no-FMA floor from this run's
    inputs.  -> dict(times, bound_ms)."""
    tag, name = sh["tag"], sh["name"]
    held = sh["held"]
    if parent is not None:
        pout = sh["calls"]["kernel"](parent)
        if sh["kernel"] in ("K1", "K4", "K7"):
            compare_hits(f"{tag} {name} vs the parent's kernel",
                         sh["out"], pout)
            held += "; equal to the parent's kernel on every lane"
        elif sh["kernel"] in ("K2", "K5", "K6"):
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
    forward+backward frames, the opaque forward frame through cluster
    tracers built with shadow_kernel="d" (K5 shadows), tile_merge=2 (K7
    closest hits) and shadow_kernel="anyhit" (K6 shadows, shaded by
    shade_wavefront), the glass scan frame and the
    glass scan frame with compact_bounces, with the parent's kernels and
    the new ones in turns (parent, new, new, parent), and the redesigned
    kernels' share of the device time."""
    from crt_tpu_torch import RenderSettings, render_image
    from crt_tpu_torch.ops import cluster_trace
    from crt_tpu_torch.ops.shade import shade_wavefront
    from crt_tpu_torch.scene.procedural import make_test_scene

    opaque = make_test_scene(**BENCH, device=device)
    glass = make_test_scene(**GLASS, device=device)
    compact = RenderSettings(compact_bounces=True)
    o, d = primary_wavefront(opaque)

    def any_hit_frame():
        with torch.no_grad():
            return shade_wavefront(
                opaque, RenderSettings(), cluster_trace.make_cluster_trace_fn(
                    opaque, shadow_kernel="anyhit"), o, d)

    frames = (("opaque forward", lambda: render_image(opaque)),
              ("opaque forward+backward", lambda: image_sum_grads(opaque)),
              ("opaque forward, w form off (K5)",
               lambda: frame_with(opaque, shadow_kernel="d")),
              ("opaque forward, tile_merge=2 (K7)",
               lambda: frame_with(opaque, tile_merge=2)),
              ("opaque frame shaded with shadow_kernel=anyhit (K6)",
               any_hit_frame),
              ("glass scan forward", lambda: render_image(glass)),
              ("glass scan forward, compact_bounces",
               lambda: render_image(glass, compact)))
    tags = {"K1": "closest_hit_kernel", "K2": "occlusion_w",
            "K3": "segment_accumulate", "K4": "closest_hit_compact_kernel",
            "K4 list": "live_tiles_kernel", "K5 / K6": "occlusion_d",
            "K7": "closest_hit_merged_kernel"}
    for name, fn in frames:
        fn()
        torch.cuda.synchronize()
        for who in ("parent", "new", "new", "parent"):
            lib = parent if who == "parent" else None
            reset_launches()
            dev_ms, n, by_tag = on(lib, lambda: profile_frame(
                fn, tags=tuple(tags.values())))
            c = counted()
            print(f"[turns] {name}, {who} kernels: device {dev_ms:.3f} ms in "
                  f"{n} launches ({c['crt.launches.occlusion_d.compact']} K5, "
                  f"{c['crt.launches.occlusion_d.exit']} K6, "
                  f"{c['crt.launches.closest_hit_merged']} K7); "
                  + ", ".join(f"{k} {by_tag[v]:.3f} ms "
                              f"({100 * by_tag[v] / dev_ms:.2f} %)"
                              for k, v in tags.items() if by_tag[v] > 0))


_RECORDING = []  # the process-long recording block of the port's registry


def reset_launches():
    """Zero the port's counters (``crt_tpu_torch/utils/trace.py``) and
    count from here: the first call opens a recording block that lasts
    the process, so every later frame is counted."""
    from crt_tpu_torch.utils import trace as tracing

    if not _RECORDING:
        block = tracing.recording()
        block.__enter__()
        _RECORDING.append(block)
        atexit.register(block.__exit__, None, None, None)
    tracing.reset()


def counted() -> dict:
    """The port's counters since the last ``reset_launches``."""
    from crt_tpu_torch.utils import trace as tracing

    return tracing.counters()


def _launches(c, kernel: str) -> int:
    from crt_tpu_torch.utils import trace as tracing

    return tracing.total(c, "crt.launches." + kernel)


def read_launches() -> dict:
    """Launch counts of the opaque frame's kernels: K1, K2, the segment
    sum and Phase A (csrc/cluster_bin.cu, summed over its modes: one
    launch before each K1 and each K2)."""
    c = counted()
    return {"closest_hit": _launches(c, "closest_hit"),
            "occlusion_w": _launches(c, "occlusion_w"),
            "segsum": _launches(c, "segsum"),
            "cluster_bin": _launches(c, "cluster_bin")}


def read_stream_launches() -> dict:
    """Launch counts of every trace kernel and the segment sum, with the
    streaming Phase A's own counts (pairs listed, device-to-host reads)."""
    c = counted()
    return {"closest_hit": _launches(c, "closest_hit"),
            "closest_hit_compact": _launches(c, "closest_hit_compact"),
            "occlusion_w": _launches(c, "occlusion_w"),
            "occlusion_d": c["crt.launches.occlusion_d.compact"],
            "occlusion_d_exit": c["crt.launches.occlusion_d.exit"],
            "closest_hit_stream": _launches(c, "closest_hit_stream"),
            "occlusion_stream": _launches(c, "occlusion_stream"),
            "segsum": _launches(c, "segsum"),
            "stream_bin": _launches(c, "stream_bin"),
            "stream_pairs": c["crt.binning.pairs.supercluster"],
            "stream_host_syncs": c["crt.host_reads.stream_pairs"]}


def read_glass_launches() -> dict:
    """Launch counts of the refractive frame's kernels, K2 by mode, and
    the march's own counts (closest-hit segments, device-to-host reads)."""
    from crt_tpu_torch.utils import trace as tracing

    c = counted()
    return {"closest_hit": _launches(c, "closest_hit"),
            "closest_hit_compact": _launches(c, "closest_hit_compact"),
            "live_tiles": _launches(c, "live_tiles"),
            "occlusion_w": c["crt.launches.occlusion_w.capped"],
            "occlusion_w_glass": c["crt.launches.occlusion_w.glass"],
            "occlusion_w_uncapped": c["crt.launches.occlusion_w.uncapped"],
            "segsum": _launches(c, "segsum"),
            "cluster_bin": _launches(c, "cluster_bin"),
            "march_traces": c["crt.march.traces"],
            "march_host_syncs": tracing.total(c, "crt.host_reads.march")}


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
    check(launches == {"closest_hit": 4, "occlusion_w": 4, "segsum": 0,
                       "cluster_bin": 8},
          f"the forward path launched {launches}, expected 4, 4, 0 and 8")

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
    at merge 2 and 4, then the frame through a tracer with tile_merge=2."""
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

    # the CLI's default frame (K1), and in process the frame through a
    # cluster tracer built with tile_merge=2 (K7)
    with tempfile.TemporaryDirectory() as tmp:
        scene_path = os.path.join(tmp, "bench.crtscene")
        with open(scene_path, "w") as f:
            json.dump(make_test_scene_dict(**BENCH), f)
        reset_launches()
        rc = cli.main([scene_path, os.path.join(tmp, "default.ppm"),
                       "--device", str(device)])
        default_counts = read_launches()
    reset_launches()
    merged = frame_with(scene, tile_merge=2)
    counts = dict(read_launches(), closest_hit_merged=_launches(
        counted(), "closest_hit_merged"))
    print(f"[variants] CLI default frame: launches {default_counts}; frame "
          f"through a tracer with tile_merge=2: launches {counts}")
    check(rc == 0 and default_counts["closest_hit"] == 4,
          f"the default CLI frame launched {default_counts}")
    check(counts["closest_hit_merged"] == 4 and counts["closest_hit"] == 0
          and counts["occlusion_w"] == 4,
          f"the tile_merge=2 frame launched {counts}: expected 4 K7, no "
          "K1 and 4 shadow passes")
    check(torch.equal(merged, render_image(scene)), "the merged frame's "
          "floats differ from the default frame's")
    print("[variants] the tile_merge=2 frame's floats equal the default "
          "frame's bit for bit")
    stats = dict(max_abs_err=err, ms=ms["primary", 2], plain_ms=ms_plain,
                 library_ms=None, ms_merge4=ms["primary", 4],
                 ms_bounce=ms["bounce", 2], k1_ms=ms["primary", 1],
                 **{k: b[k] for k in ("bound_ms", "bound_by")})
    return {"closest_hit_merged": stats}, counts["closest_hit_merged"]


def assert_grads_close(name, got, want, rtol, atol_scale, tag="[train]"):
    for k in want:
        check(bool(torch.isfinite(got[k]).all()), f"{name}: {k} not finite")
        a, b = got[k].detach().cpu().double(), want[k].detach().cpu().double()
        scale = float(b.abs().max())
        diff = (a - b).abs()
        print(f"{tag} {name}: d/d{k} max |diff| {float(diff.max()):.3e} "
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
    check(launches == {"closest_hit": 4, "occlusion_w": 4, "segsum": 4,
                       "cluster_bin": 8},
          f"the training path launched {launches}, expected 4, 4, 4 and 8")
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
                           "segsum": 24, "cluster_bin": 24},
          f"fit_scene launched {fit_launches}, expected 12, 12, 24 and 24")
    check(all(bool(torch.isfinite(v).all()) for v in params.values()),
          "fit_scene returned non-finite parameters")
    return launches


GLASS = dict(BENCH, with_refractive=True)
GLASS_TRAINED = TRAINED + ("mat_ior",)


def record_glass_frame(scene):
    """The kernel inputs of one real frame of the iterative wavefront, as
    the default render shades it, in call order: ``traces`` (o, d, act) of
    each bounce's pool trace (the camera rays' full-width, every later
    bounce's on its gathered live lanes), ``shadows`` (point, shadow_o,
    lights, act [Ll, C], slack) of each bounce's glass-flag pass on the
    bounce's lanes, ``march`` (o, d, act) of every segment of the
    bend-walk.  A trace is the pool's when ``shade_local`` calls it, the
    march's otherwise."""
    from crt_tpu_torch import RenderSettings
    from crt_tpu_torch.ops.shade_iter import (
        default_banks, shade_wavefront_iter,
    )
    from crt_tpu_torch.ops.tracer import Tracer
    from crt_tpu_torch.renderer import make_trace_fn

    st = RenderSettings()
    trace = make_trace_fn(scene, st)
    o, d = primary_wavefront(scene)
    width = default_banks(scene, st) * o.shape[0]
    rec = {"traces": [], "shadows": [], "march": []}

    class Recording(Tracer):
        """The frame's cluster tracer, recording its pool traces, its
        march traces and its glass-flag passes."""

        rank = trace.rank

        def __call__(self, ro, rd, active=None):
            pool = sys._getframe(1).f_code.co_name == "shade_local"
            rec["traces" if pool else "march"].append(
                (ro.detach().contiguous(), rd.detach().contiguous(),
                 active.detach().clone()))
            return trace(ro, rd, active)

        def shadow(self, *args):
            return trace.shadow(*args)

        def shadow_glass(self, point, shadow_o, lights, act, slack):
            rec["shadows"].append((point.detach().contiguous(),
                                   shadow_o.detach().contiguous(),
                                   lights.detach().contiguous(),
                                   act.detach().clone(), slack))
            return trace.shadow_glass(point, shadow_o, lights, act, slack)

    with torch.no_grad():
        shade_wavefront_iter(scene, st, Recording(), o, d)
    bounces = st.max_ray_depth + 1
    lanes = [c[0].shape[0] for c in rec["traces"]]
    check(len(lanes) == bounces and len(rec["shadows"]) == bounces
          and [c[0].shape[0] for c in rec["shadows"]] == lanes,
          f"{len(lanes)} pool traces and {len(rec['shadows'])} glass-flag "
          "passes on the same lanes in a frame, expected one of each per "
          "bounce")
    check(lanes[0] == width and all(n % TILE == 0 and n < width
                                    for n in lanes[1:]),
          f"pool trace lanes {lanes}: expected the camera bounce "
          f"full-width ({width}) and every later one on its live lanes, "
          "whole tiles")
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

    # the second bounce's glass-flag pass: the 8-bank pool's live lanes
    # under 2 lights
    stats["occlusion_w_glass"], _ = glass_mode("bounce-1 live lanes",
                                               *rec["shadows"][1])

    # the second bounce's pool trace: the 8-bank pool's live lanes, as the
    # render gathers them
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
    print(f"[glass] closest_hit_compact on the bounce-1 live lanes: "
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
    # closest hit per segment it walked, between none and depth + 1 a pass;
    # each of them binned by one Phase A launch
    check(launches["occlusion_w_glass"] == bounces
          and launches["cluster_bin"] == launches["closest_hit"] + bounces
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
          and c_launches["occlusion_w_glass"] == bounces
          and c_launches["cluster_bin"] == launches["cluster_bin"],
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
    _, flag = trace.shadow_glass(point, shadow_o, scene.light_position, act,
                                 2.0 * st.shadow_bias)
    gate = trace.refr_ray_hit_w(point, shadow_o, scene.light_position, act,
                                2.0 * st.shadow_bias)
    gate_launches = read_glass_launches()
    check(torch.equal(flag & act, gate & act),
          "router flag and uncapped gate disagree")
    print(f"[refract] router cross-check through the cluster tracer: "
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


GI = dict(BENCH, gi_on=True)
GI_RAYS = 4  # --gi-rays: K, the default


def gi_frame_traces(st, R):
    """(widest pool level, chunks, closest hits) the grow schedule implies
    for one GI frame without glass: the pool grows K-fold a bounce up to
    K^(D - 1) banks (the leaves are shaded inline), a chunk holds
    ITER_POOL_LANES / K^(D - 1) pixels, and each chunk traces once a
    bounce and K times more for the leaves at bounce D - 1, each trace
    with one capped shadow pass."""
    from crt_tpu_torch.renderer import ITER_POOL_LANES, TILE_H, TILE_W

    D, K = st.max_ray_depth, st.diffuse_reflection_ray_count
    widest = K ** max(D - 1, 0)
    chunk = max(TILE_H * TILE_W, ITER_POOL_LANES // widest)
    chunk = chunk // (TILE_H * TILE_W) * (TILE_H * TILE_W)
    chunks = -(-R // chunk)
    return widest, chunks, chunks * (D + 1 + (K if D >= 1 else 0))


def phase_gi(device):
    """The GI frame (make_test_scene(1920, 1080, 64, gi_on=True), K = 4,
    depth 3) through the CLI and render_image, held to the all-pairs
    backend and to the CPU on a small scene; its launches, time, device
    time, banks and peak memory; two render_progressive passes; its
    gradients with remat_shading and at default settings: time, peak,
    launches, the two held together, and on a 480x270 GI frame against
    the all-pairs backend's."""
    from crt_tpu_torch import RenderSettings, render_image, render_progressive
    from crt_tpu_torch.frontend import cli
    from crt_tpu_torch.io.ppm import write_ppm
    from crt_tpu_torch.ops.shade_iter import default_banks
    from crt_tpu_torch.scene.procedural import (
        make_test_scene, make_test_scene_dict,
    )

    W, H = GI["width"], GI["height"]
    phase_t0 = time.perf_counter()

    def at():
        return f"[{time.perf_counter() - phase_t0:.1f} s into the phase]"

    st = RenderSettings(diffuse_reflection_ray_count=GI_RAYS)
    scene = make_test_scene(**GI, device=device)
    R = -(-H // 32) * 32 * (-(-W // 32) * 32)
    widest, chunks, traces = gi_frame_traces(st, R)
    with tempfile.TemporaryDirectory() as tmp:
        scene_path = os.path.join(tmp, "gi.crtscene")
        out_path = os.path.join(tmp, "gi.ppm")
        ref_path = os.path.join(tmp, "gi_in_process.ppm")
        with open(scene_path, "w") as f:
            json.dump(make_test_scene_dict(**GI), f)
        reset_launches()
        rc = cli.main([scene_path, out_path, "--device", str(device),
                       "--gi-rays", str(GI_RAYS)])
        launches = read_glass_launches()
        check(rc == 0, f"CLI exited {rc}")
        img = render_image(scene, st)
        write_ppm(img.cpu().numpy(), ref_path)
        with open(out_path) as f1, open(ref_path) as f2:
            same = f1.read() == f2.read()
    print(f"[gi] CLI wrote the {W}x{H} GI frame (K {GI_RAYS}, depth "
          f"{st.max_ray_depth}, {default_banks(scene, st)} banks under grow: "
          f"pool widths 1, {GI_RAYS}, {widest}, leaves inline; {chunks} "
          f"chunks of {-(-R // chunks)} pixels); launches {launches} {at()}")
    check(launches["closest_hit"] == traces
          and launches["occlusion_w"] == traces
          and launches["cluster_bin"] == 2 * traces
          and launches["closest_hit_compact"] == 0
          and launches["occlusion_w_glass"] == 0 and launches["segsum"] == 0,
          f"the GI frame launched {launches}: expected {traces} closest hits, "
          f"{traces} capped shadow passes ({chunks} chunks) and "
          f"{2 * traces} Phase A launches")
    check(same, "the CLI's GI PPM differs from render_image's")
    check(tuple(img.shape) == (H, W, 3) and bool(torch.isfinite(img).all())
          and float(img.mean()) > 0, "the GI image is not a finite, lit "
          "[H, W, 3]")
    ref = render_image(scene, st.replace(backend="bruteforce"))
    # one flipped hit anywhere on a pixel's ~100 paths moves that pixel
    image_agreement(f"[gi] cluster vs all-pairs backend on the card {at()}",
                    img, ref, min_frac=0.999)
    del ref

    small = make_test_scene(96, 64, num_quads=8, gi_on=True, device="cpu")
    for kw in (dict(), dict(wavefront="recursive")):
        sst = st.replace(**kw)
        cpu_img = render_image(small, sst)
        gpu_img = render_image(small.to(device), sst).cpu()
        # the card's f32 sin / cos may differ from the CPU's by an ulp and
        # turn a hemisphere ray onto another triangle at an edge
        image_agreement(f"[gi] small GI scene {kw or 'default'}, card vs "
                        f"CPU {at()}", gpu_img, cpu_img, min_frac=0.99)

    torch.cuda.reset_peak_memory_stats()
    wall, enq = host_ms(lambda: render_image(scene, st), reps=3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    reset_launches()
    dev_ms, dev_launches, by_tag = profile_frame(
        lambda: render_image(scene, st), top=8, tag="[gi]")
    n = read_glass_launches()
    print(f"[gi] forward frame: {wall:.3f} ms = {W * H / wall / 1e3:.3f} "
          f"Mrays/s of primary rays (host enqueue {enq:.3f} ms); profiled "
          f"frame: device kernels {dev_ms:.3f} ms in {dev_launches} launches; "
          f"K1 {by_tag['closest_hit']:.3f} ms, K2 {by_tag['occlusion_w']:.3f} "
          f"ms over {n['closest_hit']} / {n['occlusion_w']} launches; peak "
          f"{peak:.3f} GiB {at()}")

    means = []
    t0 = time.perf_counter()
    prog = render_progressive(scene, st, passes=2,
                              callback=lambda p, m: means.append(m.clone()))
    torch.cuda.synchronize()
    prog_s = time.perf_counter() - t0
    second = render_image(scene, st, gi_salt=1)
    check(torch.equal(means[0], img), "progressive pass 0 differs from the "
          "single-shot render")
    check(torch.allclose(prog, (img + second) / 2, rtol=0, atol=1e-6)
          and not torch.equal(second, img),
          "two progressive passes are not the mean of salts 0 and 1")
    print(f"[gi] render_progressive, 2 passes: {prog_s:.3f} s; pass 0 == "
          f"render_image bit for bit; the mean of salts 0 and 1; pass 1 "
          f"differs on {int((second != img).any(-1).sum())} px {at()}")
    del prog, second, means

    gst = st.replace(remat_shading=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    value, grads = image_sum_grads(scene, gst)
    torch.cuda.synchronize()
    g_s = time.perf_counter() - t0
    g_peak = torch.cuda.max_memory_allocated() / 2**30
    g_launches = read_glass_launches()
    print(f"[gi] value_and_grad of the GI image sum (remat_shading): value "
          f"{float(value):.6e} in {g_s:.3f} s, peak {g_peak:.3f} GiB; "
          f"launches {g_launches} {at()}")
    for k, gk in grads.items():
        check(bool(torch.isfinite(gk).all()) and bool(gk.abs().max() > 0),
              f"GI d/d{k} is not finite and non-zero")
    # default settings (no remat_shading): the graph of each chunk is held
    # in turn, each chunk shaded again in the backward (renderer.py)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    value_plain, plain = image_sum_grads(scene, st)
    torch.cuda.synchronize()
    p_s = time.perf_counter() - t0
    p_peak = torch.cuda.max_memory_allocated() / 2**30
    p_launches = read_glass_launches()
    print(f"[gi] value_and_grad of the GI image sum (default settings): "
          f"value {float(value_plain):.6e} in {p_s:.3f} s, peak "
          f"{p_peak:.3f} GiB; launches {p_launches}; {smi()} {at()}")
    check(p_launches["closest_hit"] == 2 * traces
          and p_launches["occlusion_w"] == 2 * traces,
          f"the default GI gradient launched {p_launches}: expected "
          f"{2 * traces} closest hits and shadow passes (each chunk twice)")
    assert_grads_close(f"[gi] default vs remat_shading {at()}", plain, grads,
                       rtol=1e-3, atol_scale=1e-4)
    del grads, plain
    # the gradients held to the all-pairs backend's on a 480x270 GI frame
    # (the full-width all-pairs gradient takes 90 s)
    mid = make_test_scene(**dict(GI, width=480, height=270), device=device)
    _, grads = image_sum_grads(mid, gst)
    _, ref_grads = image_sum_grads(mid, gst.replace(backend="bruteforce"))
    assert_grads_close(f"[gi] 480x270 GI frame, cluster vs bruteforce "
                       f"backend {at()}", grads, ref_grads, rtol=1e-3,
                       atol_scale=1e-4)
    return launches


def _cloned(x):
    """Tensors, also inside plain tuples and dicts, cloned; the rest as is."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if type(x) is tuple:
        return tuple(_cloned(v) for v in x)
    if isinstance(x, dict):
        return {k: _cloned(v) for k, v in x.items()}
    return x


PHASE_A = ("bin_rays", "bin_apex_shared")


def record_phase_a(scene, settings):
    """Every Phase A call of the cluster path in one frame
    (``render_image(scene, settings)``): [(entry, args, kw)], the tensors
    cloned at the call, since the wavefront may write its buffers again."""
    from crt_tpu_torch import render_image
    from crt_tpu_torch.ops import cluster_trace

    calls = []

    def keep(entry):
        def around(real, *args, **kw):
            calls.append((entry, _cloned(args), _cloned(kw)))
            return real(*args, **kw)

        return around

    with contextlib.ExitStack() as stack:
        for entry in PHASE_A:
            stack.enter_context(patched(cluster_trace, entry, keep(entry)))
        render_image(scene, settings)
    torch.cuda.synchronize()
    return calls


def phase_a_fn(entry, plain=False):
    """``binning.bin_rays`` / ``bin_apex_shared``, or its plain version."""
    from crt_tpu_torch.ops import binning

    return getattr(binning, entry + ("_plain" if plain else ""))


def phase_a_args(entry, args, kw) -> dict:
    """A Phase A call's arguments by name, defaults filled in."""
    import inspect

    bound = inspect.signature(phase_a_fn(entry)).bind(*args, **kw)
    bound.apply_defaults()
    return bound.arguments


def phase_a_bound(entry, args, kw, out) -> dict:
    """The least time of one Phase A launch: the origins (and, for the
    frustum, the directions) of the lanes the answer reads (the active
    ones: a dead lane's rays are never read), every mask byte, the
    apexes or lights, the boxes once and the lists and counts written, at
    the card's memory rate; the tests' arithmetic is far below it."""
    p = phase_a_args(entry, args, kw)
    if entry == "bin_rays":
        o, act, extra = p["origins"], p["active"], p["apex"]
        per_lane = 12 if extra is not None else 24
    else:
        o, act, extra = p["shadow_o"], p["active"], p["light_positions"]
        per_lane = 12
    if act is None:
        lanes = o.shape[0]
    else:
        lanes = int((act if act.dim() == 1 else act.any(dim=0)).sum())
    boxes = [p["tables"].cl_min, p["tables"].cl_max]
    if entry == "bin_apex_shared" and p["glass_boxes"] is not None:
        boxes += list(p["glass_boxes"])
    num_bytes = (per_lane * lanes + nbytes(act, extra, *boxes, *out))
    return bound_ms(num_bytes, 0.0)


def phase_cluster_bin(device):
    """[cluster-bin] Phase A's kernel (csrc/cluster_bin.cu) against its
    plain version on every call of one 1080p GI frame (K = 4, depth 3: the
    grow pool's bounce shapes, 32 calls) and of one 1080p glass frame (16
    calls), recorded from the frames themselves: lists and counts bit-equal,
    one launch a call, by mode; the calls' summed kernel and plain device
    times (device_ms: the profiler's device rows over 5 calls, median of
    3 traces) and the bytes bound, which the kernels line carries
    (measure/cluster_bin.py reads the host's time a call and the frames
    in turns)."""
    from crt_tpu_torch import RenderSettings
    from crt_tpu_torch.scene.procedural import make_test_scene
    from crt_tpu_torch.utils import trace as tracing

    frames = (("gi", GI, RenderSettings(diffuse_reflection_ray_count=GI_RAYS),
               32),
              ("glass", GLASS, RenderSettings(), 16))
    result = {}
    for name, kw, st, expect in frames:
        scene = make_test_scene(**kw, device=device)
        calls = record_phase_a(scene, st)
        check(len(calls) == expect, f"[cluster-bin] the {name} frame made "
              f"{len(calls)} Phase A calls, not {expect}")
        modes, shapes = {}, set()
        kernel_ms = plain_ms = bound = 0.0
        for i, (entry, args, ckw) in enumerate(calls):
            kernel, plain = phase_a_fn(entry), phase_a_fn(entry, plain=True)
            reset_launches()
            got = kernel(*args, **ckw)
            c = counted()
            mode = [k.rsplit(".", 1)[1] for k, v in c.items()
                    if k.startswith("crt.launches.cluster_bin.") and v]
            check(len(mode) == 1 and tracing.total(c, "crt.launches") == 1,
                  f"[cluster-bin] {name} call {i} ({entry}) launched {c}")
            want = plain(*args, **ckw)
            torch.cuda.synchronize()
            check(torch.equal(got[0], want[0])
                  and torch.equal(got[1], want[1]),
                  f"[cluster-bin] {name} call {i} ({entry}, {mode[0]}): "
                  f"lists or counts differ from the plain version "
                  f"({int((got[1] != want[1]).sum())} counts)")
            modes[mode[0]] = modes.get(mode[0], 0) + 1
            shapes.add((mode[0], tuple(got[0].shape)))
            kernel_ms += device_ms(lambda: kernel(*args, **ckw), calls=5)
            plain_ms += device_ms(lambda: plain(*args, **ckw), calls=5)
            bound += phase_a_bound(entry, args, ckw, got)["bound_ms"]
        print(f"[cluster-bin] {name} frame: {len(calls)} calls bit-equal to "
              f"the plain version, one launch each, by mode {modes}; lists "
              f"{sorted(shapes)}; device time {kernel_ms:.4f} ms "
              f"(plain {plain_ms:.4f}) / bound {bound:.4f} ms (bytes); "
              f"{smi()}")
        result[name] = {"calls": len(calls), "modes": modes,
                        "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                        "bound_ms": bound}
        del calls, scene
        torch.cuda.empty_cache()
    return result


PREVIEWS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "docs",
                        "previews")
BITMAP_FILE = "12-01-textures.jpg"  # a baseline JPEG, 640x360
BITMAP_KEYS = ("bitmap_data", "vertices")


def phase_bitmap(device):
    """The benchmark scene with its floor textured by BITMAP_FILE (tiled
    4 x 4 by the floor's uvs), loaded through scene_from_dict with
    asset_root docs/previews: the forward frame (4 K1, 4 K2) held to the
    all-pairs backend, a small one on the card to the CPU; value_and_grad
    of the image sum with respect to bitmap_data and vertices (finite,
    non-zero); K3 at the texel ids of that backward, T = 1 x 360 x 640,
    against its plain version and fp64, with its times and bound; frame
    times.  -> K3's numbers at the texel ids."""
    from crt_tpu_torch import RenderSettings, render_image, scene_from_dict
    from crt_tpu_torch.ops import segsum
    from crt_tpu_torch.scene.procedural import make_test_scene_dict

    W, H = BENCH["width"], BENCH["height"]
    t0 = time.perf_counter()
    scene = scene_from_dict(make_test_scene_dict(**BENCH,
                                                 floor_bitmap=BITMAP_FILE),
                            asset_root=PREVIEWS, device=device)
    load_s = time.perf_counter() - t0
    B, Hm, Wm, _ = scene.bitmap_data.shape
    T = B * Hm * Wm
    check((B, Hm, Wm) == (1, 360, 640) and 3 in scene.texture_types_present,
          f"the bitmap scene has bitmap_data {tuple(scene.bitmap_data.shape)}")
    reset_launches()
    img = render_image(scene)
    launches = read_launches()
    print(f"[bitmap] {BITMAP_FILE} decoded and loaded in {load_s:.3f} s; "
          f"the {W}x{H} frame's launches {launches}")
    check(launches == {"closest_hit": 4, "occlusion_w": 4, "segsum": 0,
                       "cluster_bin": 8},
          f"the bitmap frame launched {launches}, expected 4, 4, 0 and 8")
    check(tuple(img.shape) == (H, W, 3) and bool(torch.isfinite(img).all()),
          "the bitmap image is not a finite [H, W, 3]")
    ref = render_image(scene, RenderSettings(backend="bruteforce"))
    image_agreement("[bitmap] cluster vs all-pairs backend on the card", img,
                    ref)
    del ref
    small = scene_from_dict(make_test_scene_dict(64, 36, num_quads=12,
                                                 floor_bitmap=BITMAP_FILE),
                            asset_root=PREVIEWS, device="cpu")
    # a texel index is an integer function of one f32 product u * w: an
    # ulp between the devices moves a pixel at a texel edge
    image_agreement("[bitmap] small scene, card vs CPU",
                    render_image(small.to(device)).cpu(), render_image(small),
                    min_frac=0.995)

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    value, grads = image_sum_grads(scene, keys=BITMAP_KEYS)
    torch.cuda.synchronize()
    g_s = time.perf_counter() - t0
    g_peak = torch.cuda.max_memory_allocated() / 2**30
    g_launches = read_launches()
    for k, gk in grads.items():
        check(bool(torch.isfinite(gk).all()) and bool(gk.abs().max() > 0),
              f"bitmap d/d{k} is not finite and non-zero")
    texels = int((grads["bitmap_data"].abs().sum(-1) > 0).sum())
    print(f"[bitmap] value_and_grad of the image sum w.r.t. "
          f"{', '.join(BITMAP_KEYS)}: value {float(value):.6e} in {g_s:.3f} "
          f"s, peak {g_peak:.3f} GiB; {texels} of {T} texels have a "
          f"gradient; launches {g_launches}")
    del grads
    calls = [c for c in record_segsums(scene, keys=BITMAP_KEYS) if c[2] == T]
    check(len(calls) == 4, f"the backward summed over the texel ids "
          f"{len(calls)} times, expected 4 (one per shading level)")
    ids, g, _ = most_live(calls)
    stats = check_segsum("texel ids, the bitmap frame's depth-0 cotangents",
                         ids, g, T, tag="[bitmap]")
    stats["device_ms"] = device_ms(
        lambda: segsum.segment_accumulate(ids, g, T))
    print(f"[bitmap] segsum at texel ids: device {stats['device_ms']:.4f} ms "
          f"against the bound {stats['bound_ms']:.4f} ms "
          f"({stats['bound_by']})")
    del calls, ids, g

    wall, enq = host_ms(lambda: render_image(scene))
    gwall, _ = host_ms(lambda: image_sum_grads(scene, keys=BITMAP_KEYS),
                       reps=3)
    print(f"[bitmap] forward frame {wall:.3f} ms = {W * H / wall / 1e3:.3f} "
          f"Mrays/s (host enqueue {enq:.3f} ms), forward+backward {gwall:.3f} "
          f"ms; {smi()}")
    return stats


def aov_bruteforce_agreement(name, scene, settings, img, aov, gen, n=8192):
    """An AOV image vs the all-pairs backend's AOV of ``n`` sampled
    pixels: the backends' hits agree on at least 99.9 % of them, and where
    they do, every AOV value is the same bit for bit (it is a function of
    the ray and the hit triangle alone)."""
    from crt_tpu_torch.ops import camera, intersect
    from crt_tpu_torch.renderer import aov_values, make_tiler, make_trace_fn

    W, H = scene.width, scene.height
    rx, ry, _ = make_tiler(H, W, device=img.device)
    o, d = camera.generate_rays(scene.cam_position, scene.cam_rotation,
                                scene.cam_tan_half_fov, W, H, rx, ry)
    o = o.contiguous()
    inside = torch.nonzero((rx < W) & (ry < H)).flatten()
    rays = inside[torch.randperm(inside.numel(), generator=gen)[:n]
                  .to(img.device)]
    # the backend's own hits on those rays (one launch, outside any count)
    tri = make_trace_fn(scene, settings)(o, d, None).tri[rays]
    td = intersect.build_triangle_data(
        scene.vertices, scene.tri_vidx,
        scene.mat_backface[scene.tri_material.long()])
    bf = intersect.closest_hit_bruteforce(td, o[rays], d[rays], ray_chunk=256)
    want = aov_values(scene, o[rays], d[rays], bf, aov)
    got = img[ry[rays].long(), rx[rays].long()]
    same = tri == bf.tri
    equal = (got == want).all(-1)
    print(f"{name} vs the all-pairs backend on {n} pixels: "
          f"{int((~same).sum())} hits differ; {int((same & ~equal).sum())} "
          f"pixels with the same hit differ")
    check(int((~same).sum()) <= n // 1000,
          f"{name}: {int((~same).sum())} of {n} hits differ")
    check(bool(equal[same].all()),
          f"{name}: pixels with the same hit differ from the all-pairs AOV")


def phase_aov(device):
    """The five AOVs of the opaque benchmark frame on the cluster backend
    (one K1 launch each) and depth and tri_id of the 65,536-triangle scene
    through backend="stream" (one K8 launch each), each held to the
    all-pairs backend on 8,192 sampled pixels and timed."""
    from crt_tpu_torch import RenderSettings, render_aov
    from crt_tpu_torch.renderer import AOVS
    from crt_tpu_torch.scene.procedural import make_big_scene, make_test_scene

    W, H = BENCH["width"], BENCH["height"]
    gen = torch.Generator().manual_seed(3)
    scene = make_test_scene(**BENCH, device=device)
    big = make_big_scene(**MID, build_accel=False, device=device)
    for sc, st, names, what in (
            (scene, RenderSettings(), AOVS, "opaque, cluster"),
            (big, RenderSettings(backend="stream"), ("depth", "tri_id"),
             "65,536 triangles, stream")):
        for aov in names:
            reset_launches()
            img = render_aov(sc, st, aov)
            n = read_stream_launches()
            check(tuple(img.shape) == (H, W, 3)
                  and bool(torch.isfinite(img).all()),
                  f"the {aov} AOV is not a finite [H, W, 3]")
            want = ({"closest_hit_stream": 1, "closest_hit": 0}
                    if st.backend == "stream"
                    else {"closest_hit_stream": 0, "closest_hit": 1})
            check(all(n[k] == v for k, v in want.items())
                  and n["occlusion_w"] == 0 and n["occlusion_stream"] == 0,
                  f"the {aov} AOV ({what}) launched {n}, expected {want}")
            aov_bruteforce_agreement(f"[aov] {aov} ({what})", sc, st, img,
                                     aov, gen)
            ms = cuda_ms(lambda: render_aov(sc, st, aov))
            print(f"[aov] {aov} ({what}): {ms:.3f} ms a {W}x{H} frame; "
                  f"launches {want}")
    print(f"[aov] {smi()}")


@contextlib.contextmanager
def record_walks(keep=False):
    """Within the block, each call of traverse.closest_hit_tree appends a
    dict to the list yielded: its live ``lanes``, and what it counted of
    ``launches`` (``crt.launches.tree_walk``), ``host_reads``,
    ``iterations`` and ``leaf_lanes``; with ``keep`` also ``args``, the
    flat (accel, tri, o, d, active) it walked, cloned."""
    from crt_tpu_torch.ops import traverse
    from crt_tpu_torch.utils import trace as tracing

    walks = []

    def logged(real, accel, tri, origins, dirs, active=None):
        with tracing.recording() as c:
            hit = real(accel, tri, origins, dirs, active)
        w = {"lanes": (origins[..., 0].numel() if active is None
                       else int(active.sum())),
             "launches": c["crt.launches.tree_walk"],
             "host_reads": c["crt.host_reads.tree_walk"],
             "iterations": c["crt.tree.iterations"],
             "leaf_lanes": c["crt.tree.leaf_lanes"]}
        if keep:
            w["args"] = (accel, tri, origins.reshape(-1, 3).clone(),
                         dirs.reshape(-1, 3).clone(),
                         None if active is None
                         else active.reshape(-1).clone())
        walks.append(w)
        return hit

    with patched(traverse, "closest_hit_tree", logged):
        yield walks


def tree_walk_bound(scene, o, d, t_hit) -> dict:
    """The least time of the KD walk of rays ``o``, ``d`` whose hits lie
    at ``t_hit``: ``benchmark/harness/tree_bound.py``'s count (its frozen
    builder, the boxes each ray enters by its hit's t and the members of
    the leaves among them) at ``harness/roofline.py``'s peaks."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "benchmark"))
    from harness import roofline
    from harness import tree_bound as tb

    tree = {k: torch.from_numpy(v).to(o.device) for k, v in tb.build_tree(
        scene.vertices.detach().cpu().numpy(),
        scene.tri_vidx.cpu().numpy()).items()}
    boxes, tests = tb.entered(tree, o, d, t_hit)
    num_bytes = (tree["node_min"].shape[0] * tb.NODE_BYTES
                 + tree["leaf_tris"].numel() * tb.LEAF_SLOT_BYTES
                 + scene.num_triangles * tb.PLANE_BYTES
                 + o.shape[0] * (roofline.RAY_BYTES + roofline.ANSWER_BYTES))
    flops = boxes * tb.FLOPS_PER_BOX + tests * roofline.FLOPS_PER_MEMBER
    return {**roofline.bound_ms(num_bytes, flops), "box_tests": boxes,
            "member_tests": tests}


def tree_walk_parity(walks, tag="[tree]"):
    """Each recorded walk through the kernel and the plain lock-step walk
    on the same tensors: bit for bit, and the kernel's time (CUDA events,
    10 launches back to back) beside the plain walk's (host clock around a
    synchronize).  Returns each walk's (kernel ms, plain ms)."""
    from crt_tpu_torch.ops import traverse

    times = []
    for i, w in enumerate(walks):
        accel, tri, o, d, act = w["args"]
        k = traverse.walk(accel, tri, o, d, act)
        p = traverse.closest_hit_tree_plain(accel, tri, o, d, act)
        torch.cuda.synchronize()
        check(torch.equal(k[1], p[1])
              and torch.equal(k[0].view(torch.int32), p[0].view(torch.int32)),
              f"{tag} walk {i}: the kernel differs from the plain walk")
        k_ms = cuda_ms_many(lambda: traverse.walk(accel, tri, o, d, act))
        p_ms, _ = host_ms(lambda: traverse.closest_hit_tree_plain(
            accel, tri, o, d, act), reps=3)
        times.append((k_ms, p_ms))
        print(f"{tag} walk {i}: {o.shape[0]} rays, {w['lanes']} live, "
              f"{w['leaf_lanes']} leaf lanes: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.3f} ms; bit-equal")
    return times


def phase_tree(device):
    """The KD-tree backend (its walk one launch of csrc/tree_walk.cu): the
    opaque benchmark scene's tree (native builder), its forward frame
    (wall, device, each walk's launch, host reads and leaf lanes, peak)
    held to the cluster backend's image and to the all-pairs backend's
    hits, each of the frame's 8 walks through the kernel held bit for bit
    to the plain lock-step walk and timed beside it and (the camera walk)
    its bound, its gradient (K3 launches) held to the cluster backend's,
    one primary trace of the 65,536-triangle scene held to K1's hits, and
    a --backend tree CLI child."""
    from crt_tpu_torch import RenderSettings, render_image
    from crt_tpu_torch.ops import traverse
    from crt_tpu_torch.renderer import make_trace_fn
    from crt_tpu_torch.scene import accel as accel_mod
    from crt_tpu_torch.scene.procedural import (
        make_big_scene, make_test_scene, make_test_scene_dict,
    )

    W, H = BENCH["width"], BENCH["height"]
    tree = RenderSettings(backend="tree")
    gen = torch.Generator().manual_seed(5)
    scene = make_test_scene(**BENCH, device=device)
    verts = scene.vertices.cpu().numpy()
    idx = scene.tri_vidx.cpu().numpy()
    t0 = time.perf_counter()
    acc = accel_mod.build_accel_tree(verts, idx, device=device)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    print(f"[tree] opaque scene ({scene.num_triangles} triangles): "
          f"{acc.num_nodes} nodes, {acc.num_leaves} leaves, leaf_size "
          f"{acc.leaf_size}, builder {accel_mod.last_builder}, build "
          f"{build_ms:.3f} ms")
    check(accel_mod.last_builder == "native",
          "the native tree builder did not build or load")
    check(acc.num_nodes == scene.accel.num_nodes
          and torch.equal(acc.leaf_tris, scene.accel.leaf_tris),
          "the loader's tree differs from a fresh build")

    # the forward frame: one walk launch a walk, no host read
    reset_launches()
    with record_walks(keep=True) as walks:
        img = render_image(scene, tree)
        torch.cuda.synchronize()
    kernels = read_launches()
    check(tuple(img.shape) == (H, W, 3) and bool(torch.isfinite(img).all()),
          "the tree frame is not a finite [H, W, 3]")
    check(all(v == 0 for v in kernels.values()),
          f"the tree frame launched a cluster kernel: {kernels}")
    check(len(walks) == 8
          and all(w["launches"] == 1 and w["host_reads"] == 0
                  for w in walks),
          "a walk of the tree frame was not one launch without a host "
          f"read: {[(w['launches'], w['host_reads']) for w in walks]}")
    print(f"[tree] forward frame: {len(walks)} walks (live lanes, leaf "
          f"lanes): {[(w['lanes'], w['leaf_lanes']) for w in walks]}; "
          f"{sum(w['leaf_lanes'] for w in walks)} leaf lanes, "
          f"{sum(w['launches'] for w in walks)} walk launches, "
          f"{sum(w['host_reads'] for w in walks)} walk host reads; "
          f"cluster kernel launches {kernels}")
    times = tree_walk_parity(walks)
    o, d = walks[0]["args"][2:4]
    b = tree_walk_bound(scene, o, d, traverse.walk(*walks[0]["args"])[0])
    cam_ms = times[0][0]
    print(f"[tree] the 8 walks: kernel {sum(k for k, _ in times):.4f} ms, "
          f"plain {sum(p for _, p in times):.3f} ms; the camera walk "
          f"{cam_ms:.4f} ms / bound {b['bound_ms']:.5f} ms "
          f"({b['bound_by']}: {b['box_tests']} box tests, "
          f"{b['member_tests']} member tests, pruned at the walk's hits), "
          f"{100 * b['bound_ms'] / cam_ms:.3f} % of its roofline")
    for w in walks:
        del w["args"]
    torch.cuda.empty_cache()
    wall, enq = host_ms(lambda: render_image(scene, tree), reps=3)
    dev_ms, launches, _ = profile_frame(lambda: render_image(scene, tree),
                                        top=8, tag="[tree]",
                                        tags=("tree_walk",))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    render_image(scene, tree)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[tree] forward frame {wall:.3f} ms wall (enqueue {enq:.3f}) = "
          f"{W * H / wall / 1e3:.3f} Mrays/s; device {dev_ms:.3f} ms in "
          f"{launches} launches; peak {peak:.3f} GiB")

    ref = render_image(scene)
    image_agreement("[tree] tree vs cluster backend", img, ref)
    o, d = primary_wavefront(scene)
    hit = make_trace_fn(scene, tree)(o, d)
    bruteforce_agreement("[tree] primary hits", scene, o, d, hit.t, hit.tri,
                         gen, device)

    # the gradient: the backward of the packed-row reads is K3
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    g0 = time.perf_counter()
    value, grads = image_sum_grads(scene, tree)
    torch.cuda.synchronize()
    g_ms = (time.perf_counter() - g0) * 1e3
    g_peak = torch.cuda.max_memory_allocated() / 2**30
    k3 = read_launches()["segsum"]
    print(f"[tree] value_and_grad of the image sum: value "
          f"{float(value):.6e}, {g_ms:.3f} ms (first call), peak "
          f"{g_peak:.3f} GiB, K3 launches {k3}")
    check(k3 > 0, "the tree backward launched no segment sum")
    _, ref_g = image_sum_grads(scene)
    assert_grads_close("[tree] tree vs cluster backend", grads, ref_g,
                       rtol=1e-3, atol_scale=1e-4)
    g_wall, _ = host_ms(lambda: image_sum_grads(scene, tree), reps=3)
    print(f"[tree] value_and_grad {g_wall:.3f} ms wall (median of 3)")
    del grads, ref_g
    torch.cuda.empty_cache()

    # one primary trace at 65,536 triangles, held to K1's hits
    t0 = time.perf_counter()
    big = make_big_scene(**MID, device=device)
    torch.cuda.synchronize()
    mk_s = time.perf_counter() - t0
    print(f"[tree] 65,536 triangles: {big.accel.num_nodes} nodes, "
          f"{big.accel.num_leaves} leaves, leaf_size {big.accel.leaf_size}, "
          f"builder {accel_mod.last_builder}, scene and tree built in "
          f"{mk_s:.3f} s")
    o, d = primary_wavefront(big)
    trace = make_trace_fn(big, tree)
    with record_walks(keep=True) as walks:
        hit = trace(o, d)
        torch.cuda.synchronize()
    (k_ms, p_ms), = tree_walk_parity(walks, tag="[tree] 65,536 triangles:")
    del walks
    wall, enq = host_ms(lambda: trace(o, d), reps=3)
    dev_ms, launches, _ = profile_frame(lambda: trace(o, d), tag="[tree]",
                                        tags=("tree_walk",))
    print(f"[tree] 65,536-triangle primary trace: {wall:.3f} ms wall "
          f"(enqueue {enq:.3f}), device {dev_ms:.3f} ms in {launches} "
          f"launches; kernel {k_ms:.4f} ms, plain walk {p_ms:.3f} ms")
    reset_launches()
    k1 = make_trace_fn(big, RenderSettings(backend="cluster"))(o, d)
    check(read_launches()["closest_hit"] == 1,
          "the cluster backend did not take K1 at 65,536 triangles")
    rays = torch.randperm(o.shape[0], generator=gen)[:8192].to(device)
    hits_agreement("[tree] 65,536-triangle primary", hit.t[rays],
                   hit.tri[rays], k1.t[rays], k1.tri[rays], "K1")
    del big, trace, hit, k1
    torch.cuda.empty_cache()

    # the CLI
    with tempfile.TemporaryDirectory() as tmp:
        scene_path = os.path.join(tmp, "bench.crtscene")
        out_path = os.path.join(tmp, "tree.ppm")
        with open(scene_path, "w") as f:
            json.dump(make_test_scene_dict(**BENCH), f)
        counts = cli_child([scene_path, out_path, "--backend", "tree",
                            "--device", str(device)], {})
        with open(out_path) as f:
            tokens = f.read().split()
    check(tokens[:4] == ["P3", str(W), str(H), "255"]
          and len(tokens) == 4 + W * H * 3,
          f"the --backend tree CLI wrote a bad PPM {tokens[:4]}")
    check(all(v == 0 for v in counts.values()),
          f"the --backend tree CLI launched a cluster kernel: {counts}")
    print(f"[tree] the --backend tree CLI wrote a {W}x{H} P3 image; cluster "
          f"kernel launches {counts}")
    print(f"[tree] {smi()}")
    return k3


def phase_utils(device):
    """The utilities on the opaque benchmark scene on the card:
    render_with_stats (its trace count equal to the cluster launches of
    the same frame), binning_stats, trace_pixel of one mirror pixel vs the
    CPU's log of it, the three numerical checks, and profile_render's
    Chrome trace."""
    import shutil

    import numpy as np

    from crt_tpu_torch import RenderSettings
    from crt_tpu_torch.renderer import make_tiler, make_trace_fn
    from crt_tpu_torch.scene.procedural import make_test_scene
    from crt_tpu_torch.scene.types import MATERIAL_REFLECTIVE
    from crt_tpu_torch.utils import checks, debug, metrics

    scene = make_test_scene(**BENCH, device=device)
    metrics.render_with_stats(scene)  # the kernels' first use
    reset_launches()
    img, stats = metrics.render_with_stats(scene)
    n = read_launches()
    print(f"[utils] render_with_stats: {stats.as_dict()}; launches {n}")
    check(bool(torch.isfinite(img).all()), "render_with_stats: not finite")
    check(stats.num_traces == n["closest_hit"] + n["occlusion_w"],
          f"render_with_stats counted {stats.num_traces} traces, the "
          f"cluster kernels launched {n}")
    bins = metrics.binning_stats(scene)
    print(f"[utils] binning_stats: {bins}")
    check(0 < bins["mean_clusters_per_tile"] <= bins["clusters"]
          and 0.0 <= bins["cull_ratio"] < 1.0
          and bins["tiles"] == (-(-BENCH["width"] // 32))
          * (-(-BENCH["height"] // 32)), f"binning_stats: {bins}")

    # a pixel whose primary hit is a mirror, so its log has bounces
    o, d = primary_wavefront(scene)
    tri = make_trace_fn(scene, RenderSettings())(o, d).tri
    mat = scene.mat_type[scene.tri_material[tri.clamp(min=0).long()]]
    rx, ry, _ = make_tiler(scene.height, scene.width, device=device)
    mirror = ((tri >= 0) & (mat == MATERIAL_REFLECTIVE)
              & (rx < scene.width) & (ry < scene.height)).nonzero()[:, 0]
    check(mirror.numel() > 0, "no primary ray hits a mirror")
    lane = int(mirror[mirror.numel() // 2])
    x, y = int(rx[lane]), int(ry[lane])
    got = debug.trace_pixel(scene, x, y)
    want = debug.trace_pixel(scene.to("cpu"), x, y)
    check(len(got.entries) == len(want.entries) >= 3,
          f"trace_pixel: {len(got.entries)} rays on the card, "
          f"{len(want.entries)} on the CPU")
    worst = 0.0
    for g, w in zip(got.entries, want.entries):
        check(g.order == w.order and np.isfinite(g.length)
              == np.isfinite(w.length), "trace_pixel: the logs differ")
        for a, b in ((g.origin, w.origin), (g.direction, w.direction),
                     (np.array([g.length]), np.array([w.length]))):
            fin = np.isfinite(b)
            check(np.allclose(a[fin], b[fin], rtol=1e-5, atol=1e-6),
                  f"trace_pixel: card {a} vs CPU {b}")
            if fin.any():
                worst = max(worst, float(np.max(
                    np.abs(a[fin] - b[fin]) / np.maximum(np.abs(b[fin]),
                                                         1e-30))))
    check(np.allclose(got.color, want.color, rtol=1e-5, atol=1e-7),
          f"trace_pixel: colour {got.color} on the card, {want.color} on "
          "the CPU")
    print(f"[utils] trace_pixel({x}, {y}): {len(got.entries)} rays, the "
          f"card's log within {worst:.3e} (relative) of the CPU's; colour "
          f"{got.color} (CPU {want.color}); first replay line "
          f"{got.to_blender_script().splitlines()[0][:80]}...")

    t0 = time.perf_counter()
    checks.check_finite(scene)
    t1 = time.perf_counter()
    checks.check_deterministic(scene)
    t2 = time.perf_counter()
    grads = checks.check_grads_finite(scene)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    print(f"[utils] check_finite {t1 - t0:.3f} s, check_deterministic "
          f"{t2 - t1:.3f} s, check_grads_finite {t3 - t2:.3f} s "
          f"({sorted(grads)}): all pass")

    logdir = tempfile.mkdtemp(prefix="crt_tpu_torch_profile_")
    try:
        _, pstats, _ = metrics.profile_render(scene, logdir=logdir)
        path = os.path.join(logdir, "trace.json")
        check(os.path.getsize(path) > 0, "profile_render wrote no trace")
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        kernels = sum(1 for e in events if e.get("cat") == "kernel")
        print(f"[utils] profile_render wrote {path} "
              f"({os.path.getsize(path)} bytes, {len(events)} events, "
              f"{kernels} device kernels); {pstats.num_traces} traces")
        check(kernels > 0, "profile_render's trace holds no device kernel")
    finally:
        shutil.rmtree(logdir, ignore_errors=True)


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
    slack = 2.0 * st.shadow_bias
    dw = direction_inputs(tables, w["shadow_o"], w["ldir"], w["r2"],
                          w["lights"], w["act"], slack)
    o_f, d_f, r2_f, a_f, tpl = (dw[k] for k in ("o_f", "d_f", "r2_f", "a_f",
                                                "tpl"))
    act_t = a_f.reshape(-1, TILE)

    cl, cnt = dw["shaft"]
    k5_args = (tables, w["shadow_o"], d_f, r2_f, cl, cnt, TILE)
    k5 = occlusion_d(*k5_args, tile_mod=tpl)
    masks_equal("occlusion_d (K5)", k5,
                occlusion_d_plain(*k5_args, tile_mod=tpl))
    gl, gcnt = dw["generic"]
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
    hits_agreement(name, t[rays], tri[rays], bf.t, bf.tri, "bruteforce")


def hits_agreement(name, t, tri, t_ref, tri_ref, ref_name):
    """Sampled hits (t, tri) vs a reference backend's on the same rays: at
    most one in 1,024 ids differ (exact-t ties), and t within rtol 1e-5
    where they agree."""
    n = tri.numel()
    same = tri == tri_ref
    n_dis = int((~same).sum())
    both = same & (tri_ref >= 0)
    rel = (t[both] - t_ref[both]).abs() / t_ref[both].abs().clamp(min=1e-30)
    max_rel = float(rel.max()) if bool(both.any()) else 0.0
    print(f"{name} vs {ref_name} on {n} rays: {n_dis} tri disagreements, "
          f"max rel t diff {max_rel:.3e} where tri agree ({int(both.sum())} "
          "hits)")
    check(n_dis <= n // 1024, f"{n_dis} of {n} rays disagree with {ref_name}")
    check(max_rel <= 1e-5, f"t differs from {ref_name} by {max_rel:.3e}")


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
    scene = make_big_scene(**BIG, seed=0, build_accel=False,
                           device=device)
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
    pair_sc, bits, start = sb.bin_stream(*stt._boxes(st), o, d, TILE)
    ms_pa = cuda_ms(lambda: sb.bin_stream(*stt._boxes(st), o, d, TILE))
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
    stats["stream_bin"] = phase_stream_bin(scene)

    # ---- a scene both backends hold: K8 == K1, K9 == K5
    mid = make_big_scene(**MID, seed=0, build_accel=False,
                           device=device)
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


# FP32 operations of Phase A's streaming kernel (csrc/stream_bin.cu): one
# per-lane slab test (per axis two subtracts, two divides, a min and a max;
# the entry and exit folds and three compares), one frustum box test (per
# axis two subtracts, two divides, a clamp, a max and a min; two compares)
# and one shaft box test (the capped slab, the cone's twenty and six wedges
# of four divides and six min / max).
LANE_TEST_FLOPS = 3 * 6 + 4 + 3
FRUSTUM_BOX_FLOPS = 3 * 7 + 2
SHAFT_BOX_FLOPS = FRUSTUM_BOX_FLOPS + 20 + 6 * 12


def stream_bin_bound(mode, p, out, hull) -> dict:
    """The least time of one ``bin_stream`` call (arguments by name ``p``):
    each lane's origin, and its direction (frustum and per-lane test), reach
    (per-lane test) and mask byte read once, the supercluster boxes and
    each listed pair's member boxes once, the list written; or the box
    tests of every (tile, supercluster) and (pair, member) and the
    per-lane tests of the hull's pairs at the fp32 peak."""
    R = p["origins"].shape[0]
    tiles = R // p["tile_rays"]
    L2 = p["sc_min"].shape[0]
    sc = p["cl_min"].shape[0] // L2
    P = out[0].shape[0]
    per_lane = (12 + (12 if mode in ("rays", "shaft_exact") else 0)
                + (4 if mode == "shaft_exact" else 0)
                + (1 if p["active"] is not None else 0))
    num_bytes = (per_lane * R + 24 * L2 + 24 * sc * P + nbytes(*out)
                 + nbytes(p["apex"]))
    box = FRUSTUM_BOX_FLOPS if mode == "rays" else SHAFT_BOX_FLOPS
    flops = box * (tiles * L2 + P * sc)
    if mode == "shaft_exact":
        flops += hull * p["tile_rays"] * LANE_TEST_FLOPS
    return {**bound_ms(num_bytes, flops), "pairs": P, "hull_pairs": hull,
            "tiles": tiles}


def phase_stream_bin(scene) -> dict:
    """PS: Phase A's streaming kernel (csrc/stream_bin.cu) on the calls of
    one frame of ``scene`` (rays, shaft_capped, shaft_exact) and on the
    shaft_exact call again with ``lane_exact=False`` (shaft): lists bit-equal
    to ``bin_stream_plain``'s, one launch under the mode's counter; the
    kernel's time a call (CUDA events, the read of the list's length and
    the pack launch included), its device time (the profiler's rows) and
    the plain version's, beside the bound."""
    import inspect

    from crt_tpu_torch import render_image
    from crt_tpu_torch.ops import stream_binning as sb
    from crt_tpu_torch.utils import trace as tracing

    calls = []

    def keep(real, *args, **kw):
        bound = inspect.signature(real).bind(*_cloned(args), **_cloned(kw))
        bound.apply_defaults()
        calls.append(dict(bound.arguments))
        return real(*args, **kw)

    reset_launches()
    with patched(sb, "bin_stream", keep):
        render_image(scene)
    torch.cuda.synchronize()
    calls.append(dict(calls[-1], lane_exact=False))
    result = {}
    for p in calls:
        mode = sb.stream_mode(p["apex"], p["per_tile_cap"], p["lane_exact"])

        def kernel(p=p):
            return sb.bin_stream(**p)

        c0 = counted()
        got = kernel()
        c1 = counted()
        check(tracing.total(c1, "crt.launches")
              - tracing.total(c0, "crt.launches") == 1
              and c1[f"crt.launches.stream_bin.{mode}"]
              - c0[f"crt.launches.stream_bin.{mode}"] == 1,
              f"[stream-kernels] PS {mode}: not one launch of its mode")
        want = sb.bin_stream_plain(**p)
        torch.cuda.synchronize()
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"[stream-kernels] PS {mode}: the lists differ from the plain "
              "version")
        hull = (c1["crt.binning.pairs.hull"] - c0["crt.binning.pairs.hull"]
                if mode == "shaft_exact" else 0)
        ms = cuda_ms(kernel)
        dms = device_ms(kernel, calls=5)
        pms = cuda_ms(lambda p=p: sb.bin_stream_plain(**p), warmup=1, reps=3)
        b = stream_bin_bound(mode, p, got, hull)
        print(f"[stream-kernels] PS {mode}: {b['pairs']} pairs over "
              f"{b['tiles']} tiles"
              + (f" ({hull} in the shaft hull)" if hull else "")
              + f", bit-equal to the plain version, one launch; kernel "
              f"{ms:.3f} ms a call ({dms:.4f} ms on the device), bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}), plain {pms:.3f} ms, "
              f"library call none; {smi()}")
        result[mode] = dict(max_abs_err=0.0, ms=ms, device_ms=dms,
                            plain_ms=pms, library_ms=None, **b)
    return result


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
    events around every ``bin_stream`` call, host gaps included."""
    from crt_tpu_torch.ops import stream_binning as sb

    spans = []
    depth = [0]  # a call inside another is timed by the outer one

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

    patched = ((sb, "bin_stream"),)
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
    from crt_tpu_torch.ops.tracer import Tracer
    from crt_tpu_torch.scene.procedural import make_big_scene

    W, H = BIG["width"], BIG["height"]
    scene = make_big_scene(**BIG, seed=0, build_accel=False,
                           device=device)
    reset_launches()
    img = render_image(scene)
    torch.cuda.synchronize()
    launches = read_stream_launches()
    print(f"[big] render_image of {scene.num_triangles} triangles at {W}x{H},"
          f" default settings: launches {launches}")
    check(launches["closest_hit_stream"] == 1
          and launches["occlusion_stream"] == 2
          and launches["stream_bin"] == 3
          and launches["stream_host_syncs"] == 3
          and launches["closest_hit"] == 0 and launches["occlusion_w"] == 0
          and launches["occlusion_d"] == 0 and launches["segsum"] == 0,
          f"the large frame launched {launches}: expected one streaming "
          "closest hit, the two launches of the two-phase shadow resolve, "
          "three of Phase A with one host read each, and no cluster-backend "
          "kernel (auto must choose the streaming backend)")
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

    class AllPairs(Tracer):  # a [256, 4 T] product per chunk
        def __call__(self, origins, dirs, active=None):
            return intersect.closest_hit_bruteforce(td, origins, dirs,
                                                    ray_chunk=256)

    with torch.no_grad():
        ref = shade_wavefront(scene, RenderSettings(), AllPairs(), o[rays],
                              d[rays])
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
                           build_accel=False, device=device)
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
                               build_accel=False, device=device)
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
        picked = "cluster" if auto.emits_rows else "stream"
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
    """The large-scene main path in the lane and rows table layouts: the
    1,000,000-triangle frame at default settings through a streaming
    tracer built with ``layout=`` (tables built in the frame, as
    render_image builds them)."""
    from crt_tpu_torch import RenderSettings
    from crt_tpu_torch.ops.stream_trace import make_stream_trace_fn
    from crt_tpu_torch.renderer import _render_flat

    def frame(layout):
        with torch.no_grad():
            return _render_flat(scene, RenderSettings(),
                                trace_fn=make_stream_trace_fn(
                                    scene, layout=layout))

    layouts = ("fused", "lane", "rows")
    images, launches, ms = {}, {}, {}
    for layout in layouts:
        reset_launches()
        images[layout] = frame(layout)
        torch.cuda.synchronize()
        c = counted()
        launches[layout] = tuple(
            {k: c[f"crt.launches.{kind}.{k}"] for k in layouts}
            for kind in ("closest_hit_stream", "occlusion_stream")) \
            + (c["crt.launches.closest_hit"],)
        print(f"[layouts] layout={layout}: closest-hit launches "
              f"{launches[layout][0]}, any-hit launches "
              f"{launches[layout][1]}")
        want = dict.fromkeys(layouts, 0)
        check(launches[layout] == ({**want, layout: 1},
                                   {**want, layout: 2}, 0),
              f"the {layout} frame launched {launches[layout]}: expected "
              f"one closest hit and two any-hit passes, all {layout}")
    # frame times in turns, forward then backward
    for rnd, order in enumerate((layouts, layouts[::-1])):
        for layout in order:
            ms[layout, rnd], _ = host_ms(lambda: frame(layout), warmup=1,
                                         reps=5)
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
from crt_tpu_torch.utils import trace as tracing
with tracing.recording() as c:
    rc = cli.main(sys.argv[1:])
print(json.dumps({"rc": rc,
    "closest_hit": c["crt.launches.closest_hit"],
    "closest_hit_merged": c["crt.launches.closest_hit_merged"],
    "occlusion_w": tracing.total(c, "crt.launches.occlusion_w"),
    "occlusion_d": c["crt.launches.occlusion_d.compact"],
    "closest_hit_stream": tracing.total(c, "crt.launches.closest_hit_stream"),
    "occlusion_stream": tracing.total(c, "crt.launches.occlusion_stream")}))
"""


def cli_child(argv, env_extra):
    """The CLI in a child process, ``env_extra`` added to its environment
    -> the kernel launch counts it printed on its last line."""
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

    def levels(image):
        return quantize(image.cpu().numpy())

    W, H = BENCH["width"], BENCH["height"]
    scene = make_test_scene(**BENCH, device=device)
    reset_launches()
    k5_frame = frame_with(scene, shadow_kernel="d", tile_merge=2)
    k5_counts = dict(read_stream_launches(), closest_hit_merged=_launches(
        counted(), "closest_hit_merged"))
    k5_img = levels(k5_frame)
    with tempfile.TemporaryDirectory() as tmp:
        scene_path = os.path.join(tmp, "bench.crtscene")
        with open(scene_path, "w") as f:
            json.dump(make_test_scene_dict(**BENCH), f)
        st_ppm = os.path.join(tmp, "stream.ppm")
        st_counts = cli_child([scene_path, st_ppm, "--device", str(device),
                               "--backend", "pallas_stream"], {})
        st_img = (read_ppm(st_ppm) * 255).round().astype("int32")
    print(f"[direction-form] frame through a cluster tracer with "
          f"shadow_kernel='d', tile_merge=2: launches {k5_counts}; CLI with "
          f"--backend pallas_stream: launches {st_counts}")
    check(k5_counts["occlusion_d"] == 4 and k5_counts["occlusion_w"] == 0
          and k5_counts["closest_hit_merged"] == 4
          and k5_counts["closest_hit"] == 0,
          f"the direction-form frame launched {k5_counts}: expected 4 K7 "
          "closest hits, 4 direction-form shadow passes and no w-form pass")
    check(st_counts["closest_hit_stream"] == 4
          and st_counts["occlusion_stream"] == 8
          and st_counts["closest_hit"] == 0 and st_counts["occlusion_w"] == 0,
          f"the pallas_stream frame launched {st_counts}")
    check(k5_img.shape == (H, W, 3) and bool((k5_img == st_img).all()),
          "the streaming backend's frame differs from the cluster backend's "
          "direction-form frame")

    default = levels(render_image(scene))
    brute = levels(render_image(scene, RenderSettings(backend="bruteforce")))
    for name, other in (("the default (w-form) cluster frame", default),
                        ("the all-pairs backend's frame", brute)):
        off = (abs(k5_img - other) > 1).any(axis=-1)
        print(f"[direction-form] the direction-form frame == pallas_stream "
              f"frame "
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
            make_cluster_trace_fn(scene, shadow_kernel="anyhit"), o, d))
        k6_counts = read_stream_launches()
        k5_float = untile(shade_wavefront(
            scene, RenderSettings(),
            make_cluster_trace_fn(scene, shadow_kernel="d"), o, d))
    print(f"[direction-form] shade_wavefront with shadow_kernel='anyhit': "
          f"launches {k6_counts}")
    check(k6_counts["occlusion_d_exit"] == 4 and k6_counts["occlusion_d"] == 0
          and k6_counts["occlusion_w"] == 0,
          f"the any-hit frame launched {k6_counts}: expected 4 K6 passes")
    check(torch.equal(k6_img, k5_float),
          "the any-hit (K6) frame differs from the direction-form (K5) frame")
    check(torch.equal(k5_float, k5_frame),
          "the K5 frame through K1 differs from the one through K7")
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


PARALLEL_RANKS = 2  # gloo ranks on the one card (NCCL takes one a card)
PARALLEL_TIMEOUT = 600  # seconds for both ranks, all four paths
PARALLEL_KERNELS = ("closest_hit", "occlusion_w", "segsum",
                    "closest_hit_stream", "occlusion_stream")


def parallel_path(rank, name, fn, out):
    """One parallel path on this rank: a warm-up call; the counted one
    (every count zeroed just before, read just after: kernel launches,
    and the all-reduces' calls, bytes and host ms, each timed between two
    synchronizations of the card); then a plain call for the wall ms and
    peak memory, whose result is returned."""
    import torch.distributed as dist

    fn()
    coll = {"calls": 0, "bytes": 0, "s": 0.0}

    def timed(real, t, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        work = real(t, *args, **kw)
        torch.cuda.synchronize()
        coll["s"] += time.perf_counter() - t0
        coll["calls"] += 1
        coll["bytes"] += t.numel() * t.element_size()
        return work

    reset_launches()
    with patched(dist, "all_reduce", timed):
        fn()
        torch.cuda.synchronize()
    launches = read_stream_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    rec = {"wall_ms": wall,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": launches,
           "collectives": coll["calls"],
           "collective_mib": coll["bytes"] / 2**20,
           "collective_ms": coll["s"] * 1e3}
    out[name] = rec
    print(f"[parallel] rank {rank} {name}: wall {wall:.3f} ms, peak "
          f"{rec['peak_gib']:.3f} GiB, launches {rec['launches']}, "
          f"{rec['collectives']} all-reduces of {rec['collective_mib']:.1f} "
          f"MiB in {rec['collective_ms']:.3f} ms", flush=True)
    return result


def hold_k1_plain(tag, call):
    """K1 on a recorded call's inputs vs its plain version, bit for bit."""
    from crt_tpu_torch.ops import cluster_trace as ct

    args, kw = call
    got = ct.closest_hit(*args, **kw)
    want = ct.closest_hit_plain(*args, **kw)
    err = compare_hits(f"{tag} K1", got, want)
    print(f"[parallel] {tag}: K1 on a shard's recorded launch ({args[1].shape[0]} "
          f"rays, {args[0].n.shape[0]} clusters) bit-equal to the plain "
          "version on every lane", flush=True)
    return err


def hold_stream_plain(tag, k8_call, k9_calls, gen):
    """K8 and each K9 launch on a shard's recorded inputs vs the plain
    versions on PLAIN_TILES seeded tiles that own pairs, bit for bit, and
    vs the launch itself on those tiles."""
    from crt_tpu_torch.ops import stream_trace as stt

    # closest_hit_stream(table, tri_id, o, d, pair_sc, bits, start, ...)
    args, kw = k8_call
    t, tri = stt.closest_hit_stream(*args, **kw)
    pick = pick_live_tiles(args[6], gen)
    sub, lane_args, lanes = tile_subset(pick, *args[4:7], *args[2:4])
    sub_args = (*args[:2], *lane_args, *sub, *args[7:])
    kt, ktri = stt.closest_hit_stream(*sub_args, **kw)
    pt, ptri = stt.closest_hit_stream_plain(*sub_args, **kw)
    compare_hits(f"{tag} K8", (kt, ktri, None), (pt, ptri, None))
    compare_hits(f"{tag} K8, full launch vs sampled tiles",
                 (t[lanes], tri[lanes], None), (kt, ktri, None))
    # occlusion_stream(table, o, d, r2, seed, pair_sc, bits, start, ...)
    for phase, (args, kw) in enumerate(k9_calls, 1):
        occ = stt.occlusion_stream(*args, **kw)
        pick = pick_live_tiles(args[7], gen)
        sub, lane_args, lanes = tile_subset(pick, *args[5:8], *args[1:5])
        sub_args = (args[0], *lane_args, *sub, *args[8:])
        kocc = stt.occlusion_stream(*sub_args, **kw)
        pocc = stt.occlusion_stream_plain(*sub_args, **kw)
        check(torch.equal(kocc, pocc),
              f"{tag} K9 launch {phase}: the kernel differs from the plain "
              "version")
        check(torch.equal(occ[lanes], kocc),
              f"{tag} K9 launch {phase}: the full launch differs on the "
              "sampled tiles")
    print(f"[parallel] {tag}: K8 and the {len(k9_calls)} K9 launches of a "
          f"shard, on {PLAIN_TILES} seeded tiles each, bit-equal to the plain "
          "versions and to the full launches", flush=True)


def parallel_rank(rank: int, out_dir: str) -> int:
    """One of the PARALLEL_RANKS gloo ranks of [parallel], on card 0."""
    from crt_tpu_torch import render_image
    from crt_tpu_torch.ops import cluster_trace as ct
    from crt_tpu_torch.ops import cuda_lib
    from crt_tpu_torch.ops import stream_trace as stt
    from crt_tpu_torch.parallel import multihost
    from crt_tpu_torch.parallel.scene_sharded import (
        render_image_scene_sharded,
    )
    from crt_tpu_torch.parallel.sharded import (
        make_mesh,
        render_image_sharded,
        sharded_value_and_grad,
    )
    from crt_tpu_torch.scene.procedural import make_big_scene, make_test_scene

    import datetime

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    check(multihost.initialize(
        init_method=f"file://{out_dir}/store", world_size=PARALLEL_RANKS,
        rank=rank, backend="gloo",
        timeout=datetime.timedelta(seconds=PARALLEL_TIMEOUT)),
        "the gloo group did not form")
    cuda_lib.load()
    out = {}
    gen = torch.Generator(device="cpu").manual_seed(0)
    W, H = BENCH["width"], BENCH["height"]
    scene = make_test_scene(**BENCH, device=device)
    rows_mesh = make_mesh()
    scene_mesh = make_mesh((1, PARALLEL_RANKS), ("rays", "scene"))

    # 1. the row-sharded opaque frame
    img = parallel_path(rank, "row-sharded frame", lambda: render_image_sharded(
        scene, mesh=rows_mesh), out)
    check(tuple(img.shape) == (H, W, 3) and bool(torch.isfinite(img).all()),
          "the row-sharded frame is not a finite [H, W, 3]")
    ref = None
    if rank == 0:
        ref, ms = timed_once(lambda: render_image(scene))
        ref, ms = timed_once(lambda: render_image(scene))
        out["one-process frame"] = {"wall_ms": ms}
        image_agreement("[parallel] row-sharded frame vs render_image", img,
                        ref)
    # rank 1 waits off the card while rank 0 times its one-process frames
    torch.distributed.barrier()

    # 2. its gradient
    target = torch.full_like(img, 0.25)
    params = {k: getattr(scene, k) for k in TRAINED}
    loss, grads = parallel_path(
        rank, "row-sharded gradient", lambda: sharded_value_and_grad(
            scene, target, params, mesh=rows_mesh), out)
    if rank == 0:
        def one_process():
            leaves = {k: v.detach().clone().requires_grad_(True)
                      for k, v in params.items()}
            loss = torch.mean((render_image(scene.replace(**leaves))
                               - target) ** 2)
            loss.backward()
            return loss, {k: p.grad for k, p in leaves.items()}

        one_process()
        (loss1, grads1), ms = timed_once(one_process)
        out["one-process gradient"] = {"wall_ms": ms}
        loss1 = float(loss1.detach())
        print(f"[parallel] loss {float(loss):.9e} sharded, "
              f"{loss1:.9e} one process", flush=True)
        check(abs(float(loss) - loss1) <= 1e-5 * abs(loss1),
              "the sharded loss differs from the one-process loss")
        assert_grads_close("row-sharded vs one process", grads, grads1,
                           rtol=1e-3, atol_scale=1e-4, tag="[parallel]")
    torch.distributed.barrier()

    # 3. the scene-partitioned opaque frame, cluster backend
    k1 = []
    with patched(ct, "closest_hit", keep_args(k1)):
        img = parallel_path(
            rank, "scene-partitioned frame", lambda: render_image_scene_sharded(
                scene, mesh=scene_mesh), out)
    check(out["scene-partitioned frame"]["launches"]["occlusion_w"] == 0,
          "the partitioned cluster path launched the w-occlusion kernel")
    if rank == 0:
        image_agreement("[parallel] scene-partitioned frame vs render_image",
                        img, ref)
    out["k1_err"] = hold_k1_plain("scene-partitioned frame", k1[0])
    del scene, img, ref, grads

    # 4. the scene-partitioned streaming frame at 1,000,000 triangles
    torch.cuda.empty_cache()
    big = make_big_scene(**BIG, seed=0, build_accel=False, device=device)
    k8, k9 = [], []
    with patched(stt, "closest_hit_stream", keep_args(k8)), \
            patched(stt, "occlusion_stream", keep_args(k9, keep=2)):
        img = parallel_path(
            rank, "scene-partitioned 1M frame",
            lambda: render_image_scene_sharded(big, mesh=scene_mesh), out)
    launches = out["scene-partitioned 1M frame"]["launches"]
    check(launches["closest_hit_stream"] == 1
          and launches["occlusion_stream"] == 2
          and launches["stream_bin"] == 3
          and launches["stream_host_syncs"] == 3
          and launches["closest_hit"] == 0,
          f"the partitioned 1M frame launched {launches}, expected one K8, "
          "two K9 and no K1 on each rank")
    if rank == 0:
        render_image(big)
        ref, ms = timed_once(lambda: render_image(big))
        out["one-process 1M frame"] = {"wall_ms": ms}
        image_agreement("[parallel] scene-partitioned 1M frame vs "
                        "render_image", img, ref)
    torch.distributed.barrier()
    hold_stream_plain("scene-partitioned 1M frame", k8[0], k9, gen)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def phase_parallel(device):
    """[parallel]: PARALLEL_RANKS gloo ranks on this card drive the
    row-sharded and scene-partitioned paths; rank 0 holds each to the
    one-process render.  Returns each path's launches per rank."""
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                for r in range(PARALLEL_RANKS)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--parallel-rank",
             str(r), tmp], stdout=logs[r], stderr=subprocess.STDOUT)
            for r in range(PARALLEL_RANKS)]
        deadline = time.monotonic() + PARALLEL_TIMEOUT
        failed = None
        try:
            while any(p.poll() is None for p in procs):
                failed = next((r for r, p in enumerate(procs)
                               if p.poll() not in (None, 0)), None)
                if failed is not None or time.monotonic() > deadline:
                    break
                time.sleep(0.5)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        for r, log in enumerate(logs):
            log.seek(0)
            for line in log.read().splitlines():
                print(line if line.startswith("[parallel]")
                      else f"[parallel] rank {r}: {line}")
            log.close()
        rcs = [p.returncode for p in procs]
        check(failed is None and rcs == [0] * PARALLEL_RANKS,
              f"the gloo ranks exited {rcs}"
              + (" (time limit)" if failed is None and any(rcs) else ""))
        ranks = []
        for r in range(PARALLEL_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    paths = [k for k, v in ranks[0].items()
             if isinstance(v, dict) and "launches" in v]
    for path in paths:
        per_rank = [rk[path] for rk in ranks]
        print(f"[parallel] {path}: wall " + " / ".join(
            f"{x['wall_ms']:.3f}" for x in per_rank) + " ms, peak " + " / ".join(
            f"{x['peak_gib']:.3f}" for x in per_rank) + " GiB, collectives "
            + " / ".join(f"{x['collective_ms']:.3f}" for x in per_rank)
            + " ms (rank 0 / rank 1)")
        # each shard lists its own pairs; the kernels launched must agree
        kernels = [{k: x["launches"][k] for k in PARALLEL_KERNELS}
                   for x in per_rank]
        check(all(k == kernels[0] for k in kernels),
              f"{path}: the ranks launched {kernels}")
    for k in ("one-process frame", "one-process gradient",
              "one-process 1M frame"):
        print(f"[parallel] {k} on rank 0: {ranks[0][k]['wall_ms']:.3f} ms")
    expect = {"row-sharded frame": ("closest_hit", "occlusion_w"),
              "row-sharded gradient": ("closest_hit", "occlusion_w",
                                       "segsum"),
              "scene-partitioned frame": ("closest_hit",),
              "scene-partitioned 1M frame": ("closest_hit_stream",
                                             "occlusion_stream")}
    for path, kernels in expect.items():
        got = ranks[0][path]["launches"]
        check(all(got[k] > 0 for k in kernels),
              f"{path}: a kernel of the path was never launched: {got}")
    return {name: {path: [rk[path]["launches"][name] for rk in ranks]
                   for path in paths} for name in PARALLEL_KERNELS}


def phase_blender(device):
    """[blender]: the port's add-on registered under tests/mock_bpy.py's
    stand-in; the opaque bench scene imported through its importer,
    exported from the depsgraph and rendered by its engine on the card,
    held to render_scene_from_dict_array of the same dict."""
    import importlib

    import numpy as np

    from crt_tpu_torch.frontend import api
    from crt_tpu_torch.scene.procedural import make_test_scene_dict

    sys.path.insert(0, TESTS)
    import mock_bpy
    from blender_addon_child import bench_depsgraph

    mods = mock_bpy._build_modules()
    sys.modules.update(mods)
    try:
        from crt_tpu_torch.frontend import blender as addon

        names = [f"crt_tpu_torch.frontend.blender.{m}" for m in (
            "scene_bridge", "properties", "engine", "ui", "ops")]
        for name in names:
            if name in sys.modules:
                importlib.reload(sys.modules[name])
            else:
                importlib.import_module(name)
        from crt_tpu_torch.frontend.blender import engine, scene_bridge

        addon.register()
        W, H = BENCH["width"], BENCH["height"]
        d = make_test_scene_dict(**BENCH)
        dg = bench_depsgraph(mods["bpy"], scene_bridge, d)
        bscene = dg.scene
        exported = scene_bridge.build_scene_dict(dg)
        eng = engine.CRTTorchRenderEngine()
        eng.render(dg)  # warm-up
        reset_launches()
        eng = engine.CRTTorchRenderEngine()
        _, ms = timed_once(lambda: eng.render(dg))
        launches = read_launches()
        rect = np.asarray(eng.result.layers[0].passes["Combined"].rect)
        crt = bscene.crt
        settings = api.RendererSettings(
            crt.max_ray_depth, crt.diffuse_reflection_ray_count,
            crt.shadow_bias, crt.reflection_bias, crt.diffuse_reflection_bias,
            crt.refraction_bias)
        ref = api.render_scene_from_dict_array(exported, "/", settings)
        addon.unregister()
    finally:
        for name in mods:
            sys.modules.pop(name, None)
    tris = sum(len(o["triangles"]) // 3 for o in exported["objects"])
    print(f"[blender] the add-on's engine ({engine.ENGINE_ID}) rendered the "
          f"{W}x{H} bench scene imported into the mock Blender ({tris} "
          f"triangles, {len(exported['lights'])} lights exported) in "
          f"{ms:.3f} ms; kernel launches {launches}")
    check(rect.shape == (W * H, 4) and bool(np.isfinite(rect).all())
          and bool((rect[:, 3] == 1.0).all()),
          "the Combined pass is not a finite [W * H, 4] RGBA")
    check(np.array_equal(rect, ref.reshape(-1, 4)),
          "the Combined pass differs from render_scene_from_dict_array")
    check(launches == {"closest_hit": 4, "occlusion_w": 4, "segsum": 0,
                       "cluster_bin": 8},
          f"the engine launched {launches}, expected 4 K1, 4 K2 and 8 "
          "Phase A")
    print("[blender] the Combined pass equals render_scene_from_dict_array "
          "of the exported dict on the card, bit for bit")
    return launches


def tool_main(tool, argv, tag):
    """Run a tool's main with its output captured and printed under
    ``tag``; returns (exit code, its output lines)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tool.main(argv)
    lines = buf.getvalue().splitlines()
    for line in lines:
        if line.strip():
            print(f"{tag} {line}")
    return rc, lines


# The two golden cases of [tools]' corpus: the opaque and the mirror
# variants of the test scene, under the names and profiles of two
# HEAD_GOLDEN_CASES.
TOOLS_CORPUS = {
    "09-02-diffuse-smooth-shading-scene2": {"with_reflective": False},
    "09-03-reflective-scene4": {},
}


def cli_default_scene(reference, tmp):
    """The CLI with no argument (C2): the reference CLI's default scene
    under $CRT_REFERENCE (here ``reference``, holding the 1080p GI bench
    scene there), on the default device, written to output.ppm in the
    working directory; equal to the CLI given the file by path.  Without
    $CRT_REFERENCE it returns 1.  Returns the launches of the first
    run."""
    import pathlib

    from crt_tpu_torch.frontend import cli
    from crt_tpu_torch.scene.procedural import make_test_scene_dict

    path = reference / cli.DEFAULT_SCENE
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(make_test_scene_dict(**BENCH, gi_on=True)))
    work = pathlib.Path(tmp) / "cli_default"
    work.mkdir()
    with contextlib.chdir(work):
        reset_launches()
        rc = cli.main([])
        launches = read_launches()
        check(rc == 0, f"the CLI with no scene returned {rc}")
        rc = cli.main([str(path), "by_path.ppm"])
        check(rc == 0, f"the CLI given the default scene returned {rc}")
        check((work / "output.ppm").read_bytes()
              == (work / "by_path.ppm").read_bytes(),
              "the no-argument PPM differs from the one given the path")
        saved = os.environ.pop("CRT_REFERENCE")
        try:
            with contextlib.redirect_stderr(sys.stdout):
                rc = cli.main([])
        finally:
            os.environ["CRT_REFERENCE"] = saved
        check(rc == 1, f"the CLI without $CRT_REFERENCE returned {rc}")
    check(launches == {"closest_hit": 16, "occlusion_w": 16, "segsum": 0,
                       "cluster_bin": 32},
          f"the default scene's frame launched {launches}, expected 16 K1 "
          "+ 16 K2 + 32 Phase A")
    print(f"[tools] the CLI with no scene: the 1920x1080 GI scene under "
          f"$CRT_REFERENCE/{cli.DEFAULT_SCENE} on the card, output.ppm equal "
          f"to the PPM of the same file given by path; launches {launches}; "
          "without $CRT_REFERENCE it returns 1")
    return launches


def phase_tools(device):
    """[tools]: the repo's entry points outside the package on the card.
    The staged Blender add-on rendering F12 in a child process that finds
    crt_tpu_torch only in the unpacked zip (kernels built from its own
    sources), bit-equal to render_scene_from_dict_array here; the turntable
    of the bench scene (4 frames, each PNG decoded back equal to quantize
    of the same rig's render); golden_check and render_all on a corpus
    built here (goldens rendered on the CPU); export_mesh_header of the
    bench scene; the float64 oracle on 4,096 seeded pixels of the mirror
    scene against the card's render; the CLI with no scene
    (``cli_default_scene``).  Returns the K1 / K2 launches of the add-on's
    frame, of the turntable and of the default scene's CLI frame."""
    import pathlib

    import numpy as np

    from crt_tpu_torch import RenderSettings, load_scene, render_image
    from crt_tpu_torch.frontend import api
    from crt_tpu_torch.io import png
    from crt_tpu_torch.io.ppm import quantize
    from crt_tpu_torch.scene.procedural import make_test_scene_dict
    from crt_tpu_torch.tools import (
        export_mesh_header, golden_check, oracle_f64, render_all,
        render_turntable,
    )
    from crt_tpu_torch.utils import golden

    sys.path.insert(0, TESTS)
    from blender_addon_child import run_staged_addon
    from png_raw import raw_png

    phase_start = time.perf_counter()
    W, H = BENCH["width"], BENCH["height"]
    d = make_test_scene_dict(**BENCH)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)

        # the staged add-on, in a child process
        (tmp / "addon").mkdir()
        start = time.perf_counter()
        info, rect, exported = run_staged_addon(tmp / "addon", d, "cuda")
        child_s = time.perf_counter() - start
        root = str(tmp / "addon" / "unpacked" / "crt_tpu_torch_renderer")
        build = info["build"]
        print(f"[tools] staged add-on: crt_tpu_torch.__file__ = "
              f"{info['package']}; kernels built by nvcc in "
              f"{build['seconds']:.2f} s into {build['path']} (cache hit "
              f"{build['cache_hit']}); KD builder {info['kd_builder']} "
              f"({info['native_library']}); first F12 (build included) "
              f"{info['first_render_ms']:.3f} ms, F12 {W}x{H} "
              f"{info['frame_ms']:.3f} ms; launches {info['launches']}; "
              f"child process {child_s:.1f} s")
        check(info["package"].startswith(root + os.sep),
              "the child imported crt_tpu_torch from outside the zip")
        check(build["path"].startswith(
            os.path.join(root, "build", "crt_tpu_torch") + os.sep)
            and not build["cache_hit"],
            "the child did not build the kernels in its own directory")
        check(info["launches"] == {"closest_hit": 4, "occlusion_w": 4,
                                   "segsum": 0},
              f"the add-on's F12 launched {info['launches']}, expected 4 K1 "
              "and 4 K2")
        ref = api.render_scene_from_dict_array(exported, "/",
                                               info["settings"],
                                               device=device)
        check(rect.shape == (W * H, 4)
              and np.array_equal(rect, ref.reshape(-1, 4)),
              "the add-on's Combined pass differs from "
              "render_scene_from_dict_array here")
        print("[tools] the add-on's Combined pass equals "
              "render_scene_from_dict_array here, bit for bit")
        launches["blender_addon"] = info["launches"]

        # the turntable of the bench scene
        bench_path = tmp / "bench.crtscene"
        bench_path.write_text(json.dumps(d))
        frames = 4
        reset_launches()
        rc, lines = tool_main(render_turntable, [
            str(bench_path), str(tmp / "turntable"), "--frames",
            str(frames)], "[tools] turntable:")
        turn = read_launches()
        check(rc == 0, f"render_turntable returned {rc}")
        scene = load_scene(str(bench_path), device=device)
        check(png.unfilter_backend() == "native",
              "the PNG decoder did not take the native row filters")
        filter0_ms = []
        for f, rig in enumerate(render_turntable.orbit_rigs(scene, frames)):
            img = render_image(rig.apply(scene)).cpu().numpy()
            t0 = time.perf_counter()
            got = png.read_png(tmp / "turntable" / f"frame_{f:03d}.png")
            filter0_ms.append((time.perf_counter() - t0) * 1e3)
            check(np.array_equal(got, quantize(img)),
                  f"turntable frame {f} differs from quantize(render)")
            print(f"[tools] turntable frame {f}: equal to quantize(render) "
                  f"of its rig on every pixel; PNG decode "
                  f"{filter0_ms[-1]:.3f} ms")
        check(turn == {"closest_hit": 4 * frames, "occlusion_w": 4 * frames,
                       "segsum": 0, "cluster_bin": 8 * frames},
              f"the turntable launched {turn}, expected {frames} x (4 K1 + "
              "4 K2 + 8 Phase A)")
        launches["turntable"] = turn
        # the decode of a file with every row filter (filters 0-4 in turn,
        # 64 KiB IDAT chunks), as adaptive writers (PIL, stb) produce:
        # the port's encoder writes filter 0 only
        # (filters undone in C++ and by the NumPy plain version: the same
        # bytes; the native decode 5 times, the median kept)
        mixed = raw_png(got, 2, 8, "mixed", 0, idat_size=1 << 16)
        mixed_ms = {"native": [], "numpy": []}
        for backend in ("native", "numpy", "native", "native", "native",
                        "native"):
            t0 = time.perf_counter()
            back = png.decode(mixed, backend=backend)
            mixed_ms[backend].append((time.perf_counter() - t0) * 1e3)
            check(np.array_equal(back, got),
                  f"the file with every row filter decodes ({backend}) to "
                  "other pixels")
        native_ms = sorted(mixed_ms["native"])[2]
        print(f"[tools] PNG decode of a {W}x{H} RGB file with row filters "
              f"0-4 in turn ({len(mixed)} bytes), equal bytes both ways: "
              f"native row filters {native_ms:.3f} ms (median of 5; "
              f"{', '.join(f'{t:.3f}' for t in mixed_ms['native'])}), NumPy "
              f"row filters {mixed_ms['numpy'][0]:.3f} ms; the filter-0 "
              f"files above {min(filter0_ms):.3f}-{max(filter0_ms):.3f} ms; "
              f"{smi()}")

        # golden_check and render_all on a corpus built here
        reference = tmp / "reference"
        filters = []
        for rel, name, overrides in golden.HEAD_GOLDEN_CASES:
            if name not in TOOLS_CORPUS:
                continue
            path = reference / "scenes" / rel
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(make_test_scene_dict(
                192, 108, **TOOLS_CORPUS[name])))
            img = render_image(load_scene(str(path), device="cpu"),
                               RenderSettings(**overrides)).numpy()
            (reference / "results" / "png").mkdir(parents=True,
                                                  exist_ok=True)
            png.write_png(quantize(img).astype(np.uint8),
                          reference / "results" / "png" / f"{name}.png")
            filters.append(rel.removesuffix(".crtscene"))
        saved = os.environ.get("CRT_REFERENCE")
        os.environ["CRT_REFERENCE"] = str(reference)
        try:
            rc, _ = tool_main(golden_check, [
                *filters, "--json", str(tmp / "golden.json")],
                "[tools] golden_check:")
            check(rc == 0, f"golden_check returned {rc}")
            stats = json.loads((tmp / "golden.json").read_text())
            check(len(stats) == 2 and all(c["frac"] >= 0.999
                                          for c in stats),
                  f"golden_check on the corpus built here: {stats}")
            rc, _ = tool_main(render_all, [
                str(tmp / "results_torch"), *filters],
                "[tools] render_all:")
            check(rc == 0, f"render_all returned {rc}")
            launches["cli_default_scene"] = cli_default_scene(reference,
                                                              tmp)
        finally:
            if saved is None:
                os.environ.pop("CRT_REFERENCE")
            else:
                os.environ["CRT_REFERENCE"] = saved
        out = tmp / "results_torch"
        rows = [line for line in (out / "README.md").read_text()
                .splitlines() if line.startswith("| 09-")]
        n_ppm = len(list((out / "ppm").glob("*.ppm")))
        n_png = len(list((out / "png").glob("*.png")))
        check(n_ppm == 2 and n_png == 2 and len(rows) == 2,
              f"render_all wrote {n_ppm} PPM, {n_png} PNG, {len(rows)} rows")
        print(f"[tools] render_all wrote {n_ppm} PPM, {n_png} PNG and a "
              f"README table of {len(rows)} rows")

        # export_mesh_header of the bench scene
        header = tmp / "bench.h"
        rc, lines = tool_main(export_mesh_header,
                              [str(bench_path), str(header), "bench"],
                              "[tools] export_mesh_header:")
        check(rc == 0 and "wrote" in lines[-1], "export_mesh_header failed")
        print(f"[tools] the header is {header.stat().st_size} bytes")

        # the float64 oracle on seeded pixels of the mirror scene
        mirror = next(reference / "scenes" / rel
                      for rel, name, _ in golden.HEAD_GOLDEN_CASES
                      if name == "09-03-reflective-scene4")
        scene = load_scene(str(mirror), device=device)
        img = render_image(scene).cpu().numpy()
        idx = np.random.default_rng(0).choice(scene.width * scene.height,
                                              4096, replace=False)
        ys, xs = np.divmod(idx, scene.width)
        t0 = time.perf_counter()
        orc = oracle_f64.oracle_pixels(scene, RenderSettings(), xs, ys)
        orc_ms = (time.perf_counter() - t0) * 1e3

        def q(x):
            return np.clip((x * 255).astype(int), 0, 255) / 255.0

        share = float((np.abs(q(orc) - q(img[ys, xs])).max(axis=-1)
                       <= 2.5 / 255).mean())
        print(f"[tools] oracle_f64 on 4,096 seeded pixels of the "
              f"{scene.width}x{scene.height} mirror scene: {share:.6f} "
              f"within 2.5/255 of the render here; oracle {orc_ms:.1f} ms")
        check(share >= 0.999, f"the oracle agrees on {share} of the pixels")
    print(f"[tools] the phase took {time.perf_counter() - phase_start:.1f} s")
    return launches


def phase_precision(device):
    """[precision]: the render path ignores the caller's TF32 switches.
    With TF32 on for the whole process (cuBLAS, cuDNN and the matmul
    precision "medium", as tests/fp32_settings.py sets them), the bench
    frame on the cluster and all-pairs backends and the 1080p GI frame
    equal the frames rendered with it off bit for bit, the bench frame's
    gradient is within K3's tolerance (4e-6 of the fp64 sum of |g|) of the
    one with it off, and every render leaves the settings as they were
    set.  A product outside the renderer shows that the switch was on.
    Returns the launches of each render."""
    from crt_tpu_torch import RenderSettings, render_image
    from crt_tpu_torch.scene.procedural import make_test_scene

    sys.path.insert(0, TESTS)
    from fp32_settings import under

    start = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn(512, 64, device=device, generator=gen)
    b = torch.randn(64, 512, device=device, generator=gen)
    exact = a.double() @ b.double()
    err = {mode: float((under(mode, lambda: a @ b).double() - exact)
                       .abs().max()) for mode in ("ieee", "tf32")}
    print(f"[precision] a [512, 64] x [64, 512] product outside the "
          f"renderer, max |err| vs fp64: {err['tf32']:.3e} under TF32, "
          f"{err['ieee']:.3e} under IEEE")
    check(err["tf32"] > 10 * err["ieee"],
          "TF32 did not take effect outside the renderer")

    scene = make_test_scene(**BENCH, device=device)
    gi = make_test_scene(**BENCH, gi_on=True, device=device)
    frames = {"cluster": (scene, RenderSettings()),
              "bruteforce": (scene, RenderSettings(backend="bruteforce")),
              "gi": (gi, RenderSettings())}
    launches = {}
    for name, (s, st) in frames.items():
        out = {}
        for mode in ("ieee", "tf32"):
            reset_launches()
            out[mode] = under(mode, lambda: render_image(s, st))
            launches[f"{name}_{mode}"] = read_launches()
        check(torch.equal(out["tf32"].view(torch.int32),
                          out["ieee"].view(torch.int32)),
              f"the {name} frame under TF32 differs from the IEEE frame")
        print(f"[precision] {name} frame {s.width}x{s.height}: under TF32 "
              f"== under IEEE bit for bit, the settings read back as set; "
              f"launches {launches[f'{name}_tf32']} "
              f"[{time.perf_counter() - start:.1f} s into the phase]")
    grads = {}
    for mode in ("ieee", "tf32"):
        reset_launches()
        grads[mode] = under(mode, lambda: image_sum_grads(scene))[1]
        launches[f"grad_{mode}"] = read_launches()
    for k in TRAINED:
        got, want = grads["tf32"][k].double(), grads["ieee"][k].double()
        limit = 4e-6 * float(want.abs().sum())
        diff = float((got - want).abs().max())
        print(f"[precision] d/d{k} under TF32 vs IEEE: max |diff| "
              f"{diff:.3e}, limit {limit:.3e}")
        check(bool(torch.isfinite(got).all()) and diff <= limit,
              f"d/d{k} under TF32 is {diff} from the IEEE gradient")
    print(f"[precision] gradient launches {launches['grad_tf32']}; {smi()}; "
          f"the phase took {time.perf_counter() - start:.1f} s")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile forward+backward frames instead of "
                    "running the checks")
    ap.add_argument("--large", action="store_true",
                    help="run only the large-scene, table-layout and "
                    "direction-form phases (no JSON lines)")
    ap.add_argument("--parent", metavar="DIR",
                    help="time K1-K7 at their redesign "
                    "shapes and profile the opaque and glass frames in "
                    "turns with the kernels built from "
                    "DIR/crt_tpu_torch/csrc (another checkout's, with this "
                    "one's interface), and nothing else (no JSON lines)")
    ap.add_argument("--parallel-rank", nargs=2, metavar=("RANK", "DIR"),
                    help=argparse.SUPPRESS)  # one rank of [parallel]
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's card path cannot run",
              file=sys.stderr)
        return 2
    if args.parallel_rank:
        return parallel_rank(int(args.parallel_rank[0]),
                             args.parallel_rank[1])
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
    precision = phase_precision(device)
    torch.cuda.empty_cache()
    variants, launches["closest_hit_merged"] = phase_variants(device)
    stats.update(variants)
    stats.update(phase_glass_kernels(device))
    glass, compact = phase_refract(device)
    torch.cuda.empty_cache()
    gi = phase_gi(device)
    torch.cuda.empty_cache()
    phase_a = phase_cluster_bin(device)
    torch.cuda.empty_cache()
    stats["segsum"]["texel_ids"] = phase_bitmap(device)
    torch.cuda.empty_cache()
    phase_aov(device)
    torch.cuda.empty_cache()
    phase_tree(device)
    torch.cuda.empty_cache()
    phase_utils(device)
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
    torch.cuda.empty_cache()
    blender = phase_blender(device)
    torch.cuda.empty_cache()
    tools = phase_tools(device)
    torch.cuda.empty_cache()
    parallel = phase_parallel(device)
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
    # the large frame's own path (render_image, default settings; through
    # tracers with layout=lane and rows for K10 and K11), the frame through
    # a tracer with shadow_kernel="d" (K5), and a frame shaded through a
    # tracer with shadow_kernel="anyhit" (K6: a tracer argument that no
    # setting of render_image reaches, here or in crt_tpu).  K7's launches
    # are the tile_merge=2 frame's.
    launches["closest_hit_stream"] = big["closest_hit_stream"]
    launches["occlusion_stream"] = big["occlusion_stream"]
    launches.update(direction)
    # Phase A's launches are those of the opaque, glass and GI CLI frames
    # (one before each trace kernel); its times and bound those of the
    # [cluster-bin] calls, recorded from the GI and glass frames
    main_path = {"opaque": launches["cluster_bin"],
                 "glass": glass["cluster_bin"], "gi": gi["cluster_bin"]}
    launches["cluster_bin"] = sum(main_path.values())
    stats["cluster_bin"] = dict(
        max_abs_err=0.0, main_path_launches=main_path,
        **{k: sum(f[k] for f in phase_a.values())
           for k in ("kernel_ms", "plain_ms", "bound_ms")},
        frames=phase_a)
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
        ("cluster_bin", "crt_tpu_torch/csrc/cluster_bin.cu",
         "crt_tpu/ops/pallas_trace.py:400, :516 (XLA, no pallas_call)"),
    )
    kernels = [{"name": n, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[n], "on_a_render_path": n not in off_path,
                **stats[n]}
               for n, src, rep in described]
    # the launches of each rank on the parallel paths, and of the Blender
    # engine's frame
    for k in kernels:
        if k["name"] in parallel:
            k["parallel_launches"] = parallel[k["name"]]
        if k["name"] in blender:
            k["blender_launches"] = blender[k["name"]]
        if k["name"] in ("closest_hit", "occlusion_w"):
            k["tools_launches"] = {path: tools[path][k["name"]]
                                   for path in tools}
        if k["name"] in ("closest_hit", "occlusion_w", "segsum",
                         "cluster_bin"):
            k["precision_launches"] = {run: precision[run][k["name"]]
                                       for run in precision}
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

#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (crt_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile]

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
     and vs the all-pairs backend on 8192 sampled rays;
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
  7. a JSON line of the kernels, then the last line
     {"ok": true, "device": {...}}.

``--profile`` runs, instead of phases 3 to 7, a torch.profiler pass over
three forward+backward frames: host enqueue time vs device kernel time,
the top device kernels, the segment-sum kernel's share and peak memory.

Tolerances.  The trace kernels: bit-equal to their plain versions.  The
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
               rows_table=None) -> dict:
    """Bound of a cluster-walk kernel from what this run gave it.

    Bytes: the walked list entries, the tables once, the rays and the
    outputs.  Operations: member tests the answer needs.  A lane of
    ``active`` [tiles, TILE] (the lanes the lists were binned for) must
    test every real member of every cluster on its tile's list; a lane
    that ``blocked`` marks (an any-hit answer) needs one test, its
    blocker's; a lane outside ``active`` needs none."""
    walked = int(cnt.sum())
    table_bytes = nbytes(tables.n, tables.nv0, tables.m, tables.c,
                         tables.nobf, tables.tri_id, rows_table)
    num_bytes = (nbytes(*rays, cnt, *outputs) + 4 * walked + table_bytes)
    members = (tables.tri_id >= 0).sum(dim=1)  # [L] real members
    on_list = torch.arange(cl.shape[1], device=cl.device) < cnt[:, None]
    tile_members = (members[cl.long()] * on_list).sum(dim=1)  # [tiles]
    full = active if blocked is None else active & ~blocked
    tests = int((full.sum(dim=1) * tile_members).sum())
    if blocked is not None:
        tests += int((active & blocked).sum())
    return {**bound_ms(num_bytes, tests * FLOPS_PER_MEMBER),
            "member_tests": tests}


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


def phase_kernels(device):
    from crt_tpu_torch.ops import vecmath
    from crt_tpu_torch.ops.binning import bin_apex_shared, bin_rays
    from crt_tpu_torch.ops.cluster_tables import (
        build_cluster_tables, emit_rows_table,
    )
    from crt_tpu_torch.ops.cluster_trace import (
        closest_hit, closest_hit_plain, occlusion_w, occlusion_w_plain,
    )
    from crt_tpu_torch.ops.intersect import Hit
    from crt_tpu_torch.ops.shade import hit_attributes
    from crt_tpu_torch.scene.procedural import make_test_scene
    from crt_tpu_torch.scene.types import (
        MATERIAL_DIFFUSE, MATERIAL_REFLECTIVE, RenderSettings,
    )

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

    # mirror-bounce wavefront, built as the shader builds it
    attrs = hit_attributes(scene, o, d, Hit(t=k[0], tri=k[1]),
                           kernel_rows=k[2])
    refl_d = vecmath.reflect(d, attrs.normal).contiguous()
    refl_o = (attrs.point + attrs.normal * st.reflection_bias).contiguous()
    refl_act = attrs.valid & (attrs.mat_type == MATERIAL_REFLECTIVE)
    bcl, bcnt = bin_rays(tables, refl_o, refl_d, TILE, refl_act)
    kb = closest_hit(tables, refl_o, refl_d, bcl, bcnt, rows_table)
    pb = closest_hit_plain(tables, refl_o, refl_d, bcl, bcnt, rows_table)
    err_k1 = max(err_k1, compare_hits("closest_hit bounce", kb, pb))
    print(f"[kernels] closest_hit bounce: {int(refl_act.sum())} active lanes, "
          f"{int((bcnt > 0).sum())} live tiles, bit-equal")

    # depth-0 shadow wavefront, built as _occlusion_masks builds it
    point, normal = attrs.point, attrs.normal
    lights = scene.light_position.contiguous()
    light_vec = lights[:, None, :] - point[None]
    light_dir = vecmath.safe_normalize(light_vec)
    facing = vecmath.dot(light_dir, normal[None].expand_as(light_vec)) > 0.0
    is_diffuse = attrs.valid & (attrs.mat_type == MATERIAL_DIFFUSE)
    act_lr = is_diffuse[None] & facing
    shadow_o = (point + normal * st.shadow_bias).contiguous()
    point = point.contiguous()
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
    b2 = walk_bound(tables, scl, scnt, (shadow_o, point, lights), (ko,),
                    act_lr.reshape(-1, TILE), blocked=ko.reshape(-1, TILE))
    tests1, tests2 = b1.pop("member_tests"), b2.pop("member_tests")
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


def capture_depth0_cotangents(scene):
    """One real backward of the frame with the segment sum's inputs
    recorded: (ids, g, T) of the call with the most live rays, which is the
    primary wavefront's."""
    from crt_tpu_torch.ops import segsum

    calls = []
    real = segsum.segment_accumulate

    def recording(ids, g, num_segments, *args, **kw):
        live = int((ids >= 0).sum())
        if not calls or live > calls[0][0]:
            calls[:] = [(live, ids, g, num_segments)]
        recording.count += 1
        return real(ids, g, num_segments, *args, **kw)

    recording.count = 0
    segsum.segment_accumulate = recording
    try:
        image_sum_grads(scene)
    finally:
        segsum.segment_accumulate = real
    check(recording.count == 4,
          f"the backward called the segment sum {recording.count} times, "
          "expected 4 (one per shading level)")
    return calls[0][1:]


def check_segsum(name, ids, g, T):
    """K3 vs plain, vs fp64 and vs itself on (ids [R], g [K, R]); times."""
    from crt_tpu_torch.ops import segsum

    K, R = g.shape
    out = segsum.segment_accumulate(ids, g, T)
    again = segsum.segment_accumulate(ids, g, T)
    torch.cuda.synchronize()
    plain = segsum.segment_accumulate_plain(ids, g, T)
    exact = segsum.segment_accumulate_plain(ids, g.double(), T)
    mass = segsum.segment_accumulate_plain(ids, g.double().abs(), T)
    err = (out.double() - exact).abs()
    plain_err = (plain.double() - exact).abs()
    rel = float((err / mass.clamp(min=1e-300)).max())
    plain_rel = float((plain_err / mass.clamp(min=1e-300)).max())
    vs_plain = (out - plain).abs()
    rerun = float((out - again).abs().max())
    live = int(((ids >= 0) & (ids < T)).sum())
    top = int(torch.bincount(ids[ids >= 0].long(), minlength=1).max())
    print(f"[kernels] segsum {name}: K {K}, R {R}, T {T}, {live} live rays, "
          f"largest segment {top} rays; vs fp64 max abs {float(err.max()):.3e}"
          f" max rel to sum|g| {rel:.3e} (plain version: "
          f"{float(plain_err.max()):.3e}, {plain_rel:.3e}); vs plain max abs "
          f"{float(vs_plain.max()):.3e}; two launches differ by {rerun:.3e}")
    check(bool(torch.isfinite(out).all()), f"segsum {name}: not finite")
    check(bool((err <= 4e-6 * mass).all()),
          f"segsum {name}: off the fp64 sum by {rel:.3e} of sum|g| "
          "(tolerance 4e-6)")
    check(bool((vs_plain.double() <= 5e-4 * mass).all()),
          f"segsum {name}: off the plain version by more than 5e-4 sum|g|")

    col = torch.where((ids >= 0) & (ids < T), ids, T).long()

    def library():
        return torch.zeros((K, T + 1), device=g.device).index_add_(1, col, g)

    ms = cuda_ms(lambda: segsum.segment_accumulate(ids, g, T))
    ms_plain = cuda_ms(lambda: segsum.segment_accumulate_plain(ids, g, T))
    ms_lib = cuda_ms(library)
    b = bound_ms((K + 1) * R * 4 + K * T * 4, K * live)
    print(f"[kernels] segsum {name}: kernel {ms:.3f} ms, plain {ms_plain:.3f}"
          f" ms, index_add_ {ms_lib:.3f} ms, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']})")
    return dict(max_abs_err=float(err.max()),
                max_abs_err_vs_plain=float(vs_plain.max()), ms=ms,
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
    from crt_tpu_torch.ops import intersect
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
    print(f"[scale] big scene: {scene.num_triangles} triangles, "
          f"{tables.n.shape[0]} clusters; list length max {int(cnt.max())} "
          f"mean {float(cnt.float().mean()):.1f}; closest_hit {ms:.3f} ms; "
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

    rays = torch.randperm(R, generator=gen)[:8192].to(device)
    td = intersect.build_triangle_data(
        scene.vertices, scene.tri_vidx,
        scene.mat_backface[scene.tri_material.long()])
    bf = intersect.closest_hit_bruteforce(td, o[rays], d[rays], ray_chunk=512)
    same = tri[rays] == bf.tri
    n_dis = int((~same).sum())
    both = same & (bf.tri >= 0)
    rel = ((t[rays][both] - bf.t[both]).abs()
           / bf.t[both].abs().clamp(min=1e-30))
    max_rel = float(rel.max()) if bool(both.any()) else 0.0
    print(f"[scale] closest_hit vs bruteforce on 8192 rays: {n_dis} tri "
          f"disagreements, max rel t diff {max_rel:.3e} where tri agree "
          f"({int(both.sum())} hits)")
    check(n_dis <= 8, f"{n_dis} of 8192 rays disagree with bruteforce")
    check(max_rel <= 1e-5, f"t differs from bruteforce by {max_rel:.3e}")


def reset_launches():
    from crt_tpu_torch.ops import cluster_trace, segsum

    cluster_trace.closest_hit_launches = 0
    cluster_trace.occlusion_w_launches = 0
    segsum.segsum_launches = 0


def read_launches() -> dict:
    from crt_tpu_torch.ops import cluster_trace, segsum

    return {"closest_hit": cluster_trace.closest_hit_launches,
            "occlusion_w": cluster_trace.occlusion_w_launches,
            "segsum": segsum.segsum_launches}


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
    stats = phase_kernels(device)
    stats["segsum"] = phase_segsum(device)
    phase_scale(device)
    launches = phase_main_path(device)
    launches["segsum"] = phase_train(device)["segsum"]
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    described = (
        ("closest_hit", "crt_tpu_torch/csrc/closest_hit.cu",
         "crt_tpu/ops/pallas_trace.py:655"),
        ("occlusion_w", "crt_tpu_torch/csrc/occlusion_w.cu",
         "crt_tpu/ops/pallas_trace.py:831"),
        ("segsum", "crt_tpu_torch/csrc/segsum.cu",
         "crt_tpu/ops/pallas_segsum.py:75"),
    )
    kernels = [{"name": n, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[n], **stats[n]}
               for n, src, rep in described]
    check(all(k["launches"] > 0 for k in kernels),
          f"a kernel was never launched on the main path: {launches}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

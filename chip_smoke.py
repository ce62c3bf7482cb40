#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (crt_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing what it found; any failure raises (exit code != 0):

  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: nvcc builds the kernels in crt_tpu_torch/csrc (or reuses the
     build); build seconds, cache hit, ptxas register / spill report;
  3. kernels vs their plain PyTorch versions on the card, at the shapes of
     the forward benchmark frame (make_test_scene(1920, 1080, 64)): the
     closest-hit kernel on the primary and on a masked mirror-bounce
     wavefront (tri, t and rows bit-equal), the w-occlusion kernel on the
     depth-0 shadow wavefront (masks equal); CUDA-event times, median of
     5 after 2 warm-ups;
  4. scale: make_big_scene(65536) at 1920x1080 (4096 clusters): the
     closest-hit kernel vs its plain version on 16 sampled tiles (bit-equal)
     and vs the all-pairs backend on 8192 sampled rays;
  5. main path: the CLI renders the benchmark scene from a .crtscene file
     (launch counts reset just before, read just after: 4 and 4 expected);
     render_image on the card vs the all-pairs backend and vs the CPU
     render of a small scene; forward frame time and Mrays/s (median of 5);
  6. a JSON line of the kernels, then the last line
     {"ok": true, "device": {...}}.

Needs one CUDA card; exits with an error when there is none.
"""

from __future__ import annotations

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

    scene = make_test_scene(**BENCH).to(device)
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
    return {
        "closest_hit": dict(max_abs_err=err_k1, ms=ms_k1, plain_ms=ms_k1p),
        "occlusion_w": dict(max_abs_err=err_k2, ms=ms_k2, plain_ms=ms_k2p),
    }


def phase_scale(device, num_triangles=65536, width=1920, height=1080):
    from crt_tpu_torch.ops import intersect
    from crt_tpu_torch.ops.binning import bin_rays
    from crt_tpu_torch.ops.cluster_tables import (
        build_cluster_tables, emit_rows_table,
    )
    from crt_tpu_torch.ops.cluster_trace import closest_hit, closest_hit_plain
    from crt_tpu_torch.scene.procedural import make_big_scene

    scene = make_big_scene(num_triangles=num_triangles, width=width,
                           height=height, seed=0).to(device)
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


def phase_main_path(device):
    from crt_tpu_torch import RenderSettings, render_image
    from crt_tpu_torch.frontend import cli
    from crt_tpu_torch.ops import cluster_trace
    from crt_tpu_torch.scene.procedural import (
        make_test_scene, make_test_scene_dict,
    )

    with tempfile.TemporaryDirectory() as tmp:
        scene_path = os.path.join(tmp, "bench.crtscene")
        out_path = os.path.join(tmp, "bench.ppm")
        with open(scene_path, "w") as f:
            json.dump(make_test_scene_dict(**BENCH), f)
        cluster_trace.closest_hit_launches = 0
        cluster_trace.occlusion_w_launches = 0
        rc = cli.main([scene_path, out_path, "--device", str(device)])
        launches = {"closest_hit": cluster_trace.closest_hit_launches,
                    "occlusion_w": cluster_trace.occlusion_w_launches}
        check(rc == 0, f"CLI exited {rc}")
        with open(out_path) as f:
            tokens = f.read().split()
    W, H = BENCH["width"], BENCH["height"]
    check(tokens[:4] == ["P3", str(W), str(H), "255"],
          f"bad PPM header {tokens[:4]}")
    check(len(tokens) == 4 + W * H * 3, "PPM has the wrong number of values")
    print(f"[main] CLI wrote a {W}x{H} P3 image; kernel launches {launches}")
    check(launches == {"closest_hit": 4, "occlusion_w": 4},
          f"main path launched {launches}, expected 4 and 4")

    scene = make_test_scene(**BENCH).to(device)
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

    small = make_test_scene(64, 36, num_quads=12)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's card path cannot run",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    name = phase_device()
    phase_build()
    stats = phase_kernels(device)
    phase_scale(device)
    launches = phase_main_path(device)
    kernels = [
        {"name": "closest_hit", "route": "cuda",
         "source": "crt_tpu_torch/csrc/closest_hit.cu",
         "replaces": "crt_tpu/ops/pallas_trace.py:655",
         "launches": launches["closest_hit"], **stats["closest_hit"]},
        {"name": "occlusion_w", "route": "cuda",
         "source": "crt_tpu_torch/csrc/occlusion_w.cu",
         "replaces": "crt_tpu/ops/pallas_trace.py:831",
         "launches": launches["occlusion_w"], **stats["occlusion_w"]},
    ]
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

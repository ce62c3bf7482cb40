"""Phase A of the cluster path, kernel against plain, in the host's time:
call by call and frame by frame, for the 32 ``bin_rays`` /
``bin_apex_shared`` calls of one 1080p GI frame (chip_smoke.py's [gi]
scene: K = 4, depth 3) and the 16 of one 1080p glass frame (chip_smoke.py's
GLASS scene, default settings).  chip_smoke.py's [cluster-bin] holds the
same calls bit-equal to the plain version and reads their device time and
bytes bound.

    python3 measure/cluster_bin.py [--out results/cluster_bin.jsonl]

The calls are recorded from the frames themselves (chip_smoke.py
``record_phase_a``: inputs cloned at the call).  For each call, the
kernel's (``binning.bin_rays`` / ``bin_apex_shared`` on CUDA tensors) and
the plain version's (``bin_rays_plain`` / ``bin_apex_shared_plain`` on the
same tensors) host microseconds to return (median of 7, the queue empty
before each).  Then each frame rendered
with the kernel and with the plain binning patched into the trace
factory's module, in turns (kernel, plain, plain, kernel): wall ms (median
of 3, ending in a synchronize), the device launches of a profiled frame
and the frame's ``crt.launches.cluster_bin.*`` counters; the images are held
equal bit for bit.  One JSON line per frame on stdout and, with --out, all
of them in one file.

Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def host_us(fn, reps: int = 7) -> float:
    """Median host time (us) for fn() to return, the queue drained before
    each call: what the call costs the host, not the device."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def per_call(calls) -> list:
    """Kernel and plain host us of every recorded call."""
    rows = []
    for i, (entry, args, kw) in enumerate(calls):
        kernel = cs.phase_a_fn(entry)
        plain = cs.phase_a_fn(entry, plain=True)
        _, counts = kernel(*args, **kw)
        rows.append({
            "call": i, "entry": entry, "rows": int(counts.shape[0]),
            "pairs": int(counts.sum()),
            "kernel_host_us": host_us(lambda: kernel(*args, **kw)),
            "plain_host_us": host_us(lambda: plain(*args, **kw)),
        })
    return rows


def frame_turns(scene, st) -> dict:
    """The frame with the kernel and with the plain binning, in turns."""
    from crt_tpu_torch import render_image
    from crt_tpu_torch.ops import binning, cluster_trace
    from crt_tpu_torch.utils import trace as tracing

    def plain(entry):
        fn = getattr(binning, entry + "_plain")
        return lambda real, *a, **k: fn(*a, **k)

    def render(kind):
        if kind == "kernel":
            return render_image(scene, st)
        with cs.patched(cluster_trace, "bin_rays", plain("bin_rays")), \
                cs.patched(cluster_trace, "bin_apex_shared",
                           plain("bin_apex_shared")):
            return render_image(scene, st)

    out = {"kernel": {"wall_ms": []}, "plain": {"wall_ms": []}}
    images = {}
    for kind in ("kernel", "plain", "plain", "kernel"):
        wall, _ = cs.host_ms(lambda: render(kind), reps=3)
        out[kind]["wall_ms"].append(wall)
        cs.reset_launches()
        _, launches, _ = cs.profile_frame(lambda: render(kind))
        c = cs.counted()
        out[kind].update(
            launches=launches,
            cluster_bin={k.rsplit(".", 1)[1]: v for k, v in c.items()
                         if k.startswith("crt.launches.cluster_bin.")},
            all_launches_counted=tracing.total(c, "crt.launches"))
        images.setdefault(kind, render(kind))
    cs.check(torch.equal(images["kernel"].view(torch.int32),
                         images["plain"].view(torch.int32)),
             "the frame with the kernel differs from the plain binning's")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write every JSON line to this file too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("cluster_bin: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    device = torch.device("cuda", 0)
    card = cs.phase_device()
    cs.phase_build()
    from crt_tpu_torch import RenderSettings
    from crt_tpu_torch.scene.procedural import make_test_scene

    frames = (("gi", cs.GI,
               RenderSettings(diffuse_reflection_ray_count=cs.GI_RAYS)),
              ("glass", cs.GLASS, RenderSettings()))
    lines = []
    for name, kw, st in frames:
        scene = make_test_scene(**kw, device=device)
        calls = cs.record_phase_a(scene, st)
        rows = per_call(calls)
        del calls
        torch.cuda.empty_cache()
        turns = frame_turns(scene, st)
        totals = {k: sum(r[k] for r in rows)
                  for k in ("kernel_host_us", "plain_host_us")}
        print(f"[cluster-bin] {name}: {len(rows)} calls; host us a frame "
              f"kernel {totals['kernel_host_us']:.1f} / plain "
              f"{totals['plain_host_us']:.1f}")
        for r in rows:
            print(f"[cluster-bin]   {name} {r['call']:2d} {r['entry']:16s} "
                  f"rows {r['rows']:6d} pairs {r['pairs']:7d}: host "
                  f"{r['kernel_host_us']:8.1f} / {r['plain_host_us']:8.1f} "
                  f"us")
        for kind in ("kernel", "plain"):
            t = turns[kind]
            print(f"[cluster-bin] {name} frame, {kind} binning: wall "
                  f"{t['wall_ms']} ms, {t['launches']} device launches, "
                  f"cluster_bin {t['cluster_bin']}")
        line = {"frame": name, "card": card, "smi": cs.smi(),
                "calls": rows, "totals": totals, "frames": turns}
        lines.append(line)
        print(json.dumps(line))
        del scene
        torch.cuda.empty_cache()
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(
            "".join(json.dumps(x) + "\n" for x in lines))
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the benchmark of crt_tpu_torch and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks
for.  Set-up (the scene, the warm-up frames or steps, the kernels' build
into the checkout's ``build/``), then the window: ``--trace 0`` measures
the cell's end-to-end metrics for ``--seconds``; ``--trace 1`` profiles a
few units and reads the cell's per-layer metrics from the trace and the
benchmark's spans.  Then the check: what the window produced against the
plain reference under ``benchmark/reference/``.  The last line on
standard output is the result (JSON); the last lines on standard error
are each compared number beside its limit.  Exits 2 without a result
where there is no card or too few, 3 where JAX or the JAX package was
loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CACHE = ROOT / "build" / "bench_cache"
# Every build and kernel cache inside the checkout, at fixed paths.
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
for p in (str(ROOT), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "crt_tpu")


def forbidden_modules() -> list:
    """Top-level names in sys.modules that the benchmark may not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Context:
    """What a metric's reader gets: the window, and for a traced run the
    trace and what the roofline needs."""

    def __init__(self, cell, runner, window):
        self.cell, self.runner, self.window = cell, runner, window
        self.trace = window.trace
        self.unit = runner.unit

    def kernel_names(self, exclude_sources=()) -> set:
        """``__global__`` kernel names of the program's CUDA sources."""
        import re

        import crt_tpu_torch

        csrc = pathlib.Path(crt_tpu_torch.__file__).parent / "csrc"
        pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                         r"(\w+)\s*\(")
        return {m for f in sorted(csrc.glob("*.cu"))
                if f.name not in exclude_sources
                for m in pat.findall(f.read_text())}

    def primary_bound_ms(self):
        """Least time of the traced frames' camera-ray closest hits."""
        import torch

        from harness.roofline import primary_hit_bound
        from reference.render import camera_rays

        if self.unit != "frame" or not self.window.units:
            return None
        s = self.runner.ref_scene
        dev = self.runner.dev
        W, H = s.width, s.height
        py, px = torch.meshgrid(torch.arange(H, device=dev),
                                torch.arange(W, device=dev), indexing="ij")
        verts = torch.as_tensor(s.params["vertices"], device=dev).float()
        tri = torch.as_tensor(s.tri, device=dev)
        pos = torch.as_tensor(s.params["cam_position"], device=dev).float()
        total = 0.0
        for rot in self.runner.traced_cameras(self.window):
            o, d = camera_rays(px.reshape(-1), py.reshape(-1), W, H,
                               s.tan_half_fov, pos, rot)
            total += primary_hit_bound(verts, tri, o.reshape(H, W, 3),
                                       d.reshape(H, W, 3), W, H)["bound_ms"]
        return total


def _read(entries, ctx) -> dict:
    from harness.registry import metric_reader

    out = {}
    for m in entries:
        v = metric_reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t0: float = T0, log=sys.stderr) -> dict:
    """Set up, run the window and check one cell -> the result."""
    import torch

    from harness import driver
    from harness.trace import breakdown, busy_us

    runner = driver.make(cell, device, seed, t0)
    w = runner.run(seconds, trace)
    memory_peak = max(w.setup_peak, w.window_peak)
    ctx = Context(cell, runner, w)
    metrics = _read(cell.per_layer if trace else cell.end_to_end, ctx)
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": cell.chips, "memory_peak_bytes": memory_peak}
    extra = {}
    if trace:
        dev_info["busy_s"] = busy_us(w.trace) / 1e6
        dev_info["window_s"] = w.trace.window_us / 1e6
        extra["breakdown"] = breakdown(w.trace)
    runner.free()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    cmp = runner.compare()
    check_s = time.perf_counter() - t_check
    limits = cell.check["limits"]
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in cmp["numbers"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    if w.unit_s:
        q = statistics.quantiles(w.unit_s, n=4) if len(w.unit_s) > 1 \
            else [w.unit_s[0]] * 3
        print(f"info unit_ms_quartiles {[round(1e3 * x, 3) for x in q]}",
              file=log)
    print(f"info check_s {check_s!r}", file=log)
    for k, v in cmp["info"].items():
        print(f"info {k} {v}", file=log)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=log)
    return {"correct": correct, "attempted": w.units,
            "failed": 0 if correct else w.units, "metrics": metrics,
            "device": dev_info, **extra, "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness.registry import find_cell

    cell = find_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the run's process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

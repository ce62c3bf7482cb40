"""The port's own spans and counters on the benchmark's cells, on a card.

    python3 measure/program_trace.py [--cells a,b] [--phases sync,cost,trace]
        [--seed N] [--out chiprun_out/program_trace.json]

For each cell of BENCHMARK.json (its scene and settings built by the
benchmark's harness):

  - ``sync``: one frame (or fit step), after warm-up, under
    ``torch.cuda.set_sync_debug_mode("warn")`` and ``utils.trace
    .recording()``: the synchronizing calls the card reports, each by the
    port's line that made it, against the ``crt.host_reads.*`` counted;
  - ``cost``: units with tracing off and under ``recording()``, in turns
    (off, on, on, off), host clock around a synchronize, and the device
    counters' sums a unit (each one kernel);
  - ``trace``: the cell's traced window as the benchmark runs it (its
    ``bench.*`` spans on), read both ways: the benchmark's span metrics
    beside the same quantities from the port's ``crt.`` spans, the new
    per-layer metrics, kernels a unit, and the idle gaps labelled with
    the ``crt.`` spans among the host operations and without them.

Prints one line a result and writes them all as JSON to ``--out``.
Needs one CUDA card; ``--device cpu`` rehearses the control flow on the
benchmark's tiny CPU cells (no synchronizing call is reported there).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import statistics
import sys
import time
import traceback
import warnings

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = ROOT / "benchmark"
for _p in (str(ROOT), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

from crt_tpu_torch.utils import trace as tracing  # noqa: E402

PKG = str(ROOT / "crt_tpu_torch")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _site(stack, message) -> str:
    """The innermost frame of the port in a stack; else the message and
    the innermost frames outside the warnings module."""
    for f in reversed(stack):
        if f.filename.startswith(PKG):
            where = pathlib.Path(f.filename).relative_to(ROOT)
            return f"{where}:{f.lineno} {f.name}"
    outer = [f"{f.filename}:{f.lineno} {f.name}" for f in stack
             if not f.filename.endswith("warnings.py")][-4:]
    return f"{str(message)[:120]} at {' < '.join(reversed(outer))}"


class SyncLog:
    """Within the block, the synchronizing calls the card reports, by
    the site that made them."""

    def __enter__(self):
        self.sites = {}
        self._cw = warnings.catch_warnings()
        self._cw.__enter__()
        warnings.simplefilter("always")

        def hook(message, category, filename, lineno, file=None, line=None):
            if "called a synchronizing" not in str(message):
                return
            site = _site(traceback.extract_stack()[:-1], message)
            self.sites[site] = self.sites.get(site, 0) + 1

        warnings.showwarning = hook
        if torch.cuda.is_available():
            torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.set_sync_debug_mode(0)
        self._cw.__exit__(*exc)

    @property
    def total(self) -> int:
        return sum(self.sites.values())


class FrameUnit:
    """A frame of a frame cell, without the benchmark's sample read."""

    def __init__(self, runner):
        self.r = runner

    def __call__(self):
        r = self.r
        k = r.k
        sc = r.scene
        if r.jitter:
            sc = sc.replace(cam_rotation=r.rots[k % r.pattern])
        r.renderer.render_image(sc, r.settings, gi_salt=r.salt(k))
        r.k += 1


class StepUnits:
    """Steps of one ``fit_scene`` call, one a call of ``run(n, hook)``:
    ``hook(i)`` runs in the callback after step i's loss is read."""

    def __init__(self, runner):
        self.r = runner

    def run(self, n: int, hook=None):
        from crt_tpu_torch import optim

        def cb(i, loss):
            if hook is not None:
                hook(i)

        optim.fit_scene(self.r.scene, self.r.target, settings=self.r.settings,
                        steps=n, callback=cb)


def phase_sync(name, runner, unit, dev) -> dict:
    if unit == "frame":
        frame = FrameUnit(runner)
        for _ in range(2):
            frame()
        _sync(dev)
        with tracing.recording() as c, SyncLog() as log:
            frame()
        _sync(dev)
    else:
        steps = StepUnits(runner)
        state = {}

        def hook(i):  # step 2 is the one looked at
            if i == 1:
                state["rec"] = tracing.recording()
                state["c"] = state["rec"].__enter__()
                state["log"] = SyncLog().__enter__()
            elif i == 2:
                state["log"].__exit__(None, None, None)
                state["rec"].__exit__(None, None, None)

        steps.run(3, hook)
        c, log = state["c"], state["log"]
    reads = {k: v for k, v in c.items() if k.startswith("crt.host_reads.")}
    out = {"cell": name, "sync_calls": log.total,
           "host_reads": sum(reads.values()), "reads_by_site": reads,
           "sync_by_site": dict(sorted(log.sites.items(),
                                       key=lambda kv: -kv[1])),
           "counters": dict(c)}
    print(f"[sync] {name}: {log.total} synchronizing calls, "
          f"{out['host_reads']} host reads counted {reads}")
    for site, n in out["sync_by_site"].items():
        print(f"[sync]   {n:4d}  {site}")
    return out


def phase_cost(name, runner, unit, dev, reps: int) -> dict:
    kernels = {"n": 0}
    real = tracing.count

    def count(cname, n=1):
        if isinstance(n, torch.Tensor) and tracing.enabled():
            kernels["n"] += 1
        return real(cname, n)

    times = {"off": [], "on": []}
    if unit == "frame":
        frame = FrameUnit(runner)
        frame()
        _sync(dev)

        def timed(on):
            t = time.perf_counter()
            if on:
                with tracing.recording():
                    frame()
                    _sync(dev)
            else:
                frame()
                _sync(dev)
            return time.perf_counter() - t

        tracing.count = count
        try:
            for mode in ("off", "on", "on", "off"):
                for _ in range(reps):
                    times[mode].append(timed(mode == "on"))
        finally:
            tracing.count = real
        units = 2 * reps
    else:
        # steps in turns inside one fit_scene call: step i + 1 is
        # recorded when i % 4 is 0 or 1 (off, on, on, off, ...)
        state = {"last": None, "rec": None}

        def hook(i):
            _sync(dev)
            now = time.perf_counter()
            if state["rec"] is not None:
                state["rec"].__exit__(None, None, None)
                state["rec"] = None
            if state["last"] is not None:
                times["on" if (i - 1) % 4 in (0, 1) else "off"].append(
                    now - state["last"])
            if i % 4 in (0, 1):
                state["rec"] = tracing.recording()
                state["rec"].__enter__()
            state["last"] = time.perf_counter()

        tracing.count = count
        try:
            StepUnits(runner).run(4 * reps + 1, hook)
        finally:
            tracing.count = real
            if state["rec"] is not None:
                state["rec"].__exit__(None, None, None)
        units = 2 * reps
    out = {"cell": name, "unit": unit,
           "counter_kernels": _counter_kernels(dev),
           "off_ms": [1e3 * x for x in times["off"]],
           "on_ms": [1e3 * x for x in times["on"]],
           "off_median_ms": 1e3 * statistics.median(times["off"]),
           "on_median_ms": 1e3 * statistics.median(times["on"]),
           "device_counts_per_unit": kernels["n"] / units}
    print(f"[cost] {name}: {unit}_ms off {out['off_median_ms']:.3f}, under "
          f"recording() {out['on_median_ms']:.3f} (medians of "
          f"{len(times['off'])}); device counts a {unit} "
          f"{out['device_counts_per_unit']:.1f}, kernels a count "
          f"{out['counter_kernels']}")
    return out


def _counter_kernels(dev) -> dict:
    """Kernels the profiler sees for one device count of a pool-sized
    bool mask and of a tile-sized int32 list."""
    from torch.profiler import ProfilerActivity, profile

    if dev.type != "cuda":
        return {}
    out = {}
    for what, t in (("bool[16777216]", torch.ones(1 << 24, dtype=torch.bool,
                                                  device=dev)),
                    ("int32[2040]", torch.ones(2040, dtype=torch.int32,
                                               device=dev))):
        tracing.count("crt.probe", t)  # warm
        _sync(dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tracing.count("crt.probe", t)
            _sync(dev)
        out[what] = sum(1 for e in prof.events()
                        if str(e.device_type).endswith("CUDA")
                        and not getattr(e, "is_user_annotation", False)
                        and not e.name.startswith(("Memcpy", "Memset")))
    tracing.reset()
    return out


def phase_trace(name, runner, seconds: float) -> dict:
    from harness.program_trace import program_spans
    from harness.registry import metric_reader
    from harness.trace import breakdown, device_ms_under, per_unit

    tracing.reset()
    w = runner.run(seconds, True)
    t = w.trace
    p = program_spans(t)

    def ms(tr, prefix, exclude=()):
        return per_unit(device_ms_under(tr, prefix, exclude), tr)

    ctx = type("Ctx", (), {"trace": t, "window": w})
    new = {m: metric_reader(m)(ctx) for m in (
        "tables_device_ms.frame", "shade_live_share.frame",
        "host_reads.frame", "host_reads.step", "backward_host_ms.step")}
    pairs = {
        "shade": (ms(t, "bench.shade", ("bench.trace", "bench.binning")),
                  ms(p, "crt.shade", ("crt.trace", "crt.binning"))),
        "trace.primary": (ms(t, "bench.trace.primary"),
                          ms(p, "crt.trace.primary")),
        "backward": (ms(t, "bench.backward"), ms(p, "crt.fit.backward")),
        "binning": (ms(t, "bench.binning"),
                    (ms(p, "crt.binning") or 0.0)
                    + (ms(p, "crt.tables.stream") or 0.0)),
        "binning_phase_a": (None, ms(p, "crt.binning")),
        "tables": (None, ms(p, "crt.tables")),
        "tables.stream": (None, ms(p, "crt.tables.stream")),
        "tables.cluster": (None, ms(p, "crt.tables.cluster")),
    }
    recon = {}
    for k, (bench, crt) in pairs.items():
        gap = (100.0 * (crt - bench) / bench
               if bench and crt is not None else None)
        recon[k] = {"bench_ms": bench, "crt_ms": crt, "gap_pct": gap}
        print(f"[trace] {name}: {k}: bench {bench}, crt {crt}, "
              f"gap {gap if gap is None else round(gap, 3)} %")
    kernels = per_unit(sum(1 for o in t.ops if o.is_kernel), t)
    without = dataclasses.replace(
        t, host_ops=[h for h in t.host_ops if not h[0].startswith("crt.")])
    out = {"cell": name, "units": t.units, "window_ms": t.window_us / 1e3,
           "kernels_per_unit": kernels, "new_metrics": new,
           "reconcile": recon, "idle_gaps": breakdown(t)["idle_gaps"],
           "idle_gaps_without_crt": breakdown(without)["idle_gaps"],
           "counters": dict(tracing.counters())}
    print(f"[trace] {name}: {t.units} units, kernels a unit {kernels}; "
          f"new metrics {new}")
    print(f"[trace] {name}: idle gaps {out['idle_gaps']}")
    print(f"[trace] {name}: idle gaps without crt. spans "
          f"{out['idle_gaps_without_crt']}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", default="soup1m.frames,quads64.gi_frames,"
                                       "quads64.fit")
    ap.add_argument("--phases", default="sync,cost,trace")
    ap.add_argument("--seed", type=int, default=2 ** 31 + 2718)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "program_trace.json"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    from harness import driver
    from harness.registry import find_cell

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("program_trace: no CUDA device", file=sys.stderr)
            return 2
        dev = torch.device("cuda", 0)
        kind = torch.cuda.get_device_name(dev)
    else:
        sys.path.insert(0, str(BENCH / "tests"))
        from bench_setup import tiny_cell

        dev, kind = torch.device("cpu"), "cpu (tiny cells)"
    print(f"[device] {kind}, torch {torch.__version__}")
    phases = args.phases.split(",")
    results = {"device": kind, "cells": {}}
    for name in args.cells.split(","):
        cell = find_cell(name) if dev.type == "cuda" else tiny_cell(name)
        unit = cell.traffic["unit"]
        runner = driver.make(cell, dev, args.seed, time.perf_counter())
        res = results["cells"][name] = {}
        if "sync" in phases:
            res["sync"] = phase_sync(name, runner, unit, dev)
        if "cost" in phases:
            res["cost"] = phase_cost(name, runner, unit, dev, args.reps)
        if "trace" in phases:
            res["trace"] = phase_trace(name, runner, 60.0)
        runner.free()
        del runner
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1, default=str))
    print(f"[done] wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time K1-K4 at their redesign shapes against an older checkout's kernels
in turns, and K3 beside two designs of it that were built and not taken.

    python3 measure/redesign_turns.py PARENT_DIR

PARENT_DIR holds another checkout's ``crt_tpu_torch/csrc`` (for example
``git archive <commit> crt_tpu_torch/csrc | tar -x -C build/parent``) from
before the live-list kernel: its K4 entry point takes the live-first tile
list from its wrapper (a stable argsort of the tile counts) and its K3
adds into an output the wrapper zeroed.  chip_smoke.py ``--parent`` needs a
checkout with this one's interface; this script launches such an older
library's K4 and K3 the way its own wrappers did.  It prints:

  - every shape of ``chip_smoke.kernel_shapes`` held and timed in turns
    with the parent's kernels (``chip_smoke.shape_turns``: parent, new,
    new, parent);
  - at every K3 shape, the designs in this directory
    (``segsum_scan_ring.cu``: rows staged through a cp.async ring and
    reduced by a warp segmented scan on a persistent grid;
    ``segsum_persistent.cu``: a lane per row on a persistent grid of equal
    ray ranges) held to the fp64 sum and the plain version, and the device
    time and 10-launch time of each build in turns (parent, scan ring,
    persistent, new, new, persistent, scan ring, parent);
  - the opaque and glass frames profiled in turns
    (``chip_smoke.profile_turns``).

Needs one CUDA card.  Builds into the gitignored ``build/measure/``.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import pathlib
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

DESIGNS = {"scan ring": "segsum_scan_ring.cu",
           "persistent": "segsum_persistent.cu"}
# The older library's entry points: runs of pointer, int, pointer, ...
# arguments (its K4 takes n_live and the tile list first).
PARENT_ARGTYPES = {
    "crt_closest_hit": (11, 4, 4), "crt_closest_hit_compact": (13, 5, 4),
    "crt_occlusion_w": (11, 7, 3), "crt_occlusion_d": (11, 4, 2),
    "crt_closest_hit_merged": (11, 5, 4),
    "crt_closest_hit_stream": (2, 1, 13, 6, 4),
    "crt_occlusion_stream": (3, 1, 12, 6, 2),
    "crt_segment_accumulate": (2, 3, 2),
}


def bind_parent(path):
    """The older library, its entry points declared; refuses one that has
    the live-list kernel (chip_smoke.py --parent takes that)."""
    lib = ctypes.CDLL(path)
    cs.check(not hasattr(lib, "crt_live_tiles"),
             f"{path} has crt_live_tiles: use chip_smoke.py --parent")
    for name, runs in PARENT_ARGTYPES.items():
        types = []
        for n, kind in zip(runs, "pipipi"):
            types += [ctypes.c_void_p if kind == "p" else ctypes.c_int] * n
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = types, ctypes.c_int
    lib.crt_older = True
    return lib


def parent_list(counts):
    """(tile_ids, n_live) as the older K4's wrapper built them."""
    live = counts > 0
    return (torch.argsort((~live).to(torch.int32), stable=True)
            .to(torch.int32), live.sum(dtype=torch.int32).reshape(1))


def parent_compact(lib, tables, o, d, cl, cnt, rows_table=None, tile_mod=0):
    """The older K4, launched as its wrapper launched it."""
    from crt_tpu_torch.ops.cluster_tables import TILE_RAYS

    R, L = d.shape[0], tables.n.shape[0]
    kp = 0 if rows_table is None else rows_table.shape[-1]
    tile_ids, n_live = parent_list(cnt)
    t = torch.empty((R,), device=d.device)
    tri = torch.empty((R,), dtype=torch.int32, device=d.device)
    rows = torch.empty((kp, R), device=d.device) if kp else None
    err = lib.crt_closest_hit_compact(
        n_live.data_ptr(), tile_ids.data_ptr(), o.data_ptr(), d.data_ptr(),
        tables.n.data_ptr(), tables.nv0.data_ptr(), tables.m.data_ptr(),
        tables.c.data_ptr(), tables.nobf.data_ptr(), tables.tri_id.data_ptr(),
        cl.data_ptr(), cnt.data_ptr(),
        rows_table.data_ptr() if kp else None, L, cnt.numel(), TILE_RAYS,
        tile_mod, kp, t.data_ptr(), tri.data_ptr(),
        rows.data_ptr() if kp else None,
        torch.cuda.current_stream().cuda_stream)
    cs.check(err == 0, f"the parent's closest_hit_compact failed: {err}")
    return t, tri, rows


def parent_segsum(lib, ids, g, T):
    """The older K3, launched as its wrapper launched it."""
    K, R = g.shape
    out = torch.zeros((K, T), device=g.device)
    err = lib.crt_segment_accumulate(g.data_ptr(), ids.data_ptr(), K, R, T,
                                     out.data_ptr(),
                                     torch.cuda.current_stream().cuda_stream)
    cs.check(err == 0, f"the parent's segment_accumulate failed: {err}")
    return out


class kernels_from(cs.kernels_from):
    """chip_smoke's kernels_from, with the older library's K4, its tile
    list and K3 launched through parent_compact, parent_list and
    parent_segsum."""

    def __enter__(self):
        from crt_tpu_torch.ops import cluster_trace, segsum

        super().__enter__()
        self.wrappers = (cluster_trace.closest_hit_compact,
                         cluster_trace.live_tiles, segsum.segment_accumulate)
        lib = self.lib
        if getattr(lib, "crt_older", False):
            cluster_trace.closest_hit_compact = (
                lambda *args, **kw: parent_compact(lib, *args, **kw))
            cluster_trace.live_tiles = parent_list
            segsum.segment_accumulate = (
                lambda ids, g, T: parent_segsum(lib, ids, g, T))

    def __exit__(self, *exc):
        from crt_tpu_torch.ops import cluster_trace, segsum

        (cluster_trace.closest_hit_compact, cluster_trace.live_tiles,
         segsum.segment_accumulate) = self.wrappers
        super().__exit__(*exc)


def build_designs() -> dict:
    """Each design of DESIGNS built by nvcc (all at once) with the port's
    flags, its K3 entry point declared."""
    from crt_tpu_torch.ops import cuda_lib

    procs = {}
    for name, src in DESIGNS.items():
        out = ROOT / "build" / "measure" / pathlib.Path(src).stem
        out.mkdir(parents=True, exist_ok=True)
        procs[name] = (out / "lib.so", subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(out / "lib.so"),
             str(HERE / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0]
        cs.check(proc.returncode == 0, f"{name}: nvcc failed:\n{log}")
        regs = sorted({ln.split("Used ")[1].split(",")[0]
                       for ln in log.splitlines() if "Used " in ln})
        print(f"[designs] {name}: built, {'; '.join(regs)}")
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.crt_segment_accumulate.argtypes = [p, p, i, i, i, p, p]
        lib.crt_segment_accumulate.restype = i
        libs[name] = lib
    return libs


def design_turns(sh, parent, designs):
    """K3's shape ``sh`` with every design held to its tolerances, then
    each build's device time and 10-launch time in turns."""
    ids, g, T = sh["inputs"]
    run = sh["calls"]["kernel"]
    for name, lib in designs.items():
        out = run(lib)
        torch.cuda.synchronize()
        cs.hold_segsum(f"[designs] {sh['name']}, {name}", ids, g, T, out)
    builds = {"parent": parent, **designs, "new": None}
    order = list(builds) + list(reversed(builds))
    times = {}
    for who in order:
        fn = (lambda lib=builds[who]: run(lib))
        times.setdefault(who, []).append((cs.device_ms(fn),
                                          cs.cuda_ms_many(fn)))
    for who, v in times.items():
        print(f"[designs] {sh['name']}, {who}: device "
              + ", ".join(f"{d:.4f}" for d, _ in v) + " ms; 10 back to back "
              + ", ".join(f"{m:.4f}" for _, m in v) + " ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", metavar="PARENT_DIR")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("redesign_turns: no CUDA device", file=sys.stderr)
        return 2
    from crt_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    device = torch.device("cuda", 0)
    cs.phase_device()
    cs.phase_build()
    info = cuda_lib.build(os.path.join(args.parent, "crt_tpu_torch", "csrc"))
    print(f"[turns] parent kernels {info.path}: {info.seconds:.2f} s in nvcc")
    parent = bind_parent(info.path)
    designs = build_designs()
    cs.kernels_from = kernels_from
    for sh in cs.kernel_shapes(device):
        cs.shape_turns(sh, parent)
        if sh["kernel"] == "K3":
            design_turns(sh, parent, designs)
    cs.profile_turns(device, parent)
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

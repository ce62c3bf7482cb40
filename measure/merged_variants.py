"""Time K7 (the tile-merged closest hit: a block for each merge group and
256-lane window, K1's walk once a sub-tile) against a persistent design
that was built and not taken, and against builds that differ from that
design in one choice, at chip_smoke.py's K7 shapes.

    python3 measure/merged_variants.py

Each build is this checkout's ``crt_tpu_torch/csrc`` with
``closest_hit.cu`` replaced by ``measure/closest_hit_persistent.cu`` (K7
on a persistent grid, items taken one at a time from a counter, an empty
group's misses in 16-byte stores, a list that the next sub-tile repeats
walked again from the staged ring), and with one substitution in it,
built into the gitignored ``build/measure/merged/``:

  - ``persistent design``: none;
  - ``static items``: items taken at the grid's stride (as K1 takes its
    units), the masks of CRT_BLOCK items read at once, instead of one at a
    time from the counter;
  - ``no reuse``: every sub-tile stages its list, as K1 does;
  - ``tests compiled twice``: the staged batches walked by a loop of
    their own beside the staging walk, as K7's first build did;
  - ``a block an item``: as many blocks as items, so the hardware
    schedules them;
  - ``four blocks an SM``: registers bounded to K1's 64 (ptxas spills).

Each build's K7 is counted in SASS instructions (cuobjdump).
At every K7 shape of ``chip_smoke.kernel_shapes`` (the other shapes are
built and skipped) each build is held equal to this checkout's kernel on
every lane, and its time is taken in turns with it and with K1 on the same
lists: this checkout, K1, every build, then every build again in reverse
order, K1 and this checkout, each time 10 launches back to back
(``cuda_ms_many``) and the profiler's device time (``device_ms``).

Needs one CUDA card.
"""

from __future__ import annotations

import pathlib
import re
import shutil
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

FILE = "closest_hit.cu"
DESIGN = HERE / "closest_hit_persistent.cu"
DYNAMIC_HEAD = """  for (;;) {
    __syncthreads();  // the previous item's s_item and s_mask are read
    if (threadIdx.x == 0) {
      s_item = (int)atomicAdd(&k7_items_taken, 1u);
      s_mask = s_item < items ? group_mask(a.counts, s_item / windows, merge)
                              : 0u;
    }
    __syncthreads();
    const int i = s_item;
    if (i >= items) break;
    const unsigned mask = s_mask;"""
STATIC_HEAD = """  __shared__ unsigned s_masks[CRT_BLOCK];
  for (int i0 = blockIdx.x; i0 < items; i0 += CRT_BLOCK * gridDim.x) {
    __syncthreads();  // the previous chunk's masks are read
    const long long mine = i0 + (long long)threadIdx.x * gridDim.x;
    s_masks[threadIdx.x] =
        mine < items ? group_mask(a.counts, mine / windows, merge) : 0u;
    __syncthreads();
    for (int k = 0; k < CRT_BLOCK; ++k) {
    const long long ik = i0 + (long long)k * gridDim.x;
    if (ik >= items) break;
    const int i = (int)ik;
    const unsigned mask = s_masks[k];"""
KERNEL_END = """      write_hit(a, r, w.best_t, w.best_tri, w.best_slot);
    }
  }
}"""
KERNEL = ("__global__ void __launch_bounds__(CRT_BLOCK) "
          "closest_hit_merged_kernel(")
GRID = """  const long long grid =
      persistent_grid((const void*)closest_hit_merged_kernel, items);"""
WALK = "      walk_list(ring, pl, list, count, shared, again, w);"
VARIANTS = {
    "persistent design": [],
    "static items": [(FILE, DYNAMIC_HEAD, STATIC_HEAD),
                     (FILE, KERNEL_END, KERNEL_END + "\n}")],
    "no reuse": [(FILE, "bool again = s_held == count &&",
                  "bool again = false && s_held == count &&")],
    "tests compiled twice": [(FILE, WALK, """      if (again) {
        for (int bi = 0; bi * CRT_BATCH < count; ++bi)
          test_batch(ring, bi, batch_size(bi, count), shared, w);
      } else {
        walk_list(ring, pl, list, count, shared, false, w);
      }""")],
    "a block an item": [(FILE, GRID, "  const long long grid = items;")],
    "four blocks an SM": [
        (FILE, KERNEL, KERNEL.replace("(CRT_BLOCK)", "(CRT_BLOCK, 4)"))],
}


def sass_size(lib_path) -> int:
    """Instructions of K7's kernel in the library's SASS (cuobjdump)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        if "closest_hit_merged_kernel" in part.split("\n", 1)[0]:
            return len(re.findall(r"/\*[0-9a-f]{4,}\*/\s+\S", part))
    return -1


def build_variant(name, edits):
    """This checkout's csrc with the design's closest_hit.cu and ``edits``
    (file, old, new) applied, built; -> the bound library."""
    from crt_tpu_torch.ops import cuda_lib

    slug = re.sub(r"\W+", "_", name)
    csrc = ROOT / "build" / "measure" / "merged" / slug / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(cuda_lib.CSRC, csrc)
    shutil.copyfile(DESIGN, csrc / FILE)
    for file, old, new in edits:
        src = (csrc / file).read_text()
        cs.check(old in src, f"{name}: {file} has no {old!r}")
        (csrc / file).write_text(src.replace(old, new))
    info = cuda_lib.build(csrc)
    print(f"[variants] {name}: {info.seconds:.2f} s in nvcc; K7's SASS "
          f"{sass_size(info.path)} instructions")
    return cs.bind_parent(info.path)


def main() -> int:
    if not torch.cuda.is_available():
        print("merged_variants: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    device = torch.device("cuda", 0)
    cs.phase_device()
    cs.phase_build()
    from crt_tpu_torch.ops import cuda_lib

    print(f"[variants] this checkout: K7's SASS "
          f"{sass_size(cuda_lib.build().path)} instructions")
    libs = {name: build_variant(name, edits)
            for name, edits in VARIANTS.items()}
    order = [None, "K1", *libs]  # None: this checkout's K7
    turns = order + order[::-1]
    for sh in cs.kernel_shapes(device):
        if sh["kernel"] != "K7":
            continue
        run, k1 = sh["calls"]["kernel"], sh["calls"]["K1"]
        for name, lib in libs.items():
            got = run(lib)
            cs.check(all(torch.equal(a, b) for a, b in zip(got, sh["out"])
                         if a is not None),
                     f"{sh['name']}: {name} differs from this checkout")
        for label, timer in (("b2b", cs.cuda_ms_many),
                             ("device", cs.device_ms)):
            times = {name: [] for name in order}
            for name in turns:
                fn = (k1 if name == "K1" else
                      (lambda lib=libs.get(name): run(lib)))
                times[name].append(timer(fn))
            print(f"[variants] {sh['tag']} {sh['name']} ({label} ms, in "
                  "turns): " + "; ".join(
                      f"{name or 'this checkout'} "
                      + ", ".join(f"{v:.4f}" for v in times[name])
                      for name in order))
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

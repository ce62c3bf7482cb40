"""Time K5 and K6 against builds that differ from this checkout's in one
design choice, at chip_smoke.py's K5 / K6 shapes.

    python3 measure/occlusion_d_variants.py [--sass DIR]

Each variant is this checkout's ``crt_tpu_torch/csrc`` with one
substitution, built into the gitignored ``build/measure/occlusion_d/``:

  - ``vote never``, ``vote <= 8``, ``vote <= 128``, ``vote always``: the
    warp votes that skip a member's divide and edges on lists of at most
    that many clusters, and the copies of the longer walks on the others
    (this checkout: CRT_VOTE_LIST, 32; K2's walk changes too, but only K5
    / K6 are timed here);
  - ``pack always``, ``pack never``: repeated rays packed on every list,
    or on none (this checkout: on lists longer than CRT_VOTE_LIST);
  - ``nobf under the gate``: each member's tail word (its nobf) read
    under the face gate's ``||``, as the first build of this design did.

At every K5 / K6 shape of ``chip_smoke.kernel_shapes`` (the other shapes
are built and skipped) each variant is held equal to this checkout's
kernel on every lane, and its time is taken in turns with it: this
checkout, every variant, then every variant again in reverse order and
this checkout, each time 10 launches back to back (``cuda_ms_many``) and
the profiler's device time (``device_ms``).  ``--sass DIR`` also writes
the SASS of the K5 / K6 kernel and of K2's capped kernel of this checkout
and of each variant (cuobjdump) into DIR and prints each one's
instruction count by opcode.

Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import collections
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

VOTE = ("cluster_common.cuh",
        "if (count <= CRT_VOTE_LIST) {  // uniform over the block")
PACK = ("occlusion_d.cu", "const bool pack = count > CRT_VOTE_LIST;")
VARIANTS = {
    "vote never": [(*VOTE, "if (count <= 0) {")],
    "vote <= 8": [(*VOTE, "if (count <= 8) {")],
    "vote <= 128": [(*VOTE, "if (count <= 128) {")],
    "vote always": [(*VOTE, "if (true) {")],
    "pack always": [(*PACK, "const bool pack = true;")],
    "pack never": [(*PACK, "const bool pack = false;")],
    "nobf under the gate": [
        ("occlusion_d.cu", "(opd < 0.0f) || (tw.x > 0.5f)",
         "(opd < 0.0f) || (rec_word(slot, 4).x > 0.5f)"),
    ],
}
# The kernels whose SASS --sass writes: K5 / K6, and K2's capped mode.
SASS_KERNELS = {"occlusion_d": "occlusion_d_kernel",
                "occlusion_w_capped": "occlusion_w_kernelILb1ELb0ELb0E"}


def build_variant(name, edits):
    """This checkout's csrc with ``edits`` (file, old, new) applied, built;
    -> the bound library."""
    from crt_tpu_torch.ops import cuda_lib

    slug = re.sub(r"\W+", "_", name)
    csrc = ROOT / "build" / "measure" / "occlusion_d" / slug / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(cuda_lib.CSRC, csrc)
    for file, old, new in edits:
        src = (csrc / file).read_text()
        cs.check(old in src, f"{name}: {file} has no {old!r}")
        (csrc / file).write_text(src.replace(old, new))
    info = cuda_lib.build(csrc)
    print(f"[variants] {name}: {info.seconds:.2f} s in nvcc")
    return cs.bind_parent(info.path)


def write_sass(out_dir, label, lib_path):
    """The SASS of SASS_KERNELS in the library at ``lib_path``, one file
    each in ``out_dir`` (prefixed ``label``); prints each one's
    instruction count, its most frequent opcodes and the instructions
    between two members' divide checks (FCHK)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    slug = re.sub(r"\W+", "_", label)
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name = part.split("\n", 1)[0].strip()
        for short, key in SASS_KERNELS.items():
            if key not in name:
                continue
            (out_dir / f"{slug}.{short}.sass").write_text(part)
            ops = [op.split(".")[0] for op in re.findall(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                r"([A-Z][A-Z0-9_.]*)", part)]
            checks = [i for i, op in enumerate(ops) if op == "FCHK"]
            gaps = sorted({b - a for a, b in zip(checks, checks[1:])})
            top = collections.Counter(ops).most_common(16)
            print(f"[sass] {label}, {short}: {len(ops)} instructions; "
                  + ", ".join(f"{op} {n}" for op, n in top)
                  + f"; between divide checks {gaps}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass", metavar="DIR",
                    help="also write the SASS of K5 / K6 and K2 capped")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("occlusion_d_variants: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    device = torch.device("cuda", 0)
    cs.phase_device()
    cs.phase_build()
    libs = {name: build_variant(name, edits)
            for name, edits in VARIANTS.items()}
    if args.sass:
        from crt_tpu_torch.ops import cuda_lib

        write_sass(args.sass, "this checkout", cuda_lib.build().path)
        for name, lib in libs.items():
            write_sass(args.sass, name, lib._name)
    order = [None, *libs]  # None: this checkout's kernels
    turns = order + order[::-1]
    for sh in cs.kernel_shapes(device):
        if sh["kernel"] not in ("K5", "K6"):
            continue
        run = sh["calls"]["kernel"]
        for name, lib in libs.items():
            cs.check(torch.equal(run(lib), sh["out"][0]),
                     f"{sh['name']}: {name} differs from this checkout")
        for label, timer in (("b2b", cs.cuda_ms_many),
                             ("device", cs.device_ms)):
            times = {name: [] for name in order}
            for name in turns:
                lib = None if name is None else libs[name]
                times[name].append(timer(lambda: run(lib)))
            print(f"[variants] {sh['tag']} {sh['name']} ({label} ms, in "
                  "turns): " + "; ".join(
                      f"{name or 'this checkout'} "
                      + ", ".join(f"{v:.4f}" for v in times[name])
                      for name in order))
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Render every course scene and write PPM + PNG artifacts + a results table.

Counterpart of crt_tpu's ``tools/render_all.py`` (the reference's
tools/submit_render_task.sh: render every scene of a task, convert PPM to
PNG, regenerate the README table).  The PNGs are written by
``io/png.py``; each scene is also compared with its golden
(``$CRT_REFERENCE``, ``utils/golden.py``).  The default outdir is
``results_torch``.  Returns 1 when a case failed, 2 when the corpus or the
device is missing.

Usage:
    python -m crt_tpu_torch.tools.render_all [outdir] [filter ...]
        [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="render_all",
        description="render the course scenes into PPM, PNG and a table")
    p.add_argument("outdir", nargs="?", default="results_torch")
    p.add_argument("filters", nargs="*",
                   help="substrings of the scene paths to keep")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; cpu must be asked for)")
    args = p.parse_args(argv)

    from crt_tpu_torch import RenderSettings, load_scene, render_image
    from crt_tpu_torch.io.png import write_png
    from crt_tpu_torch.io.ppm import quantize, write_ppm
    from crt_tpu_torch.tools import resolve_device_arg
    from crt_tpu_torch.utils import golden

    device = resolve_device_arg(args.device)
    if device is None:
        return 2
    try:
        scenes = golden.reference_root() / "scenes"
    except FileNotFoundError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 2
    outdir = args.outdir
    os.makedirs(os.path.join(outdir, "ppm"), exist_ok=True)
    os.makedirs(os.path.join(outdir, "png"), exist_ok=True)

    cases = golden.LEGACY_GOLDEN_CASES + golden.HEAD_GOLDEN_CASES
    if args.filters:
        cases = [c for c in cases if any(f in c[0] for f in args.filters)]

    rows = []
    failed = 0
    for rel, name, overrides in cases:
        t0 = time.time()
        try:
            scene = load_scene(str(scenes / rel), device=device)
            # aov is a RenderSettings field: profiles apply verbatim.
            img = render_image(scene, RenderSettings(**overrides))
            img = img.cpu().numpy()
            dt = time.time() - t0
            write_ppm(img, os.path.join(outdir, "ppm", f"{name}.ppm"))
            write_png(quantize(img).astype(np.uint8),
                      os.path.join(outdir, "png", f"{name}.png"))
            frac, mae = golden.match_stats(img, golden.load_golden(name))
        except Exception as e:  # noqa: BLE001 - one case; the sweep goes on
            rows.append((name, "ERROR", type(e).__name__, str(e)[:60]))
            print(f"{name}: ERROR {e}", flush=True)
            failed += 1
            continue
        rows.append((name, f"{dt:.2f}s", f"{frac:.4f}", f"{mae:.5f}"))
        print(f"{name}: t={dt:.2f}s frac={frac:.4f}", flush=True)

    with open(os.path.join(outdir, "README.md"), "w") as f:
        f.write("# crt_tpu_torch renders of the course scenes\n\n")
        f.write("| Scene | Render time | Golden match | MAE |\n"
                "|---|---|---|---|\n")
        for r in rows:
            f.write("| " + " | ".join(r) + " |\n")
    print(f"wrote {outdir}/README.md")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

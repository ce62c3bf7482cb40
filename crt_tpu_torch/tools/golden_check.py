"""Render every golden-covered scene and report pixel-match stats.

Counterpart of crt_tpu's ``tools/golden_check.py``: the same cases
(``utils/golden.LEGACY_GOLDEN_CASES + HEAD_GOLDEN_CASES``, each with its
settings profile), the same substring filters on the scene path and the
same ``--json`` output.  Scenes are read from ``$CRT_REFERENCE/scenes``,
goldens from ``$CRT_REFERENCE/results/png`` (``utils/golden.py``).
Returns 1 when a case failed to render or compare, 2 when the corpus or
the device is missing.

Usage:
    python -m crt_tpu_torch.tools.golden_check [case-substring ...]
        [--json out.json] [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="golden_check",
        description="render the golden-covered scenes and compare")
    p.add_argument("filters", nargs="*",
                   help="substrings of the scene paths to keep")
    p.add_argument("--json", metavar="OUT", help="write the stats here")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; cpu must be asked for)")
    args = p.parse_args(argv)

    from crt_tpu_torch import RenderSettings, load_scene, render_image
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
    cases = golden.LEGACY_GOLDEN_CASES + golden.HEAD_GOLDEN_CASES
    if args.filters:
        cases = [c for c in cases if any(f in c[0] for f in args.filters)]

    results = []
    failed = 0
    for rel, name, overrides in cases:
        t0 = time.time()
        try:
            scene = load_scene(str(scenes / rel), device=device)
            # aov is a RenderSettings field: profiles apply verbatim
            # (render_image routes AOV passes itself).
            img = render_image(scene, RenderSettings(**overrides))
            frac, mae = golden.match_stats(img.cpu().numpy(),
                                           golden.load_golden(name))
        except Exception as e:  # noqa: BLE001 - one case; the sweep goes on
            print(f"{name}: ERROR {type(e).__name__}: {e}", flush=True)
            results.append((name, 0.0, 1.0))
            failed += 1
            continue
        dt = time.time() - t0
        print(f"{name}: frac={frac:.4f} mae={mae:.5f} t={dt:.1f}s",
              flush=True)
        results.append((name, frac, mae))

    worst = min(results, key=lambda r: r[1]) if results else None
    print(f"\n{len(results)} cases, worst: {worst}")

    if args.json:
        with open(args.json, "w") as f:
            json.dump(
                [{"name": n, "frac": round(fr, 5), "mae": round(m, 6)}
                 for n, fr, m in results],
                f,
                indent=1,
            )
        print(f"wrote {args.json}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

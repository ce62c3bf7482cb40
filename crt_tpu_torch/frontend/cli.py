"""Standalone CLI — the ``crt_renderer`` equivalent, on PyTorch.

Usage:
    python -m crt_tpu_torch.frontend.cli [scene.crtscene] [out.ppm]
        [--backend auto|cluster|pallas|stream|pallas_stream|bruteforce|tree]
        [--aov bary|normal|depth|tri_id|albedo] [--max-ray-depth D]
        [--head-compat] [--width W] [--height H] [--gi-rays K]
        [--repeat N] [--device cpu|cuda]

Counterpart of ``crt_tpu/frontend/cli.py``: wall-clock time of the render
(excluding scene load) printed as "Execution time: N seconds.", then an
ASCII P3 image.  On CUDA the timed region ends in a device synchronize.
Without a scene the CLI renders the reference CLI's default,
``scenes/15-01-conclusion/scene2.crtscene`` of the reference checkout that
``$CRT_REFERENCE`` names (``utils/golden.reference_root``); where it is not
set, that is the error of a scene that will not load (rc 1).
``--aov`` renders an auxiliary pass instead of the beauty image,
``--max-ray-depth`` overrides the depth, ``--head-compat`` switches on the
reference HEAD's quirks (no shadows, the unconditional GI divide), and
``--gi-rays`` sets the GI samples a diffuse hit
(``diffuse_reflection_ray_count``) for a scene with GI on.
``--device`` defaults to ``cuda``: without a visible card the CLI prints an
error and returns 2 unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from crt_tpu_torch.io.ppm import write_ppm
from crt_tpu_torch.renderer import AOVS, render_image_hwc
from crt_tpu_torch.scene.json_loader import SceneFormatError, load_scene
from crt_tpu_torch.scene.types import RenderSettings, resolve_device
from crt_tpu_torch.utils.golden import reference_root

# the reference CLI's default scene, under the reference checkout
DEFAULT_SCENE = "scenes/15-01-conclusion/scene2.crtscene"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="crt-render-torch",
        description="CRT ray tracer (PyTorch / CUDA port)",
    )
    p.add_argument("scene", nargs="?", default=None,
                   help="input .crtscene (default: the reference CLI's, "
                        f"$CRT_REFERENCE/{DEFAULT_SCENE})")
    p.add_argument("output", nargs="?", default="output.ppm")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "cluster", "pallas", "stream",
                            "pallas_stream", "bruteforce", "tree"])
    p.add_argument("--aov", default="", choices=["", *AOVS],
                   help="render an auxiliary pass instead of beauty")
    p.add_argument("--max-ray-depth", type=int, default=None)
    p.add_argument("--head-compat", action="store_true",
                   help="replicate reference-HEAD quirks (no shadows, "
                        "unconditional GI divide)")
    p.add_argument("--width", type=int, default=None, help="override width")
    p.add_argument("--height", type=int, default=None, help="override height")
    p.add_argument("--gi-rays", type=int, default=None,
                   help="GI samples a diffuse hit (scenes with GI on)")
    p.add_argument("--repeat", type=int, default=1,
                   help="re-render N times and report the best time")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; cpu must be asked for)")
    args = p.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 2

    path = args.scene
    try:
        if path is None:
            path = str(reference_root() / DEFAULT_SCENE)
        scene = load_scene(path, device=device)
    except (OSError, SceneFormatError, ValueError) as e:
        print(f"Error: Could not parse scene file: {path or DEFAULT_SCENE}: "
              f"{e}", file=sys.stderr)
        return 1
    if args.width or args.height:
        scene = scene.replace(width=args.width or scene.width,
                              height=args.height or scene.height)
    settings = RenderSettings(backend=args.backend,
                              head_compat=args.head_compat, aov=args.aov)
    if args.max_ray_depth is not None:
        settings = settings.replace(max_ray_depth=args.max_ray_depth)
    if args.gi_rays is not None:
        settings = settings.replace(diffuse_reflection_ray_count=args.gi_rays)

    best = float("inf")
    image = None
    for _ in range(max(1, args.repeat)):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        start = time.perf_counter()
        image = render_image_hwc(scene, settings)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        best = min(best, time.perf_counter() - start)

    print(f"Execution time: {best} seconds.")
    write_ppm(image.cpu().numpy(), args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())

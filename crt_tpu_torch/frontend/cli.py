"""Standalone CLI — the ``crt_renderer`` equivalent, on PyTorch.

Usage:
    python -m crt_tpu_torch.frontend.cli scene.crtscene [out.ppm]
        [--backend auto|cluster|pallas|bruteforce] [--width W] [--height H]
        [--repeat N] [--device cpu|cuda]

Counterpart of ``crt_tpu/frontend/cli.py``: wall-clock time of the render
(excluding scene load) printed as "Execution time: N seconds.", then an
ASCII P3 image.  On CUDA the timed region ends in a device synchronize.
``--device`` defaults to ``cuda``: without a visible card the CLI prints an
error and returns 2 unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from crt_tpu_torch.io.ppm import write_ppm
from crt_tpu_torch.renderer import render_image_hwc
from crt_tpu_torch.scene.json_loader import SceneFormatError, load_scene
from crt_tpu_torch.scene.types import RenderSettings, resolve_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="crt-render-torch",
        description="CRT ray tracer (PyTorch / CUDA port)",
    )
    p.add_argument("scene", help="input .crtscene")
    p.add_argument("output", nargs="?", default="output.ppm")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "cluster", "pallas", "bruteforce"])
    p.add_argument("--width", type=int, default=None, help="override width")
    p.add_argument("--height", type=int, default=None, help="override height")
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

    try:
        scene = load_scene(args.scene, device=device)
    except (OSError, SceneFormatError, ValueError) as e:
        print(f"Error: Could not parse scene file: {args.scene}: {e}",
              file=sys.stderr)
        return 1
    if args.width or args.height:
        scene = scene.replace(width=args.width or scene.width,
                              height=args.height or scene.height)
    settings = RenderSettings(backend=args.backend)

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

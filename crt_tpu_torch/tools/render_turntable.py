"""Camera-animation tool: orbit the camera and render frames as PNGs.

Counterpart of crt_tpu's ``tools/render_turntable.py``: exercises the
camera-move API (``utils/camera_rig.CameraRig``'s ``pan_around``, the
reference's task-06 animation surface, crt_camera.h:26-56) end to end.
The frames are written by ``io/png.py``; each frame's render time (the
readback included) and PNG time (encode and write) are printed.

Usage:
    python -m crt_tpu_torch.tools.render_turntable [scene.crtscene]
        [outdir] [--frames N] [--device cpu|cuda]

Without a scene it renders ``make_test_scene(320, 180, num_quads=8)``;
``outdir`` defaults to ``turntable``, N to 12.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

import numpy as np


def orbit_rigs(scene, frames: int):
    """The camera rigs of the turntable: the scene's camera panned about
    the vertex centroid by 2 pi f / frames for f = 0 .. frames - 1."""
    from crt_tpu_torch.utils.camera_rig import CameraRig

    anchor = scene.vertices.detach().cpu().numpy().mean(axis=0)
    rig0 = CameraRig.from_scene(scene)
    return [rig0.pan_around(2.0 * math.pi * f / frames, anchor)
            for f in range(frames)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="render_turntable",
        description="orbit the camera and write the frames as PNGs")
    p.add_argument("paths", nargs="*", metavar="[scene.crtscene] [outdir]")
    p.add_argument("--frames", type=int, default=12)
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; cpu must be asked for)")
    args = p.parse_args(argv)

    from crt_tpu_torch import RenderSettings, load_scene, render_image
    from crt_tpu_torch.io.png import write_png
    from crt_tpu_torch.io.ppm import quantize
    from crt_tpu_torch.scene.procedural import make_test_scene
    from crt_tpu_torch.tools import resolve_device_arg

    device = resolve_device_arg(args.device)
    if device is None:
        return 2
    paths = list(args.paths)
    scene_path = paths.pop(0) if paths and paths[0].endswith(
        ".crtscene") else None
    outdir = paths[0] if paths else "turntable"

    if scene_path:
        scene = load_scene(scene_path, device=device)
    else:
        scene = make_test_scene(width=320, height=180, num_quads=8,
                                device=device)
    settings = RenderSettings()
    os.makedirs(outdir, exist_ok=True)

    for f, rig in enumerate(orbit_rigs(scene, args.frames)):
        start = time.perf_counter()
        img = render_image(rig.apply(scene), settings).cpu().numpy()
        rendered = time.perf_counter()
        write_png(quantize(img).astype(np.uint8),
                  os.path.join(outdir, f"frame_{f:03d}.png"))
        written = time.perf_counter()
        print(f"frame {f + 1}/{args.frames}: render "
              f"{(rendered - start) * 1e3:.3f} ms, png "
              f"{(written - rendered) * 1e3:.3f} ms", flush=True)
    print(f"wrote {args.frames} frames to {outdir}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())

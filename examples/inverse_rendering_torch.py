"""Inverse rendering demo on the PyTorch / CUDA port (crt_tpu_torch).

Render a target, perturb the scene (vertex positions, albedo colours and the
lights), and gradient-descend the parameters back with ``fit_scene`` by
differentiating through intersection attributes and shading.  Saves the
target / perturbed / recovered renders as PPM.

Usage:
    python examples/inverse_rendering_torch.py [outdir] [--steps N]
        [--scene path.crtscene] [--device cuda|cpu]

Runs on the card; without one it stops with an error unless ``--device cpu``
asks for the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch


def main(argv=None) -> int:
    from crt_tpu_torch import RenderSettings, fit_scene, load_scene, render_image
    from crt_tpu_torch.io.ppm import write_ppm
    from crt_tpu_torch.scene.procedural import make_test_scene
    from crt_tpu_torch.scene.types import resolve_device

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("outdir", nargs="?", default="inverse_demo")
    p.add_argument("--steps", type=int, default=120)
    p.add_argument("--scene", default=None, help="a .crtscene file")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; cpu must be asked for)")
    args = p.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 2
    os.makedirs(args.outdir, exist_ok=True)

    if args.scene:
        scene = load_scene(args.scene, device=device)
    else:
        scene = make_test_scene(width=192, height=128, num_quads=8,
                                with_reflective=False, seed=3, device=device)
    settings = RenderSettings()
    target = render_image(scene, settings)

    rng = np.random.default_rng(0)

    def noise(t, scale):
        return torch.from_numpy(
            rng.normal(scale=scale, size=tuple(t.shape)).astype(np.float32)
        ).to(device)

    perturbed = {
        "vertices": scene.vertices + noise(scene.vertices, 0.08),
        "tex_color_a": (scene.tex_color_a
                        + noise(scene.tex_color_a, 0.25)).clamp(0.02, 1.0),
        "light_intensity": scene.light_intensity * 0.6,
    }

    def save(name, img):
        write_ppm(img.detach().cpu().numpy(), os.path.join(args.outdir, name))

    save("target.ppm", target)
    save("perturbed.ppm", render_image(scene.replace(**perturbed), settings))

    params, losses = fit_scene(
        scene, target, params=perturbed, settings=settings,
        optimizer=lambda ps: torch.optim.Adam(ps, lr=5e-3), steps=args.steps,
        callback=lambda i, loss: (i % 20 == 0) and print(
            f"step {i}: loss {loss:.6f}", flush=True),
    )
    save("recovered.ppm", render_image(scene.replace(**params), settings))

    print(f"loss {losses[0]:.6f} -> {losses[-1]:.6f} "
          f"({losses[0] / max(losses[-1], 1e-12):.0f}x reduction); "
          f"renders in {args.outdir}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The gradient of the 1080p GI frame (chip_smoke.py's [gi] scene: K = 4,
depth 3) at default settings, without ``remat_shading``: its time, peak
memory and launches, by chunk size.

    python3 measure/gi_grad.py [--parent DIR]

value_and_grad of the image sum with respect to vertices, light
intensities and camera position, with the renderer's chunks (2 of
1,044,480 pixels, each shaded under a checkpoint and again in the
backward) and with ``chunk_pixels`` 524,288 and 262,144 (4 and 8 chunks),
in turns (default, 4, 8, 8, 4, default) after a warm-up; then the
``remat_shading`` gradient for comparison.  Every size's gradients are held to the
default's (rtol 1e-3 / atol 1e-4 of the group's largest entry).
``--parent DIR`` first runs the same plain gradient in a child process
run from DIR (another checkout, such as the tree before the chunks were
checkpointed), and prints its peak or the
out-of-memory error that ended it.

Needs one CUDA card.
"""

from __future__ import annotations

import argparse
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

SIZES = {"default": 0, "4 chunks": 1 << 19, "8 chunks": 1 << 18}

_CHILD = r"""
import sys, time, torch
import crt_tpu_torch
from crt_tpu_torch import RenderSettings, render_image
from crt_tpu_torch.scene.procedural import make_test_scene
scene = make_test_scene(1920, 1080, 64, gi_on=True, device="cuda")
params = {k: getattr(scene, k).detach().clone().requires_grad_(True)
          for k in ("vertices", "light_intensity", "cam_position")}
st = RenderSettings(diffuse_reflection_ray_count=4)
render_image(scene, st)  # builds and warms the kernels
torch.cuda.synchronize()
torch.cuda.reset_peak_memory_stats()
t0 = time.perf_counter()
try:
    render_image(scene.replace(**params), st).sum().backward()
    torch.cuda.synchronize()
    what = f"finished in {time.perf_counter() - t0:.3f} s"
except torch.cuda.OutOfMemoryError as e:
    what = "out of memory: " + str(e).splitlines()[0]
print(f"[gi-grad] parent ({crt_tpu_torch.__file__}), plain gradient: "
      f"{what}; peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", metavar="DIR")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gi_grad: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    device = torch.device("cuda", 0)
    cs.phase_device()
    cs.phase_build()
    if args.parent:
        # run from DIR: ``python -c`` puts the working directory first
        parent = os.path.abspath(args.parent)
        proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=parent,
                              env=dict(os.environ, PYTHONPATH=parent),
                              capture_output=True, text=True, timeout=600)
        print(proc.stdout.strip() or proc.stderr[-2000:])
    from crt_tpu_torch import RenderSettings, render_image
    from crt_tpu_torch.scene.procedural import make_test_scene

    scene = make_test_scene(**cs.GI, device=device)
    st = RenderSettings(diffuse_reflection_ray_count=cs.GI_RAYS)
    # warm-up: the first backward of a process takes seconds more
    cs.image_sum_grads(scene, st.replace(chunk_pixels=SIZES["8 chunks"]))
    grads = {}
    for name in ("default", "4 chunks", "8 chunks", "8 chunks", "4 chunks",
                 "default"):
        gst = st.replace(chunk_pixels=SIZES[name])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cs.reset_launches()
        g0 = time.perf_counter()
        _, g = cs.image_sum_grads(scene, gst)
        torch.cuda.synchronize()
        g_s = time.perf_counter() - g0
        peak = torch.cuda.max_memory_allocated() / 2**30
        n = cs.read_glass_launches()
        print(f"[gi-grad] {name}: value_and_grad {g_s:.3f} s, peak "
              f"{peak:.3f} GiB; launches K1 {n['closest_hit']}, K2 "
              f"{n['occlusion_w']}, K3 {n['segsum']}")
        for k, gk in g.items():
            cs.check(bool(torch.isfinite(gk).all())
                     and bool(gk.abs().max() > 0),
                     f"{name}: d/d{k} is not finite and non-zero")
        grads.setdefault(name, g)
    for name in ("4 chunks", "8 chunks"):
        cs.assert_grads_close(f"[gi-grad] {name} vs default", grads[name],
                              grads["default"], rtol=1e-3, atol_scale=1e-4)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    g0 = time.perf_counter()
    cs.image_sum_grads(scene, st.replace(remat_shading=True))
    torch.cuda.synchronize()
    print(f"[gi-grad] remat_shading: value_and_grad "
          f"{time.perf_counter() - g0:.3f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

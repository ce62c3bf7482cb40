"""Time the 1080p GI frame (chip_smoke.py's [gi] scene: K = 4, depth 3)
with the pool cut into chunks of two sizes, in turns.

    python3 measure/gi_chunks.py

The sizes: ``ITER_POOL_LANES / 64`` pixels (262,144: the budget over the
64 banks of the tree, 8 chunks) and the renderer's default,
``ITER_POOL_LANES / pool_width`` (the budget over the 16 banks the grow
schedule holds at once, 2 chunks), set through
``RenderSettings.chunk_pixels``.  In turns (by banks, by width, by width,
by banks) each size's forward frame (median wall and enqueue of 3 on the
host clock, peak memory), one profiled frame (device time, launches) and
value_and_grad of the image sum with ``remat_shading`` (wall, peak).  The
two sizes' images are held equal bit for bit.

Needs one CUDA card.
"""

from __future__ import annotations

import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("gi_chunks: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    device = torch.device("cuda", 0)
    cs.phase_device()
    cs.phase_build()
    from crt_tpu_torch import RenderSettings, render_image
    from crt_tpu_torch.ops.shade_iter import pool_width
    from crt_tpu_torch.renderer import ITER_POOL_LANES
    from crt_tpu_torch.scene.procedural import make_test_scene

    scene = make_test_scene(**cs.GI, device=device)
    st = RenderSettings(diffuse_reflection_ray_count=cs.GI_RAYS)
    sizes = {"by banks": ITER_POOL_LANES // 64,
             "by width": ITER_POOL_LANES // pool_width(scene, st)}
    images = {}
    for name in ("by banks", "by width", "by width", "by banks"):
        cst = st.replace(chunk_pixels=sizes[name])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        wall, enq = cs.host_ms(lambda: render_image(scene, cst), reps=3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        dev_ms, launches, by_tag = cs.profile_frame(
            lambda: render_image(scene, cst), tag="[gi-chunks]")
        images.setdefault(name, render_image(scene, cst))
        gst = cst.replace(remat_shading=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        g0 = time.perf_counter()
        cs.image_sum_grads(scene, gst)
        torch.cuda.synchronize()
        g_s = time.perf_counter() - g0
        g_peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"[gi-chunks] {name}, {sizes[name]} pixels a chunk: forward "
              f"{wall:.3f} ms (enqueue {enq:.3f}), peak {peak:.3f} GiB; "
              f"device {dev_ms:.3f} ms in {launches} launches (K1 "
              f"{by_tag['closest_hit']:.3f}, K2 {by_tag['occlusion_w']:.3f}); "
              f"value_and_grad (remat_shading) {g_s:.3f} s, peak "
              f"{g_peak:.3f} GiB")
    cs.check(torch.equal(images["by banks"], images["by width"]),
             "the two chunk sizes' GI images differ")
    print("[gi-chunks] the two sizes' images are equal bit for bit")
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

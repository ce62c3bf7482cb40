"""Render a .crtscene dict through the staged Blender add-on, alone.

    python -P blender_addon_child.py SCENE.json OUT_DIR DEVICE

Run from the directory the add-on's zip (``python -m
crt_tpu_torch.tools.stage_blender_addon``) was unpacked into, with
``PYTHONPATH`` holding exactly that directory and this one (for
``mock_bpy``): ``crt_tpu_torch`` is then importable only as the copy
vendored in the add-on.  Under ``mock_bpy``'s stand-in for ``bpy`` the
script registers the add-on, imports the scene dict into the mock
Blender, exports it from the depsgraph and renders it twice with the
add-on's engine on DEVICE (the first render builds the kernels from the
add-on's own sources).  It writes ``OUT_DIR/combined.npy`` (the second
render's Combined pass), ``OUT_DIR/exported.json`` (the exported dict)
and prints one JSON line: where the package and the kernel build came
from, build and frame times, the kernel launches of the second render,
the KD builder that ran, the PNG row filters' backend and the engine's
settings.

``run_staged_addon`` stages, unpacks and runs it (the tests and
``chip_smoke.py``'s ``[tools]``); ``bench_depsgraph`` is shared with
``chip_smoke.py``'s ``[blender]``.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time
import types
import zipfile

HERE = pathlib.Path(__file__).resolve().parent


def run_staged_addon(tmp, scene_dict, device):
    """Stage the add-on's zip, unpack it under the directory ``tmp`` and
    render ``scene_dict`` with it in a child process (this script) whose
    sys.path holds only the unpacked directory, this directory (mock_bpy)
    and site-packages.  Returns (the child's JSON line, the Combined pass,
    the exported dict)."""
    import numpy as np

    from crt_tpu_torch.tools import stage_blender_addon

    tmp = pathlib.Path(tmp)
    zip_path = tmp / "addon.zip"
    stage_blender_addon.main([str(zip_path)])
    unpacked = tmp / "unpacked"
    with zipfile.ZipFile(zip_path) as z:
        z.extractall(unpacked)
    (tmp / "scene.json").write_text(json.dumps(scene_dict))
    env = dict(os.environ, PYTHONPATH=f"{unpacked}{os.pathsep}{HERE}")
    proc = subprocess.run(
        [sys.executable, "-P", str(HERE / "blender_addon_child.py"),
         str(tmp / "scene.json"), str(tmp), device],
        cwd=unpacked, env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"the add-on's child process failed "
                           f"({proc.returncode}):\n{proc.stderr[-4000:]}")
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    rect = np.load(tmp / "combined.npy")
    exported = json.loads((tmp / "exported.json").read_text())
    return info, rect, exported


def bench_depsgraph(bpy, scene_bridge, d: dict):
    """Import the scene dict ``d`` into the mock Blender and return a
    depsgraph of every object, seen through the imported camera."""
    scene_bridge.import_scene_dict(d, collection=bpy.context.collection)
    for ob in bpy.data.objects:
        if ob.type == "LIGHT":  # the importer sets the energy only
            ob.data.crt.intensity = ob.data.energy
    img = d["settings"]["image_settings"]
    bscene = bpy.types.Scene()
    bscene.camera = bpy.context.scene.camera
    bscene.render = types.SimpleNamespace(
        resolution_x=img["width"], resolution_y=img["height"],
        resolution_percentage=100)
    bscene.world = types.SimpleNamespace(
        color=tuple(d["settings"]["background_color"]))
    return types.SimpleNamespace(scene=bscene, object_instances=[
        types.SimpleNamespace(object=ob, matrix_world=ob.matrix_world)
        for ob in bpy.data.objects])


def main(argv) -> int:
    scene_json, out_dir, device = argv
    if "crt_tpu_torch" in sys.modules:
        raise RuntimeError("crt_tpu_torch was imported before the add-on")
    import mock_bpy
    import numpy as np

    mods = mock_bpy._build_modules()
    sys.modules.update(mods)
    import crt_tpu_torch_renderer as addon

    addon.register()
    import crt_tpu_torch
    from crt_tpu_torch.frontend.blender import engine, scene_bridge
    from crt_tpu_torch.io import png
    from crt_tpu_torch.ops import cuda_lib
    from crt_tpu_torch.scene import accel, native_accel
    from crt_tpu_torch.utils import trace as tracing

    engine.DEVICE = device
    with open(scene_json) as f:
        d = json.load(f)
    dg = bench_depsgraph(mods["bpy"], scene_bridge, d)
    exported = scene_bridge.build_scene_dict(dg)

    start = time.perf_counter()
    engine.CRTTorchRenderEngine().render(dg)  # builds the kernels on cuda
    first_ms = (time.perf_counter() - start) * 1e3
    eng = engine.CRTTorchRenderEngine()
    with tracing.recording() as counted:
        start = time.perf_counter()
        eng.render(dg)
        frame_ms = (time.perf_counter() - start) * 1e3
    launches = {k: tracing.total(counted, "crt.launches." + k)
                for k in ("closest_hit", "occlusion_w", "segsum")}
    rect = np.asarray(eng.result.layers[0].passes["Combined"].rect)
    crt = dg.scene.crt
    settings = [crt.max_ray_depth, crt.diffuse_reflection_ray_count,
                crt.shadow_bias, crt.reflection_bias,
                crt.diffuse_reflection_bias, crt.refraction_bias]
    addon.unregister()

    build = None
    if device != "cpu":
        info = cuda_lib.load()[1]
        build = {"path": info.path, "seconds": info.seconds,
                 "cache_hit": info.cache_hit}
    native = (native_accel.library()._name
              if accel.last_builder == "native" else None)
    np.save(os.path.join(out_dir, "combined.npy"), rect)
    with open(os.path.join(out_dir, "exported.json"), "w") as f:
        json.dump(exported, f)
    print(json.dumps({
        "package": crt_tpu_torch.__file__, "addon": addon.__file__,
        "build": build, "first_render_ms": first_ms, "frame_ms": frame_ms,
        "launches": launches, "kd_builder": accel.last_builder,
        "native_library": native, "png_unfilter": png.unfilter_backend(),
        "settings": settings}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

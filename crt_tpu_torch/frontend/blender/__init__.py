"""Blender add-on: render with the crt_tpu_torch ray tracer on the card.

Counterpart of ``crt_tpu/frontend/blender/`` (the reference add-on's
engine, .crtscene bridge, properties, panels and operators), rendering
through the port's ``frontend/api.py``.  Install the zip that
``python -m crt_tpu_torch.tools.stage_blender_addon`` (``make
blender-zip-torch``) writes, with torch importable in Blender's Python, or
point Blender's scripts path at the repo.  In the zip, this directory
holds a vendored ``crt_tpu_torch/``, which ``register`` puts on
``sys.path``.

The engine registers as ``CRT_TORCH``; the operators (``crt.*``), the
``crt`` property groups and the panels keep crt_tpu's add-on's names, so
only one of the two add-ons is enabled at a time (the debug-ray replay
script of ``utils/debug.py`` calls ``bpy.ops.crt.debug_ray_add``).

Only importable inside Blender (requires ``bpy``).
"""

bl_info = {
    "name": "CRT Torch Renderer",
    "author": "crt_tpu",
    "version": (0, 1, 0),
    "blender": (4, 5, 0),
    "description": "CRT ray tracer on a CUDA card (PyTorch) render engine "
                   "+ .crtscene IO",
    "category": "Render",
}


def _vendored_on_path():
    """Put this directory on ``sys.path`` when it holds the vendored
    ``crt_tpu_torch/`` of the staged zip, so the imports below find it."""
    import os
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    if (os.path.isdir(os.path.join(here, "crt_tpu_torch"))
            and here not in sys.path):
        sys.path.insert(0, here)


def register():
    _vendored_on_path()
    from crt_tpu_torch.frontend.blender import engine, ops, properties, ui

    properties.register()
    engine.register()
    ui.register()
    ops.register()


def unregister():
    _vendored_on_path()
    from crt_tpu_torch.frontend.blender import engine, ops, properties, ui

    ops.unregister()
    ui.unregister()
    engine.unregister()
    properties.unregister()

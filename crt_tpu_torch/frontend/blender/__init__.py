"""Blender add-on: render with the crt_tpu_torch ray tracer on the card.

Counterpart of ``crt_tpu/frontend/blender/`` (the reference add-on's
engine, .crtscene bridge, properties, panels and operators), rendering
through the port's ``frontend/api.py``.  Install by zipping this directory
(with crt_tpu_torch importable) or pointing Blender's scripts path at the
repo.

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


def register():
    from crt_tpu_torch.frontend.blender import engine, ops, properties, ui

    properties.register()
    engine.register()
    ui.register()
    ops.register()


def unregister():
    from crt_tpu_torch.frontend.blender import engine, ops, properties, ui

    ops.unregister()
    ui.unregister()
    engine.unregister()
    properties.unregister()

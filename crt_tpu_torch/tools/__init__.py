"""The repository's entry points outside the renderer, on the port.

Counterparts of crt_tpu's ``tools/`` scripts, each under the same file
name and taking the same arguments, run as
``python -m crt_tpu_torch.tools.<name>``:

- ``golden_check``: render the golden-covered course scenes and report
  each one's pixel match against its golden PNG (``$CRT_REFERENCE``);
- ``render_all``: render them into PPM and PNG files and a README table;
- ``render_turntable``: orbit the camera and write the frames as PNGs;
- ``export_mesh_header``: a ``.crtscene``'s mesh as a C++ header;
- ``oracle_f64``: the float64 NumPy shading oracle for disputed pixels;
- ``stage_blender_addon``: the Blender add-on as an installable zip.

The tools that render take ``--device`` (default ``cuda``): without a
visible card they print an error and return 2 unless ``--device cpu``
asks for the CPU.
"""

from __future__ import annotations

import sys


def resolve_device_arg(name: str):
    """The torch device ``name`` names, or None after printing why it
    cannot be used (the card asked for and none visible)."""
    from crt_tpu_torch.scene.types import resolve_device

    try:
        return resolve_device(name)
    except RuntimeError as e:
        print(f"Error: {e}", file=sys.stderr)
        return None

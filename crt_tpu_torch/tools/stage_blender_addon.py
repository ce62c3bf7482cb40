"""Stage the port's Blender add-on as an installable zip.

Counterpart of crt_tpu's ``tools/stage_blender_addon.py`` (the
reference's Blender-extension staging target, its CMakeLists.txt:66-92).
The zip holds one directory, the add-on ``crt_tpu_torch_renderer/``:

- the add-on's ``__init__.py`` and ``blender_manifest.toml`` at its top
  level (the ``__init__`` imports its engine, operators, properties and
  panels from the vendored package, so no other copy of them goes in);
- ``crt_tpu_torch/`` vendored beside them: its ``.py`` files, the
  kernel sources ``csrc/*.cu`` / ``*.cuh`` and the host source
  ``io/png_unfilter.cpp``;
- ``native/crt_accel.cpp`` and ``native/crt_ppm.cpp``.

No build output goes in (no ``build/``, ``__pycache__`` or ``.so``).  The
layout keeps ``ops/cuda_lib.py``'s and ``scene/native_accel.py``'s
``parents[2]`` inside the unpacked add-on, so the first render builds
the kernels and the native helpers from the zip's own sources into
``<add-on>/build/crt_tpu_torch/``.  The add-on's ``__init__`` puts its
directory on ``sys.path`` to import the vendored package.  torch itself
must be importable in Blender's Python: the zip cannot carry it.

Usage:
    python -m crt_tpu_torch.tools.stage_blender_addon [out.zip]
"""

from __future__ import annotations

import pathlib
import sys
import zipfile

REPO = pathlib.Path(__file__).resolve().parents[2]
ADDON_ID = "crt_tpu_torch_renderer"
NATIVE_SOURCES = ("crt_accel.cpp", "crt_ppm.cpp")


def staged_files() -> list[tuple[pathlib.Path, str]]:
    """(source file, name in the zip) of every file the zip holds."""
    pkg = REPO / "crt_tpu_torch"
    addon = pkg / "frontend" / "blender"
    files = [(addon / n, f"{ADDON_ID}/{n}")
             for n in ("__init__.py", "blender_manifest.toml")]
    for f in sorted(pkg.rglob("*")):
        rel = f.relative_to(REPO)
        if "__pycache__" in rel.parts or not f.is_file():
            continue
        if f.suffix in (".py", ".cpp") or (f.parent == pkg / "csrc"
                                           and f.suffix in (".cu", ".cuh")):
            files.append((f, f"{ADDON_ID}/{rel.as_posix()}"))
    files += [(REPO / "native" / n, f"{ADDON_ID}/native/{n}")
              for n in NATIVE_SOURCES]
    return files


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    out = argv[0] if argv else str(REPO / "crt_tpu_torch_blender.zip")
    with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as z:
        for src, name in staged_files():
            z.write(src, name)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

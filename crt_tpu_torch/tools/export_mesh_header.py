"""Export .crtscene meshes as C++ source — dev-tooling parity.

Counterpart of crt_tpu's ``tools/export_mesh_header.py`` (the reference
ships a Blender helper that exports meshes as ``std::array<crt::Triangle,
N>`` C++ headers for embedding test geometry,
tools/blender_crt_tools_addon.py:97-143): read any .crtscene and emit a
self-contained header with the vertex / index data, the same text as
crt_tpu's tool, byte for byte.  A host-only tool: it loads the scene on
the CPU, without its KD tree, and takes no ``--device``.

Usage:
    python -m crt_tpu_torch.tools.export_mesh_header scene.crtscene
        out.h [name]
"""

from __future__ import annotations

import sys


def export_header(scene, name: str) -> str:
    v = scene.vertices.detach().cpu().numpy()
    t = scene.tri_vidx.detach().cpu().numpy()
    lines = [
        "// Generated by crt_tpu tools/export_mesh_header.py — do not edit.",
        "#pragma once",
        "#include <array>",
        "#include <cstdint>",
        "",
        f"namespace {name} {{",
        "",
        f"inline constexpr std::size_t kVertexCount = {len(v)};",
        f"inline constexpr std::size_t kTriangleCount = {len(t)};",
        "",
        "// x, y, z per vertex",
        f"inline constexpr std::array<float, {v.size}> kVertices = {{",
    ]
    for row in v:
        x, y, z = (repr(float(c)) for c in row)
        lines.append(f"    {x}f, {y}f, {z}f,")
    lines += [
        "};",
        "",
        "// v0, v1, v2 per triangle (CCW)",
        f"inline constexpr std::array<std::int32_t, {t.size}> kTriangles = {{",
    ]
    for row in t:
        lines.append(f"    {row[0]}, {row[1]}, {row[2]},")
    lines += ["};", "", f"}}  // namespace {name}", ""]
    return "\n".join(lines)


def main(argv=None) -> int:
    from crt_tpu_torch import load_scene

    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv:
        print(__doc__)
        return 1
    scene_path = argv[0]
    out = argv[1] if len(argv) > 1 else "mesh.h"
    name = argv[2] if len(argv) > 2 else "crt_mesh"
    scene = load_scene(scene_path, device="cpu", build_accel=False)
    with open(out, "w", encoding="utf-8") as f:
        f.write(export_header(scene, name))
    print(f"wrote {out}: {scene.num_vertices} vertices, "
          f"{scene.num_triangles} triangles")
    return 0


if __name__ == "__main__":
    sys.exit(main())

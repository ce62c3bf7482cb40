"""Branchless texture sampling for the wavefront.

Counterpart of ``crt_tpu/ops/texture.py`` for the albedo, edges and checker
textures:

  - albedo:  flat color
  - edges:   edge color when bary_u, bary_v or 1-u-v <= edge_width
  - checker: C-truncated u/size and v/size, color_B when (row+col) is odd

Bitmap textures are ROADMAP A9.

A colour table that requires grad is read through ``segsum.packed_gather``,
so its backward is the segment-sum kernel: a few textures own all the rays,
and the scatter-add of plain indexing serialises on them (seconds per
1080p frame on an H100).
"""

from __future__ import annotations

import torch

from crt_tpu_torch.ops.segsum import packed_gather
from crt_tpu_torch.scene.types import (
    TEXTURE_ALBEDO,
    TEXTURE_BITMAP,
    TEXTURE_CHECKER,
    TEXTURE_EDGES,
)


def _c_trunc(x: torch.Tensor) -> torch.Tensor:
    """float -> int with C++ truncation toward zero (static_cast<int>)."""
    return torch.trunc(x).to(torch.int32)


def _color_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for a [X, 3] colour table -> idx.shape + [3].  A table
    that requires grad is always read through the adapter."""
    if table.requires_grad and torch.is_grad_enabled():
        rows = packed_gather(table.T, idx.reshape(-1)).T
        return rows.reshape(idx.shape + (3,))
    return table[idx]


def sample_textures(scene, tex_idx, uv, bary_u, bary_v) -> torch.Tensor:
    """Sample per-ray albedo colors -> [R, 3].

    tex_idx: [R] i32 texture index; uv: [R, 3]; bary_u, bary_v: [R].
    Texture types absent from the scene cost nothing.
    """
    present = set(scene.texture_types_present)
    if TEXTURE_BITMAP in present:
        raise NotImplementedError(
            "bitmap textures are not ported yet (ROADMAP A9)"
        )
    safe_idx = torch.clamp(tex_idx, min=0).long()
    color_a = _color_rows(scene.tex_color_a, safe_idx)  # [R, 3]
    if present <= {TEXTURE_ALBEDO}:
        return color_a

    ttype = scene.tex_type[safe_idx]  # [R]
    color_b = _color_rows(scene.tex_color_b, safe_idx)
    scalar = scene.tex_scalar[safe_idx]
    u, v = uv[..., 0], uv[..., 1]

    # First matching condition wins (jnp.select order): apply in reverse.
    choices = []
    if TEXTURE_EDGES in present:
        on_edge = (
            (bary_u <= scalar)
            | (bary_v <= scalar)
            | ((1.0 - bary_u - bary_v) <= scalar)
        )
        choices.append((ttype == TEXTURE_EDGES,
                        torch.where(on_edge[..., None], color_a, color_b)))
    if TEXTURE_CHECKER in present:
        safe_scalar = torch.where(scalar != 0.0, scalar,
                                  torch.ones_like(scalar))
        row = _c_trunc(u / safe_scalar)
        col = _c_trunc(v / safe_scalar)
        odd = ((row + col) & 1).to(torch.bool)
        choices.append((ttype == TEXTURE_CHECKER,
                        torch.where(odd[..., None], color_b, color_a)))

    out = color_a
    for cond, color in reversed(choices):
        out = torch.where(cond[..., None], color, out)
    return out

"""Scene state carried across packages through NumPy.

``scene_from_numpy`` turns a crt_tpu ``Scene`` that the caller flattened to
NumPy (``{field: np.asarray(getattr(jax_scene, field))}`` plus the static
meta fields) into the port's ``Scene``, so both packages render the same
bits.  ``scene_to_numpy`` is its inverse.  ``params_from_numpy`` and
``params_to_numpy`` carry a trainable-parameter dict (or its gradients)
across the same way.  None of them imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from crt_tpu_torch.scene.types import (
    SCENE_META_FIELDS,
    SCENE_TENSOR_FIELDS,
    Scene,
    resolve_device,
)

# dtype each tensor field carries (the JAX package's dtypes).
_DTYPES = {
    "tri_vidx": np.int32,
    "tri_material": np.int32,
    "mat_type": np.int32,
    "mat_albedo_tex": np.int32,
    "mat_smooth": np.bool_,
    "mat_backface": np.bool_,
    "tex_type": np.int32,
    "tex_bitmap": np.int32,
    "bitmap_size": np.int32,
}


def scene_from_numpy(arrays: dict, meta: dict, device=None) -> Scene:
    """Build a port ``Scene`` from NumPy arrays and static metadata, on
    ``device`` (None: the card).

    ``arrays`` must hold every tensor field of ``Scene``; extra keys (such
    as the JAX package's ``accel``) are ignored.  ``meta`` may hold any of
    the static fields; missing ones keep their defaults.
    """
    missing = [f for f in SCENE_TENSOR_FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"scene_from_numpy: missing fields {missing}")
    device = resolve_device(device)
    tensors = {}
    for f in SCENE_TENSOR_FIELDS:
        a = np.array(arrays[f], dtype=_DTYPES.get(f, np.float32), order="C")
        tensors[f] = torch.from_numpy(a).to(device)
    kw = {k: meta[k] for k in SCENE_META_FIELDS if k in meta}
    if "texture_types_present" in kw:
        kw["texture_types_present"] = tuple(
            int(t) for t in kw["texture_types_present"]
        )
    return Scene(**tensors, **kw)


def scene_to_numpy(scene: Scene) -> tuple[dict, dict]:
    """(arrays, meta) of a port ``Scene`` — the inverse of scene_from_numpy."""
    arrays = {f: t.detach().cpu().numpy() for f, t in scene.tensors().items()}
    meta = {k: getattr(scene, k) for k in SCENE_META_FIELDS}
    return arrays, meta


def params_from_numpy(arrays: dict, device=None) -> dict:
    """Trainable parameters from NumPy: float32 leaf tensors on ``device``
    (None: the card) with ``requires_grad=True``, one per key."""
    device = resolve_device(device)
    return {
        k: torch.from_numpy(np.array(a, dtype=np.float32, order="C"))
        .to(device).requires_grad_(True)
        for k, a in arrays.items()
    }


def params_to_numpy(params: dict, grads: bool = False) -> dict:
    """The values of a parameter dict as NumPy arrays, or with ``grads``
    the gradients accumulated on them (a parameter without one raises)."""
    if not grads:
        return {k: p.detach().cpu().numpy() for k, p in params.items()}
    missing = [k for k, p in params.items() if p.grad is None]
    if missing:
        raise ValueError(f"params_to_numpy: no gradient on {missing}")
    return {k: p.grad.detach().cpu().numpy() for k, p in params.items()}

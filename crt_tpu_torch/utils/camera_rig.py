"""Camera animation API: the Transform / Camera move surface.

Counterpart of ``crt_tpu/utils/camera_rig.py`` (the reference's
crt_camera.h:26-56 -> crt_transform.h:20-56): dolly / truck / pedestal move
along local axes, pan / tilt / roll compose axis rotations, ``*_around``
orbit an anchor.

The reference's ``Matrix::operator*=`` accumulates into the aliased
destination (crt_matrix.h:45-54), which corrupts every composed rotation;
scene files are unaffected (they give matrices verbatim), but the move API
goes through it.  Rotations here compose correctly; ``buggy_compose=True``
reproduces the reference's accumulation bit for bit.

Every method is pure, (position [3], rotation [3, 3]) -> a new rig, with
the row-vector convention (world = local @ R), and differentiable, so a
camera path can be optimized through the renderer.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from crt_tpu_torch.ops import vecmath
from crt_tpu_torch.scene.types import resolve_device


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


class CameraRig(NamedTuple):
    position: torch.Tensor  # [3]
    rotation: torch.Tensor  # [3, 3] row-major, row-vector convention

    @classmethod
    def identity(cls, position=(0.0, 0.0, 0.0), device=None) -> "CameraRig":
        """A rig at ``position`` looking down -z, on ``device`` (None: the
        card)."""
        device = resolve_device(device)
        return cls(torch.as_tensor(position, dtype=torch.float32,
                                   device=device),
                   torch.eye(3, dtype=torch.float32, device=device))

    # -- translations (crt_transform.h:20-30) -------------------------------
    def translate_world(self, v) -> "CameraRig":
        return self._replace(position=self.position + _f32(v, self.position))

    def translate_local(self, v) -> "CameraRig":
        return self._replace(position=self.position + vecmath.rotate_rows(
            _f32(v, self.position), self.rotation))

    def dolly(self, distance) -> "CameraRig":
        return self.translate_local([0.0, 0.0, distance])

    def truck(self, distance) -> "CameraRig":
        return self.translate_local([distance, 0.0, 0.0])

    def pedestal(self, distance) -> "CameraRig":
        return self.translate_local([0.0, distance, 0.0])

    # -- rotations (crt_transform.h:32-56) -----------------------------------
    def _rotate(self, m, buggy_compose=False) -> "CameraRig":
        m = m.to(self.rotation.device)
        if buggy_compose:
            # The reference's *= quirk: ``data[i][j] += data[i][k] *
            # rhs[k][j]`` in place, so at k == j the read of data[i][k]
            # sees the partly accumulated data[i][j]: each step commits
            # before the next read.
            r = [[self.rotation[i, j] for j in range(3)] for i in range(3)]
            for i in range(3):
                for j in range(3):
                    for k in range(3):
                        r[i][j] = r[i][j] + r[i][k] * m[k, j]
            return self._replace(rotation=torch.stack(
                [torch.stack(row) for row in r]))
        return self._replace(rotation=vecmath.rotate_rows(self.rotation, m))

    def pan(self, angle, **kw) -> "CameraRig":
        return self._rotate(vecmath.rotation_y(angle), **kw)

    def tilt(self, angle, **kw) -> "CameraRig":
        return self._rotate(vecmath.rotation_x(angle), **kw)

    def roll(self, angle, **kw) -> "CameraRig":
        return self._rotate(vecmath.rotation_z(angle), **kw)

    def _rotate_around(self, m, anchor, **kw) -> "CameraRig":
        m = m.to(self.position.device)
        anchor = _f32(anchor, self.position)
        out = self._rotate(m, **kw)
        return out._replace(
            position=vecmath.rotate_rows(self.position - anchor, m) + anchor)

    def pan_around(self, angle, anchor, **kw) -> "CameraRig":
        return self._rotate_around(vecmath.rotation_y(angle), anchor, **kw)

    def tilt_around(self, angle, anchor, **kw) -> "CameraRig":
        return self._rotate_around(vecmath.rotation_x(angle), anchor, **kw)

    def roll_around(self, angle, anchor, **kw) -> "CameraRig":
        return self._rotate_around(vecmath.rotation_z(angle), anchor, **kw)

    def apply(self, scene):
        """The scene with this rig's camera."""
        return scene.replace(cam_position=self.position,
                             cam_rotation=self.rotation)

    @classmethod
    def from_scene(cls, scene) -> "CameraRig":
        return cls(scene.cam_position, scene.cam_rotation)

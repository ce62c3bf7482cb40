"""The one generator of the traffic mixes: what each unit of work gets,
made from ``--seed`` and the parameters of the mix's file.

A mix's file says what a unit is (``"unit": "frame"`` or ``"step"``) and
what varies from unit to unit:

  - ``gi``: the scene renders with diffuse GI, and frame k is progressive
    pass ``salt(seed, k)``;
  - ``jitter``: frame k turns the camera by the (k mod ``jitter_pattern``)-th
    of a pattern of sub-pixel offsets drawn from the seed, as an
    anti-aliasing accumulation cycles through its sample pattern (so the
    work of a window, and its peak memory, do not depend on how many
    frames it holds once it holds one whole pattern);
  - ``perturb``: a fit's target is rendered from the scene's parameters
    moved by uniform offsets of these sizes, drawn from the seed.

Every seed gives the same sizes and the same amount of work; only the
offsets and the salts differ.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def generator(seed: int, stream: int) -> torch.Generator:
    """A CPU generator for one use (``stream``) of one seed."""
    return torch.Generator().manual_seed((int(seed) * 1_000_003 + stream)
                                         % (1 << 63))


def gi_salt(seed: int, k: int) -> int:
    """The progressive pass of frame k: never 0 (the unsalted pass)."""
    return (int(seed) % (1 << 31)) + k + 1


def _rot_x(b):
    c, s = math.cos(b), math.sin(b)
    return np.array([[1, 0, 0], [0, c, s], [0, -s, c]])


def _rot_y(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])


def jitter_rotations(seed: int, cam_rotation, tan_half_fov: float,
                     height: int, n: int) -> np.ndarray:
    """[n, 3, 3] float32 camera matrices, each the scene's turned by up to
    half a pixel about the camera's x and y axes."""
    off = torch.rand((n, 2), generator=generator(seed, 1),
                     dtype=torch.float64).numpy() - 0.5
    pixel = 2.0 * tan_half_fov / height  # one pixel, in screen units
    base = np.asarray(cam_rotation, np.float64).reshape(3, 3)
    out = np.empty((n, 3, 3), np.float32)
    for k in range(n):
        out[k] = _rot_x(off[k, 1] * pixel) @ _rot_y(off[k, 0] * pixel) @ base
    return out


def sample_pixels(seed: int, width: int, height: int, n: int) -> np.ndarray:
    """``n`` distinct flat pixel indices y * width + x."""
    return torch.randperm(width * height,
                          generator=generator(seed, 2))[:n].numpy()


def checked_units(seed: int, done: int, n: int) -> list:
    """Which of ``done`` window units the check compares: the last one and
    ``n - 1`` more drawn from the seed."""
    if done <= n:
        return list(range(done))
    rest = torch.randperm(done - 1, generator=generator(seed, 3))[:n - 1]
    return sorted(rest.tolist()) + [done - 1]


def perturbation(seed: int, params: dict, sizes: dict) -> dict:
    """Uniform offsets in [-size, size] for each parameter named in
    ``sizes`` (float32 NumPy arrays shaped as ``params``)."""
    g = generator(seed, 4)
    out = {}
    for k, size in sizes.items():
        shape = tuple(np.asarray(params[k]).shape)
        u = torch.rand(shape, generator=g, dtype=torch.float64) * 2.0 - 1.0
        out[k] = (u * size).to(torch.float32).numpy()
    return out

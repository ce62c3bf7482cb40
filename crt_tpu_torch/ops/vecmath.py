"""Batched 3-vector math on ``[..., 3]`` tensors.

Counterpart of ``crt_tpu/ops/vecmath.py``.  Matrices are row-major 3x3
applied to ROW vectors (``v' = v @ M``), ``reflect(v, n) = v - 2 (v.n) n``.

Every reduction over the 3-axis is written out left to right,
``(x + y) + z``, so the port rounds the way the JAX reference and the CUDA
kernels (built without FMA contraction) do, and every square root goes
through ``sqrt``, which is correctly rounded on every device.
"""

from __future__ import annotations

import torch


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded fp32 square root.

    PyTorch's CPU fp32 sqrt (vectorized through MKL) is off by one ulp on
    ~0.7 % of inputs, which flips exact-t ties and breaks bit parity with
    the JAX reference.  The fp64 square root rounded to fp32 is the
    correctly rounded fp32 result (fp64 carries more than 2 * 24 + 2 bits).
    """
    return torch.sqrt(x.double()).to(x.dtype)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the trailing axis -> [...]."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3D cross product."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def length_squared(v: torch.Tensor) -> torch.Tensor:
    return dot(v, v)


def length(v: torch.Tensor) -> torch.Tensor:
    return sqrt(length_squared(v))


def safe_length(v: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """|v| with the radicand clamped at ``eps`` (finite gradient at 0)."""
    return sqrt(torch.clamp(length_squared(v), min=eps))


def normalize(v: torch.Tensor) -> torch.Tensor:
    """v / |v| with no epsilon."""
    return v / length(v)[..., None]


def safe_normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Normalize that returns 0 for (near-)zero vectors instead of NaN."""
    n2 = length_squared(v)
    inv = torch.where(
        n2 > eps, 1.0 / sqrt(torch.clamp(n2, min=eps)),
        torch.zeros_like(n2),
    )
    return v * inv[..., None]


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection of direction v about unit normal n."""
    return v - n * (2.0 * dot(v, n))[..., None]


def rotate_rows(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Row-vector times row-major matrix, ``v @ M``, written elementwise so
    it stays in full fp32 on every device (no TF32 matmul path).

    v: [..., 3], m: [3, 3] or a broadcastable batch [..., 3, 3].
    """
    if m.dim() == 2:
        return v[..., 0:1] * m[0] + v[..., 1:2] * m[1] + v[..., 2:3] * m[2]
    return (
        v[..., 0:1] * m[..., 0, :]
        + v[..., 1:2] * m[..., 1, :]
        + v[..., 2:3] * m[..., 2, :]
    )

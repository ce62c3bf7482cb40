"""Batched PCG32, bit for bit the sequence of ``crt_tpu/ops/rng.py``.

The reference seeds one ``crt::PCG32`` per pixel from its raster
coordinates and draws uniforms in order during diffuse-GI sampling
(crt_random.h:10-43, crt_renderer.cpp:68-71, :150).  crt_tpu carries the
64-bit state in 16-bit limbs because JAX has no uint64; torch's int64
carries it whole: a multiply or an add wraps modulo 2^64 as uint64 would,
and a right shift is arithmetic, so every right shift is masked to the
bits a logical shift keeps.  The state and the increment are int64
tensors holding the uint64 bits; draws are elementwise, on any device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from crt_tpu_torch.utils import trace as tracing

# PCG multiplier 6364136223846793005 (< 2^63, so an int64 constant)
_MUL = 0x5851F42D4C957F2D
_U32 = 0xFFFFFFFF


class PCGState(NamedTuple):
    """Batched PCG32 state: two int64 tensors of one shape holding the
    uint64 state and increment bits."""

    state: torch.Tensor
    inc: torch.Tensor


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of uint64 bits held in int64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _next(st: PCGState):
    """One PCG32 step -> (output in [0, 2^32) as int64, new state).  The
    output derives from the old state (crt_random.h:13-19)."""
    old = st.state
    new = old * _MUL + st.inc
    xorshifted = (_shr(_shr(old, 18) ^ old, 27)) & _U32
    rot = _shr(old, 59)
    out = ((xorshifted >> rot) | (xorshifted << ((-rot) & 31))) & _U32
    return out, PCGState(new, st.inc)


def _as_u32(x) -> torch.Tensor:
    """uint32 values (ints, or tensors of any integer or float type whose
    values are whole and in range) as int64."""
    return torch.as_tensor(x).to(torch.int64) & _U32


def _salt_on(salt, device) -> torch.Tensor:
    """``salt`` as uint32 values on ``device``.  A host value is copied
    there, which on the card waits for the stream: counted as
    ``crt.host_reads.rng_salt``."""
    if not (isinstance(salt, torch.Tensor) and salt.device == device):
        tracing.count("crt.host_reads.rng_salt")
    return _as_u32(salt).to(device)


def make_pcg(raster_x, raster_y) -> PCGState:
    """Per-pixel seeding (crt_random.h:30-43): seed = (x << 32) | y,
    state 0, inc = (seed << 1) | 1, a step, state += seed, a step."""
    x, y = _as_u32(raster_x), _as_u32(raster_y)
    seed = (x << 32) | y
    st = PCGState(torch.zeros_like(seed), (seed << 1) | 1)
    _, st = _next(st)
    _, st = _next(PCGState(st.state + seed, st.inc))
    return st


def uniform(state: PCGState, active=None):
    """U[0, 1) per lane (crt_random.h:21-27) -> (value f32, new state).

    ``active`` (bool tensor or None) gates the advancement per lane: a lane
    outside it keeps its state, so each pixel's draws follow the
    reference's depth-first order under wavefront masking."""
    out, new = _next(state)
    bits = (out >> 9) | 0x3F800000
    val = bits.to(torch.int32).view(torch.float32) - 1.0
    if active is not None:
        new = PCGState(torch.where(active, new.state, state.state), state.inc)
    return val, new


def derive(state: PCGState, salt) -> PCGState:
    """A decorrelated child stream: the increment's bits above bit 0 xored
    with ``salt`` << 1 (it stays odd), then one step.  The bank wavefront
    gives each GI child derive(parent, k + 1) and the Fresnel pair's
    reflection derive(parent, 97); ``salt`` is an int or an integer
    tensor (uint32 values)."""
    salt = _salt_on(salt, state.inc.device)
    _, st = _next(PCGState(state.state, state.inc ^ (salt << 1)))
    return st


def salt_stream(state: PCGState, salt) -> PCGState:
    """Per-pass stream salting for progressive accumulation: salt 0 (or
    None) returns ``state`` bit for bit, so the first pass is the
    single-shot render; salt k > 0 forks with ``derive``."""
    if salt is None:
        return state
    salt = _salt_on(salt, state.inc.device)
    forked = derive(state, salt)
    keep = salt == 0
    return PCGState(*(torch.where(keep, a, b)
                      for a, b in zip(state, forked)))

"""crt_tpu_torch.ops.segsum vs crt_tpu.ops.pallas_segsum.

The port runs on CPU tensors here, so ``segment_accumulate`` takes its
plain version (the CUDA kernel is held to it on the card, in
test_torch_cuda.py and chip_smoke.py).  The JAX side runs as
tests/test_segsum.py runs it: the Pallas kernel in interpret mode, the
exact-f32 one-hot product ``_segment_accumulate_xla``, and ``jax.grad``
through the adapters (the scatter branch, which is what the CPU takes).

Tolerances:
  - against the interpret-mode kernel rtol 1e-5 / atol 1e-4: the kernel
    splits each cotangent into two bf16 halves, which costs ~1e-6 relative
    per term (tests/test_segsum.py holds it to its own reference the same
    way);
  - against ``_segment_accumulate_xla`` and ``jax.grad`` rtol 1e-6 / atol
    1e-5: both sides are exact f32 sums that differ in summation order
    (sums of up to ~100 unit-normal terms);
  - adapter forwards are gathers: bit-equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from crt_tpu.ops import pallas_segsum as jps
from crt_tpu_torch.ops import segsum
from torch_port_fixtures import _one_torch_thread, _release_heap  # noqa: F401


@pytest.fixture
def interpret(monkeypatch):
    """Run the Pallas kernel in interpret mode on the CPU."""
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(jps, "_pallas_available", lambda: True)


def random_case():
    rng = np.random.default_rng(7)
    R, K, T = 3000, 9, 500
    tri = rng.integers(-1, T, size=R).astype(np.int32)
    g = rng.normal(size=(K, R)).astype(np.float32)
    return tri, g, T, rng.permutation(T).astype(np.int32)


def banded_case():
    """Each 1024-ray tile draws from a narrow id window; dead lanes."""
    rng = np.random.default_rng(11)
    R, K, T = 4096, 5, 700
    rank = rng.permutation(T).astype(np.int32)
    tri = np.empty(R, np.int32)
    for t0 in range(0, R, 1024):
        lo = rng.integers(0, T - 60)
        tri[t0:t0 + 1024] = rng.integers(lo, lo + 60, size=1024)
    tri[::97] = -1
    g = rng.normal(size=(K, R)).astype(np.float32)
    return tri, g, T, rank


def runs_case(seed, R, K, T, miss):
    """Ids in runs of 1 to 80 rays (as consecutive pixels hit one
    triangle), a share ``miss`` of the runs -1."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 80, size=R)
    ids = rng.integers(0, T, size=R)
    ids[rng.random(R) < miss] = -1
    tri = np.repeat(ids, lens)[:R].astype(np.int32)
    g = rng.normal(size=(K, R)).astype(np.float32)
    return tri, g, T, rng.permutation(T).astype(np.int32)


CASES = {
    "random": random_case,
    "banded": banded_case,
    # the texture colours of a fit_scene step: K = 3, every ray on one of
    # 3 segments; R = 1 (mod 4), as K3's rows past the first then are not
    # 16-byte aligned
    "texture_k3": lambda: runs_case(17, 301, 3, 3, 0.0),
    # packed rows (K = 22) at R = 2 (mod 4), the ior row (K = 1) at 3
    "rows_k22": lambda: runs_case(19, 2050, 22, 66, 0.3),
    "ior_k1": lambda: runs_case(23, 1027, 1, 5, 0.5),
}


def fp64_reference(tri, g, T):
    out = np.zeros((g.shape[0], T), np.float64)
    live = (tri >= 0) & (tri < T)
    np.add.at(out.T, tri[live], g.T[live].astype(np.float64))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_interpret_kernel(case, interpret):
    tri, g, T, _ = CASES[case]()
    ref = np.asarray(jps.segment_accumulate_matmul(
        jnp.asarray(tri), jnp.asarray(g), T))
    out = segsum.segment_accumulate_plain(
        torch.from_numpy(tri), torch.from_numpy(g), T)
    assert out.shape == (g.shape[0], T) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-4)
    wrapped = segsum.segment_accumulate(
        torch.from_numpy(tri), torch.from_numpy(g), T)
    assert torch.equal(wrapped, out)  # CPU tensors take the plain version


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_exact_f32_and_fp64(case):
    tri, g, T, _ = CASES[case]()
    ref = np.asarray(jps._segment_accumulate_xla(
        jnp.asarray(tri), jnp.asarray(g), T))
    out = segsum.segment_accumulate_plain(
        torch.from_numpy(tri), torch.from_numpy(g), T).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(out, fp64_reference(tri, g, T), rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_banded_matches_interpret_kernel(case, interpret):
    tri, g, T, rank = CASES[case]()
    ref = np.asarray(jps.segment_accumulate_banded(
        jnp.asarray(tri), jnp.asarray(g), T, jnp.asarray(rank)))
    out = segsum.segment_accumulate_banded(
        torch.from_numpy(tri), torch.from_numpy(g), T,
        torch.from_numpy(rank)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-4)
    # original ids: the rank remap changes nothing but the order
    np.testing.assert_allclose(out, fp64_reference(tri, g, T), rtol=1e-6,
                               atol=1e-5)


def test_skipped_ids_and_empty_inputs():
    g = torch.arange(12, dtype=torch.float32).reshape(2, 6)
    ids = torch.tensor([0, -1, 2, 3, 7, 2], dtype=torch.int32)  # T = 3
    out = segsum.segment_accumulate(ids, g, 3)
    assert out.tolist() == [[0.0, 0.0, 7.0], [6.0, 0.0, 19.0]]
    none = torch.full((6,), -1, dtype=torch.int32)
    assert not segsum.segment_accumulate(none, g, 3).any()
    assert segsum.segment_accumulate(ids[:0], g[:, :0], 3).shape == (2, 3)
    assert segsum.segment_accumulate(ids, g, 0).shape == (2, 0)
    assert segsum.segsum_launches == 0  # the plain version does not count


@pytest.mark.parametrize("fault", ["dtype", "ids_dtype", "layout", "shape",
                                   "segments"])
def test_wrapper_rejects(fault):
    g = torch.zeros((4, 64), dtype=torch.float32)
    ids = torch.zeros((64,), dtype=torch.int32)
    T = 8
    if fault == "dtype":
        g = g.double()
    elif fault == "ids_dtype":
        ids = ids.long()
    elif fault == "layout":
        g = torch.zeros((64, 4), dtype=torch.float32).T
    elif fault == "shape":
        ids = ids[:63]
    else:
        T = -1
    with pytest.raises(ValueError):
        segsum.segment_accumulate(ids, g, T)


def adapter_inputs(with_miss):
    rng = np.random.default_rng(3)
    K, T, R = 6, 40, 200
    packed = rng.normal(size=(K, T)).astype(np.float32)
    tri = rng.integers(0, T, size=R).astype(np.int32)
    if with_miss:
        tri[::7] = -1
    rank = rng.permutation(T).astype(np.int32)
    w = rng.normal(size=(K, R)).astype(np.float32)
    return packed, tri, rank, w


def torch_grad(fn, packed, w):
    p = torch.from_numpy(packed).requires_grad_(True)
    rows = fn(p)
    (rows * torch.from_numpy(w)).sum().backward()
    return rows.detach().numpy(), p.grad.numpy()


def jax_grad(fn, packed, w):
    rows = fn(jnp.asarray(packed))
    grad = jax.grad(lambda p: jnp.sum(fn(p) * jnp.asarray(w)))(
        jnp.asarray(packed))
    return np.asarray(rows), np.asarray(grad)


def test_packed_gather_matches_jax():
    packed, tri, _, w = adapter_inputs(with_miss=False)
    rows, grad = torch_grad(
        lambda p: segsum.packed_gather(p, torch.from_numpy(tri)), packed, w)
    jrows, jgrad = jax_grad(
        lambda p: jps.packed_gather(p, jnp.asarray(tri)), packed, w)
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_allclose(grad, jgrad, rtol=1e-6, atol=1e-5)


def test_packed_gather_ranked_matches_jax():
    """Miss lanes read triangle 0's row forward and are dropped backward.
    The JAX scatter branch does not drop them (index -1 wraps to the last
    column), so the comparison zeroes their cotangents, as the renderer's
    masks do."""
    packed, tri, rank, w = adapter_inputs(with_miss=True)
    w = np.where(tri[None] >= 0, w, np.float32(0))
    rows, grad = torch_grad(
        lambda p: segsum.packed_gather_ranked(
            p, torch.from_numpy(tri), torch.from_numpy(rank)), packed, w)
    jrows, jgrad = jax_grad(
        lambda p: jps.packed_gather_ranked(
            p, jnp.asarray(tri), jnp.asarray(rank)), packed, w)
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_allclose(grad, jgrad, rtol=1e-6, atol=1e-5)


def test_packed_rows_from_kernel_matches_jax():
    """Emitted rows go through untouched; cotangents land in ``packed`` by
    rank, miss lanes (rank -1) dropped even with a non-zero cotangent."""
    packed, tri, rank, w = adapter_inputs(with_miss=True)
    data = np.where(tri[None] >= 0, packed[:, np.maximum(tri, 0)],
                    np.float32(0))
    ranked = np.where(tri >= 0, rank[np.maximum(tri, 0)], -1).astype(np.int32)
    rows, grad = torch_grad(
        lambda p: segsum.packed_rows_from_kernel(
            p, torch.from_numpy(data), torch.from_numpy(ranked),
            torch.from_numpy(rank)), packed, w)
    jrows, jgrad = jax_grad(
        lambda p: jps.packed_rows_from_kernel(
            p, jnp.asarray(data), jnp.asarray(ranked), jnp.asarray(rank)),
        packed, w)
    np.testing.assert_array_equal(rows, data)
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_allclose(grad, jgrad, rtol=1e-6, atol=1e-5)
    live = tri >= 0
    want = np.zeros_like(packed, dtype=np.float64)
    np.add.at(want.T, tri[live], w.T[live].astype(np.float64))
    np.testing.assert_allclose(grad, want, rtol=1e-6, atol=1e-5)


def test_adapter_takes_strided_cotangent_and_skips_unneeded_grad():
    packed, tri, rank, w = adapter_inputs(with_miss=False)
    p = torch.from_numpy(packed).requires_grad_(True)
    rows = segsum.packed_gather_ranked(p, torch.from_numpy(tri),
                                       torch.from_numpy(rank))
    # a transposed consumer hands the backward a non-contiguous gradient
    (rows.T * torch.from_numpy(w).T.contiguous()).sum().backward()
    want = np.zeros_like(packed, dtype=np.float64)
    np.add.at(want.T, tri, w.T.astype(np.float64))
    np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-6, atol=1e-5)

    frozen = torch.from_numpy(packed)
    data = torch.from_numpy(packed[:, tri]).requires_grad_(True)
    out = segsum.packed_rows_from_kernel(
        frozen, data, torch.from_numpy(rank[tri]), torch.from_numpy(rank))
    assert torch.equal(out, data)

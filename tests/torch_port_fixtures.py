"""Fixtures shared by the crt_tpu_torch parity tests (test_torch_*.py).

A test file takes them with

    from torch_port_fixtures import _one_torch_thread, _release_heap  # noqa: F401

and pytest applies both (they are autouse) to every test of that file.
"""

import ctypes

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs one worker per core, and torch's
    default (a thread per core in every worker) oversubscribes the host.
    Around the module JAX's compilation caches are dropped: a worker that
    has run crt_tpu's own test files holds GBs of executables that nothing
    will call again, beside tests that need tens of GB for a moment."""
    import jax

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    jax.clear_caches()
    _trim_heap()
    yield
    torch.set_num_threads(n)
    jax.clear_caches()
    _trim_heap()


def _trim_heap():
    """Hand the freed heap back to the system (glibc keeps it otherwise)."""
    trim = getattr(ctypes.CDLL(None), "malloc_trim", None)  # glibc only
    if trim is not None:
        trim(0)


@pytest.fixture(autouse=True)
def _release_heap():
    yield
    _trim_heap()

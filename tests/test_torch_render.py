"""crt_tpu_torch end to end: the slice image vs crt_tpu.render_image.

The port renders on CPU tensors, so the cluster backend walks the same
binning, emitted rows and w-occlusion code the card runs, with the plain
versions of the two kernels.  Reference images come from crt_tpu through
its Pallas backend in interpret mode (patched in as test_pallas_trace.py
does) and through its bruteforce backend.

Tolerance: rtol 1e-5, atol 1e-6 — test_pallas_trace.py's own tolerance for
the Pallas-vs-bruteforce image.  The JAX renders are jitted, and XLA's CPU
JIT contracts multiply-adds into FMAs, so shading values differ from the
port's (FMA-free) ones in the last bits.
"""

import numpy as np
import pytest
import torch

import crt_tpu
import crt_tpu.ops.pallas_trace as jpt
import crt_tpu.renderer as jrenderer
from crt_tpu.scene.procedural import make_test_scene as jmake_test_scene
from crt_tpu_torch import RenderSettings, render_image
from crt_tpu_torch.scene.procedural import make_test_scene


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs one worker per core, and torch's
    default (a thread per core in every worker) oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SCENES = {
    "default": dict(),
    "with_edges": dict(with_edges=True),
}


def jax_render(scene, settings):
    """crt_tpu.render_image with backend="pallas" in interpret mode."""
    if settings.backend != "pallas":
        return np.asarray(crt_tpu.render_image(scene, settings))
    orig = jrenderer.make_trace_fn

    def patched(scn, st):
        if st.backend == "pallas":
            return jpt.make_pallas_trace_fn(scn, interpret=True)
        return orig(scn, st)

    jrenderer.make_trace_fn = patched
    try:
        return np.asarray(crt_tpu.render_image(scene, settings))
    finally:
        jrenderer.make_trace_fn = orig


@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("jax_backend", ["pallas", "bruteforce"])
def test_slice_image_matches_crt_tpu(name, jax_backend):
    kw = SCENES[name]
    ref = jax_render(jmake_test_scene(**kw),
                     crt_tpu.RenderSettings(backend=jax_backend))
    img = render_image(make_test_scene(**kw, device="cpu"))
    assert img.shape == (36, 64, 3) and img.dtype == torch.float32
    np.testing.assert_allclose(img.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("backend", ["auto", "bruteforce"])
def test_head_compat_matches_crt_tpu(backend):
    ref = jax_render(jmake_test_scene(),
                     crt_tpu.RenderSettings(backend="bruteforce",
                                            head_compat=True))
    img = render_image(make_test_scene(device="cpu"),
                       RenderSettings(backend=backend, head_compat=True))
    np.testing.assert_allclose(img.numpy(), ref, rtol=1e-5, atol=1e-6)

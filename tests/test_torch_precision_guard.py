"""Guard: the port's render graph is fp32 only.

Counterpart of tests/test_precision_guard.py, which walks crt_tpu's
jaxprs for dots at the TPU's default (bf16) precision.  On the card the
same bug class is a TF32 or half-precision matrix product: TF32 keeps
~10 mantissa bits.  The port's one matrix product is
``ops/intersect._fp32_matmul`` (the all-pairs test), which runs in IEEE
fp32 whatever the caller's TF32 setting is.  Each case records the aten
ops of a render, a gradient or a sharded step under a
``TorchDispatchMode`` and fails on any matrix product (mm, bmm, addmm,
baddbmm, matmul, linear, convolution, _scaled_mm and their kin) outside
``_fp32_matmul``, on any product there that is not fp32, and on any bf16
or f16 tensor anywhere.

The sharded cases run in one gloo rank spawned through
tests/test_torch_parallel.py's harness, with this file as the rank's
script (``python tests/test_torch_precision_guard.py CASES 0 1 DIR cpu``).
"""

import contextlib
import os
import sys

import pytest
import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode

from test_torch_parallel import _rank_main, launch_ranks
from torch_port_fixtures import _one_torch_thread, _release_heap  # noqa: F401

MATRIX_PRODUCTS = frozenset({
    "mm", "bmm", "addmm", "addbmm", "baddbmm", "addmv", "mv", "dot", "vdot",
    "matmul", "linear", "convolution", "_convolution", "_scaled_mm",
    "_int_mm", "_addmm_activation",
})
LOW_PRECISION = (torch.bfloat16, torch.float16)


class OpRecorder(TorchDispatchMode):
    """Records every aten op: the matrix products (with whether they ran
    inside ``_fp32_matmul`` and their dtypes) and the ops that touch a
    bf16 / f16 tensor."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.inside = 0  # depth of intersect._fp32_matmul calls
        self.products = []  # (op, inside _fp32_matmul, dtypes)
        self.low = []  # ops with a bf16 / f16 tensor

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        dtypes = sorted({str(t.dtype) for t in tree_leaves((args, kwargs, out))
                         if isinstance(t, torch.Tensor)})
        self.ops += 1
        if name in MATRIX_PRODUCTS:
            self.products.append((name, self.inside > 0, dtypes))
        if any(str(d) in dtypes for d in LOW_PRECISION):
            self.low.append(name)
        return out

    def report(self) -> dict:
        bad = [p for p in self.products
               if not p[1] or p[2] != ["torch.float32"]]
        return {"ops": self.ops, "bad_products": bad, "low": self.low,
                "fp32_products": sum(1 for p in self.products if p[1])}


@contextlib.contextmanager
def recording():
    """An ``OpRecorder`` over the block, with ``intersect._fp32_matmul``
    wrapped to mark the products it makes."""
    from crt_tpu_torch.ops import intersect

    rec = OpRecorder()
    real = intersect._fp32_matmul

    def marked(a, b):
        rec.inside += 1
        try:
            return real(a, b)
        finally:
            rec.inside -= 1

    intersect._fp32_matmul = marked
    try:
        with rec:
            yield rec
    finally:
        intersect._fp32_matmul = real


def _scene(**kw):
    from crt_tpu_torch.scene.procedural import make_test_scene

    return make_test_scene(**kw, device="cpu")


def _bruteforce(**kw):
    from crt_tpu_torch import RenderSettings

    return RenderSettings(backend="bruteforce", **kw)


def _assert_fp32_only(report, products=True):
    """No product outside ``_fp32_matmul``, none there but fp32, no half
    tensor; ``products``: the graph holds ``_fp32_matmul``'s (the guard
    saw the all-pairs test), else none at all."""
    assert report["ops"] > 100, report
    assert not report["bad_products"], (
        f"{len(report['bad_products'])} matrix products outside "
        "intersect._fp32_matmul or not in fp32 (on the card a TF32 or half "
        f"product): {report['bad_products'][:5]}")
    assert not report["low"], f"bf16 / f16 tensors in: {report['low'][:5]}"
    assert (report["fp32_products"] > 0) == products, report


# ---------------------------------------------------------------------------
# The sharded cases' rank side (one gloo rank)
# ---------------------------------------------------------------------------

def _case_rows(device):
    from crt_tpu_torch.parallel.sharded import make_mesh, render_image_sharded

    scene = _scene(width=32, height=16, num_quads=3, with_reflective=True)
    mesh = make_mesh()
    with recording() as rec:
        render_image_sharded(scene, _bruteforce(), mesh=mesh)
    return rec.report()


def _case_scene(device):
    from crt_tpu_torch import RenderSettings
    from crt_tpu_torch.parallel.scene_sharded import (
        render_image_scene_sharded,
    )
    from crt_tpu_torch.parallel.sharded import make_mesh

    scene = _scene(width=32, height=16, num_quads=4)
    mesh = make_mesh((1, 1), ("rays", "scene"))
    with recording() as rec:
        render_image_scene_sharded(scene, RenderSettings(max_ray_depth=1),
                                   mesh)
    return rec.report()


def _case_grad(device):
    from crt_tpu_torch.parallel.sharded import (
        default_trainable_params,
        inverse_render_step,
        make_mesh,
    )

    scene = _scene(width=32, height=16, num_quads=3)
    mesh = make_mesh()
    params = default_trainable_params(scene)
    with recording() as rec:
        inverse_render_step(scene, torch.zeros(16, 32, 3), params,
                            settings=_bruteforce(), mesh=mesh)
    return rec.report()


RANK_CASES = {"rows": _case_rows, "scene": _case_scene, "grad": _case_grad}


@pytest.fixture(scope="module")
def rank_reports(tmp_path_factory):
    (rank0,) = launch_ranks(tmp_path_factory.mktemp("guard"),
                            list(RANK_CASES), 1, script=__file__)
    return rank0


# ---------------------------------------------------------------------------
# The six cases
# ---------------------------------------------------------------------------

def test_render_graph_has_only_fp32_products():
    from crt_tpu_torch import RenderSettings, render_image

    scene = _scene(width=32, height=32, num_quads=6, with_reflective=True,
                   with_refractive=True)
    with recording() as rec:
        render_image(scene, _bruteforce())
    _assert_fp32_only(rec.report())
    with recording() as rec:  # the default backend: no product at all
        render_image(scene, RenderSettings())
    _assert_fp32_only(rec.report(), products=False)


def test_gi_iter_graph_has_only_fp32_products():
    from crt_tpu_torch import render_image

    scene = _scene(width=32, height=16, num_quads=3, gi_on=True)
    with recording() as rec:
        render_image(scene, _bruteforce(wavefront="iter",
                                        diffuse_reflection_ray_count=2,
                                        max_ray_depth=2))
    _assert_fp32_only(rec.report())


def test_grad_graph_has_only_fp32_products():
    """The forward and the backward: the all-pairs product is made on
    detached inputs, so the backward holds no product at all."""
    from crt_tpu_torch import render_image

    scene = _scene(width=24, height=16, num_quads=3)
    v = scene.vertices.clone().requires_grad_(True)
    with recording() as rec:
        render_image(scene.replace(vertices=v), _bruteforce()).sum().backward()
    assert v.grad is not None and bool(v.grad.abs().sum() > 0)
    _assert_fp32_only(rec.report())


def test_sharded_graph_has_only_fp32_products(rank_reports):
    """The row-sharded render (parallel/sharded.py), on a gloo rank."""
    _assert_fp32_only(rank_reports["rows"])


def test_scene_sharded_graph_has_only_fp32_products(rank_reports):
    """The partitioned-scene render (parallel/scene_sharded.py): cluster
    traces, no product."""
    _assert_fp32_only(rank_reports["scene"], products=False)


def test_grad_sharded_graph_has_only_fp32_products(rank_reports):
    """inverse_render_step (the all-reduced gradient) stays fp32 too."""
    _assert_fp32_only(rank_reports["grad"])


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    _rank_main(sys.argv[1].split(","), int(sys.argv[2]), int(sys.argv[3]),
               sys.argv[4], sys.argv[5], table=RANK_CASES)

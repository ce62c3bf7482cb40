"""The KD builder of crt_tpu_torch (``scene/accel.py``, the native builder
in ``scene/native_accel.py``) vs crt_tpu's.

Tolerance: EXACT.  Every array of the tree (node boxes, children, leaf
ids, the padded leaf rows, leaf owners) and every meta value (leaf_size,
num_nodes, num_leaves) equals crt_tpu's NumPy builder's, on the test
scene, the glass scene, a 4,096-triangle seeded soup, the three explicit
cases of tests/test_accel_semantics.py and a chain deeper than 39 levels;
the native builder equals the NumPy one.
"""

import hashlib
import pathlib

import numpy as np
import pytest
import torch

from crt_tpu.scene import accel as jaccel
from crt_tpu.scene.procedural import make_big_scene as jmake_big_scene
from crt_tpu.scene.procedural import make_test_scene as jmake_test_scene
from crt_tpu_torch.scene import accel, native_accel
from crt_tpu_torch.scene.convert import (
    accel_to_numpy,
    scene_from_numpy,
    scene_to_numpy,
)
from crt_tpu_torch.scene.json_loader import scene_from_dict
from crt_tpu_torch.scene.procedural import make_big_scene, make_test_scene_dict
from crt_tpu_torch.scene.types import (
    ACCEL_META_FIELDS,
    ACCEL_TENSOR_FIELDS,
    MAX_ACCELERATION_TREE_DEPTH,
    MAX_BOX_TRIANGLE_COUNT,
    SCENE_META_FIELDS,
    SCENE_TENSOR_FIELDS,
)
from test_accel_semantics import tri_soup
from torch_port_fixtures import _one_torch_thread, _release_heap  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
SO = ROOT / "native" / "libcrt_accel.so"


def _semantics_cases():
    """The soups of tests/test_accel_semantics.py."""
    single = [np.array([[i, 0, 0], [i + 0.5, 0, 0], [i, 0.5, 0]])
              for i in range(MAX_BOX_TRIANGLE_COUNT)]
    straddle = [np.array([[i, 0, 0], [i + 0.4, 0, 0], [i, 0.4, 0]])
                for i in range(17)]
    rng = np.random.default_rng(0)
    centers = rng.uniform(-5, 5, (40, 1, 3))
    alternate = [c + rng.uniform(-0.2, 0.2, (3, 3)) for c in centers]
    return {"single_leaf": tri_soup(single), "straddle": tri_soup(straddle),
            "axes": tri_soup(alternate)}


def deep_chain():
    """21 degenerate triangles at one point and one triangle whose box is
    the root box: every split keeps the point's 21 (the big one straddles)
    on one side, so the chain passes MAX_ACCELERATION_TREE_DEPTH and its
    last leaf holds 21 > 16 triangles."""
    point = np.full((3, 3), 0.3)
    big = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 1]])
    return tri_soup([point] * 20 + [big])


def _soups():
    cases = {}
    for name, kw in (("test", {}), ("glass", dict(with_refractive=True))):
        s = jmake_test_scene(96, 64, num_quads=16, **kw)
        cases[name] = (np.asarray(s.vertices), np.asarray(s.tri_vidx))
    s = jmake_big_scene(4096, 64, 32, build_accel=False)
    cases["soup4096"] = (np.asarray(s.vertices), np.asarray(s.tri_vidx))
    cases.update(_semantics_cases())
    cases["deep"] = deep_chain()
    return cases


SOUPS = _soups()


def assert_tree_equal(got, want):
    for f in ACCEL_TENSOR_FIELDS:
        a = getattr(got, f)
        b = np.asarray(getattr(want, f))
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ACCEL_META_FIELDS:
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("name", sorted(SOUPS))
@pytest.mark.parametrize("use_native", [True, False])
def test_build_matches_crt_tpu(name, use_native):
    verts, idx = SOUPS[name]
    want = jaccel.build_accel_tree(verts, idx, use_native=False)
    got = accel.build_accel_tree(verts, idx, use_native=use_native,
                                 device="cpu")
    assert accel.last_builder == ("native" if use_native else "numpy")
    assert got.node_min.device.type == "cpu"
    assert_tree_equal(got, want)


def test_deep_leaf_exceeds_the_box_count():
    """A leaf past depth 39 keeps every triangle, and every leaf row is
    padded to the longest."""
    verts, idx = deep_chain()
    tree = accel.build_accel_tree(verts, idx, device="cpu")
    assert tree.leaf_size == 21 > MAX_BOX_TRIANGLE_COUNT
    rows = tree.leaf_tris.numpy()
    assert rows.shape == (tree.num_leaves, 21)
    assert ((rows >= 0).sum(1) == 21).any()
    children = tree.node_children.numpy()
    depth = np.zeros(tree.num_nodes, int)
    for node in range(tree.num_nodes):  # children follow their parent
        for c in children[node]:
            if c >= 0:
                depth[c] = depth[node] + 1
    assert depth.max() == MAX_ACCELERATION_TREE_DEPTH + 1
    deepest = tree.node_leaf_id.numpy()[depth == depth.max()]
    assert ((rows[deepest] >= 0).sum(1) == 21).any()


def test_native_falls_back_to_numpy(monkeypatch):
    verts, idx = SOUPS["soup4096"]
    native = accel.build_accel_tree(verts, idx, device="cpu")
    assert accel.last_builder == "native"

    def broken():
        raise OSError("no library")

    monkeypatch.setattr(native_accel, "library", broken)
    fallback = accel.build_accel_tree(verts, idx, device="cpu")
    assert accel.last_builder == "numpy"
    assert_tree_equal(fallback, native)


def test_native_library_builds_under_build_and_leaves_native_alone():
    before = (hashlib.sha256(SO.read_bytes()).hexdigest(),
              SO.stat().st_mtime_ns)
    path = pathlib.Path(native_accel.build())
    assert path.exists()
    assert path.parent.parent == native_accel.BUILD_ROOT
    assert ROOT / "build" in path.parents
    assert native_accel.library().crt_accel_build is not None
    assert (hashlib.sha256(SO.read_bytes()).hexdigest(),
            SO.stat().st_mtime_ns) == before


def test_scene_from_numpy_carries_crt_tpu_tree():
    jscene = jmake_test_scene(96, 64, num_quads=16, with_edges=True)
    arrays = {f: np.asarray(getattr(jscene, f)) for f in SCENE_TENSOR_FIELDS}
    arrays["accel"] = {f: np.asarray(getattr(jscene.accel, f))
                       for f in ACCEL_TENSOR_FIELDS + ACCEL_META_FIELDS}
    meta = {f: getattr(jscene, f) for f in SCENE_META_FIELDS}
    tscene = scene_from_numpy(arrays, meta, device="cpu")
    assert_tree_equal(tscene.accel, jscene.accel)
    arrays2, _ = scene_to_numpy(tscene)
    assert_tree_equal(accel.AccelTree(**{
        f: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
        for f, v in arrays2["accel"].items()}), jscene.accel)
    assert scene_from_numpy({f: arrays[f] for f in SCENE_TENSOR_FIELDS},
                            meta, device="cpu").accel is None


def test_loaders_build_the_tree():
    data = make_test_scene_dict(64, 36, num_quads=8)
    scene = scene_from_dict(data, device="cpu")
    verts, idx = scene.vertices.numpy(), scene.tri_vidx.numpy()
    assert_tree_equal(scene.accel,
                      jaccel.build_accel_tree(verts, idx, use_native=False))
    assert scene_from_dict(data, build_accel=False, device="cpu").accel is None
    # .to() and .replace() carry the tree
    moved = scene.to("cpu").replace(width=7)
    assert moved.accel is not None
    assert_tree_equal(moved.accel, scene.accel)
    big = make_big_scene(4096, 64, 32, device="cpu")
    assert_tree_equal(big.accel,
                      jaccel.build_accel_tree(*SOUPS["soup4096"],
                                              use_native=False))
    assert make_big_scene(64, 8, 8, build_accel=False,
                          device="cpu").accel is None
    assert accel_to_numpy(big.accel)["num_nodes"] == big.accel.num_nodes

"""What a new configuration may bring as files alone, each added to a copy
of the benchmark: a fit under GI with its reference in pixel blocks, a
scene kind with its own reference renderer, and the KD tree of a
configuration that asks for the tree backend, which only it gets."""

import json

import pytest
import torch

from bench_setup import BENCH, added_cell, tiny_cell

import run
from harness import driver, scenes
from reference.render import PARAM_KEYS

CPU = torch.device("cpu")


def _file(path: str) -> dict:
    return json.loads((BENCH / path).read_text())


def _limits_hold(cell, numbers):
    return all(v <= cell.check["limits"][k] for k, v in numbers.items())


def test_a_gi_fit_cell_needs_only_new_files(tmp_path):
    mix = {**_file("traffic/fit.json"), "gi": True}
    check = {**_file("checks/quads64.fit.json"), "pixel_block": 512}
    cell = added_cell(tmp_path, "quads64.gi_fit", ("quads64_1080p", None),
                      ("gi_fit", mix), check)
    # on 2^31 + 17 a GI child crosses a triangle's edge between the
    # program's float32 parameters and the reference's after step 1: the
    # losses of steps 2-3 are 0.18 and 0.305 apart, the first step's 4e-7,
    # and under GI loss_gap compares the first step's alone
    res = run.run_cell(cell, 2 ** 31 + 17, 0.3, False, CPU)
    assert res["correct"], res["checks"]
    r = driver.make(cell, CPU, 5, 0.0)
    assert r.ref_scene.gi_on and r.scene.gi_on
    r.run(0.0, False)
    r.free()
    numbers = r.compare(control=True)["numbers"]
    assert not _limits_hold(cell, numbers), numbers


@pytest.mark.parametrize("gi", [False, True])
def test_reference_fit_in_blocks_equals_the_whole_frame(gi):
    """Only the order of the float64 sums differs.  At 200 pixels a block
    the first two blocks are background alone (no graph) and the last is
    short."""
    cell = tiny_cell("quads64.fit")
    cell.traffic["gi"] = gi
    r = driver.make(cell, CPU, 17, 0.0)
    assert r.ref_scene.gi_on == gi
    whole = r.reference_steps(torch.float64)
    cell.check["pixel_block"] = 200
    blocks = r.reference_steps(torch.float64)
    for a, b in zip(blocks["loss"], whole["loss"]):
        assert abs(a - b) <= 1e-12 * abs(b)
    for key in ("grad0", "delta"):
        for k in PARAM_KEYS:
            w, b = whole[key][k], blocks[key][k]
            assert float((b - w).norm()) <= 1e-10 * float(w.norm()), (key, k)


KIND = '''"""The quads scene, with a reference renderer that notes each
dtype it is built in, in a file beside this one."""

import pathlib

from harness import scenes
from reference import render

description = scenes.quads_description


def program_scene(desc, device):
    return scenes.program_scene("quads", desc, device)


def reference_scene(desc):
    return render.scene_from_description(desc)


class Renderer(render.Renderer):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        with open(pathlib.Path(__file__).with_suffix(".used"), "a") as f:
            f.write(f"{self.dtype}\\n")
'''


@pytest.mark.parametrize("mix", ["gi_frames", "fit"])
def test_a_scene_kind_found_by_name(tmp_path, mix):
    cfg = _file("configs/quads64_1080p.json")
    cfg["scene"]["kind"] = "quads_marked"
    cell = added_cell(tmp_path, f"marked.{mix}", ("marked_1080p", cfg),
                      (mix, None), _file(f"checks/quads64.{mix}.json"),
                      {"scenes/quads_marked.py": KIND})
    res = run.run_cell(cell, 17, 0.3, False, CPU)
    assert res["correct"], res["checks"]
    used = cell.bench_dir / "scenes" / "quads_marked.used"
    assert set(used.read_text().split()) == {"torch.float64"}


def test_an_unknown_scene_kind_raises():
    with pytest.raises(ValueError, match="unknown scene kind"):
        scenes.find({"scene": {"kind": "no_such_kind"}}, BENCH)


def test_the_tree_backend_gets_its_tree(tmp_path):
    cfg = _file("configs/quads64_1080p.json")
    cfg["settings"]["backend"] = "tree"
    cell = added_cell(tmp_path, "quads64_tree.frames",
                      ("quads64_tree_1080p", cfg), ("frames", None),
                      _file("checks/soup1m.frames.json"))
    assert driver.make(cell, CPU, 3, 0.0).scene.accel is not None
    assert driver.make(tiny_cell("quads64.fit"), CPU, 3, 0.0).scene.accel \
        is None
    res = run.run_cell(cell, 2 ** 31 + 17, 0.3, False, CPU)
    assert res["correct"], res["checks"]

"""A run with the timed path broken underneath, the look for a card
skipped, comes out not correct: once for each fault the cell can have."""

import pytest
import torch

from bench_setup import tiny_cell

import run
from harness.faults import FRAME_FAULTS, STEP_FAULTS, planted

CASES = ([(c, f) for c in ("quads64.gi_frames", "soup1m.frames")
          for f in FRAME_FAULTS]
         + [("quads64.fit", f) for f in STEP_FAULTS])


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_caught(name, fault):
    cell = tiny_cell(name)
    with planted(fault):
        res = run.run_cell(cell, 99, 0.3, False, torch.device("cpu"))
    assert not res["correct"], res["checks"]
    assert res["failed"] == res["attempted"]


def test_faults_are_put_back():
    from crt_tpu_torch import renderer

    before = renderer.render_image
    with planted("altered"):
        assert renderer.render_image is not before
    assert renderer.render_image is before

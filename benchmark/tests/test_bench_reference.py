"""Each cell at a CPU test's size: the port against the reference comes
out correct, and the control (the reference in bfloat16 in the port's
place) comes out not correct."""

import pytest
import torch

from bench_setup import tiny_cell

import run
from harness import driver

CELLS = ("quads64.gi_frames", "soup1m.frames", "quads64.fit")


def _limits_hold(cell, numbers):
    return all(v <= cell.check["limits"][k] for k, v in numbers.items())


@pytest.mark.parametrize("name", CELLS)
def test_port_matches_reference(name):
    cell = tiny_cell(name)
    res = run.run_cell(cell, 2 ** 31 + 17, 0.5, False, torch.device("cpu"))
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    cell = tiny_cell(name)
    r = driver.make(cell, torch.device("cpu"), 5, 0.0)
    r.run(0.2, False)
    numbers = r.compare(control=True)["numbers"]
    assert not _limits_hold(cell, numbers), numbers

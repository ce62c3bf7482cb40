"""On a card: each cell for a second at its own size through the harness,
correct.  Skips where there is no card (decided inside the test)."""

import pytest
import torch

import bench_setup  # noqa: F401  (the import path)

import run
from harness.registry import find_cell


@pytest.mark.cuda
@pytest.mark.parametrize("name", ("soup1m.frames", "quads64.fit"))
def test_cell_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = run.run_cell(find_cell(name), 123457, 1.0, False,
                       torch.device("cuda", 0))
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"

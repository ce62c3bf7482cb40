"""Shared set-up of the benchmark's CPU tests: the import path, and the
cells cut to a size a CPU test run holds."""

import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for _p in (str(ROOT), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

TINY = {"width": 48, "height": 32}
TINY_TRIANGLES = 16_000


def tiny_cell(name: str):
    """The cell ``name`` at 48 x 32 pixels (and 16,000 triangles for the
    soup), checking every pixel of two frames."""
    from harness.registry import find_cell

    cell = find_cell(name)
    cell.config["scene"].update(TINY)
    if "num_triangles" in cell.config["scene"]:
        cell.config["scene"]["num_triangles"] = TINY_TRIANGLES
    if "pixels" in cell.check:
        cell.check.update(pixels=TINY["width"] * TINY["height"], frames=2)
    return cell

# one torch thread a test process: the tests run in several processes
import torch  # noqa: E402

torch.set_num_threads(1)

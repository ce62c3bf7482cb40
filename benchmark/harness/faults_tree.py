"""A fault planted in the program's KD walk, beside those of
``harness/faults.py``, to show that a cell's check fails it:

  - ``shrunk_boxes``: every node box of the tree the walk takes is shrunk
    about its centre by ``SHRINK`` of its extent on each axis, as a box
    builder that lost its rounding pad would leave it: rays that graze a
    box's faces miss it, and with it the triangles of its leaves.

``planted(name)`` takes this fault's name and every name that
``harness/faults.py`` plants.  Run as a script, it is
``benchmark/readings.py`` with this fault known to ``--fault``:

    python3 benchmark/harness/faults_tree.py --workload quads64.tree_frames \\
        --seconds 3 --fault shrunk_boxes --fault-seeds 4,5,6
"""

from __future__ import annotations

import contextlib
import dataclasses
import pathlib
import sys

TREE_FAULTS = ("shrunk_boxes",)
SHRINK = 0.01


@contextlib.contextmanager
def planted(name: str):
    from harness import faults

    if name not in TREE_FAULTS:
        with faults.planted(name):
            yield
        return
    from crt_tpu_torch.ops import traverse

    real = traverse.closest_hit_tree

    def closest_hit_tree(accel, *a, **k):
        centre = 0.5 * (accel.node_min + accel.node_max)
        half = (0.5 - 0.5 * SHRINK) * (accel.node_max - accel.node_min)
        return real(dataclasses.replace(accel, node_min=centre - half,
                                        node_max=centre + half), *a, **k)

    traverse.closest_hit_tree = closest_hit_tree
    try:
        yield
    finally:
        traverse.closest_hit_tree = real


if __name__ == "__main__":
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import readings

    from harness import faults

    faults.planted = planted
    sys.exit(readings.main())

"""A fault planted in the program's shadow pass, beside those of
``harness/faults.py``, to show that a cell's check fails it:

  - ``cut_shadow_lists``: each tile's shadow list from
    ``bin_apex_shared`` keeps only its first half (its count halved,
    rounded down), as a list cut at a cap would: the blockers on the rest
    are never tested, so lanes they shadow come out lit.

``planted(name)`` takes this fault's name and every name that
``harness/faults.py`` plants.  Run as a script, it is
``benchmark/readings.py`` with this fault known to ``--fault``:

    python3 benchmark/harness/faults_shadow.py --workload tri65k.frames \\
        --seconds 3 --fault cut_shadow_lists --fault-seeds 4,5,6
"""

from __future__ import annotations

import contextlib
import pathlib
import sys

SHADOW_FAULTS = ("cut_shadow_lists",)


@contextlib.contextmanager
def planted(name: str):
    from harness import faults

    if name not in SHADOW_FAULTS:
        with faults.planted(name):
            yield
        return
    from crt_tpu_torch.ops import cluster_trace

    real = cluster_trace.bin_apex_shared

    def bin_apex_shared(*a, **k):
        cluster_list, counts = real(*a, **k)
        return cluster_list, counts // 2

    cluster_trace.bin_apex_shared = bin_apex_shared
    try:
        yield
    finally:
        cluster_trace.bin_apex_shared = real


if __name__ == "__main__":
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import readings

    from harness import faults

    faults.planted = planted
    sys.exit(readings.main())

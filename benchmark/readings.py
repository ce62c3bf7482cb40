"""The readings a cell's limits are set from, in one process.

    python3 benchmark/readings.py --workload <cell> --seconds <s> \\
        --seeds 1,2,... [--control-seeds 7,8,9] \\
        [--fault half_batch --fault-seeds 4,5,6]

For every seed of ``--seeds``: the cell's set-up, a window of
``--seconds`` and its check, as a run makes them; one JSON line of the
numbers compared (the lower readings).  For every seed of
``--control-seeds``: the same with the reference in bfloat16 in the
program's place (the upper readings).  For every seed of
``--fault-seeds``: the program with ``--fault`` planted
(``harness/faults.py``).  The benchmark's own runs do not run this.
"""

import argparse
import json
import sys
import time

import run  # noqa: F401  (sets the caches and the import path)


def _seeds(s: str) -> list:
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args(argv)

    import torch

    from harness import driver
    from harness.faults import planted
    from harness.registry import find_cell

    cell = find_cell(args.workload)
    dev = torch.device("cuda", 0)
    jobs = ([("program", s) for s in _seeds(args.seeds)]
            + [("control", s) for s in _seeds(args.control_seeds)]
            + [(args.fault, s) for s in _seeds(args.fault_seeds)])
    for kind, seed in jobs:
        t = time.perf_counter()
        runner = driver.make(cell, dev, seed, t)
        if kind in ("program", "control"):
            runner.run(args.seconds, False)
        else:
            with planted(kind):
                runner.run(args.seconds, False)
        runner.free()
        torch.cuda.empty_cache()
        cmp = runner.compare(control=kind == "control")
        print(json.dumps({"workload": cell.name, "kind": kind, "seed": seed,
                          "numbers": cmp["numbers"], "info": cmp["info"],
                          "s": round(time.perf_counter() - t, 1)}),
              flush=True)
        del runner
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

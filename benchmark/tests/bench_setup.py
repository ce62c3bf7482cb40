"""Shared set-up of the benchmark's CPU tests: the import path, and the
cells cut to a size a CPU test run holds."""

import json
import pathlib
import shutil
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for _p in (str(ROOT), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

TINY = {"width": 48, "height": 32}
TINY_TRIANGLES = 16_000


def tiny_cell(name: str, bench=None, bench_dir=BENCH):
    """The cell ``name`` at 48 x 32 pixels (and 16,000 triangles for the
    soup), checking every pixel of two frames."""
    from harness.registry import find_cell

    cell = find_cell(name, bench, bench_dir)
    cell.config["scene"].update(TINY)
    if "num_triangles" in cell.config["scene"]:
        cell.config["scene"]["num_triangles"] = TINY_TRIANGLES
    if "pixels" in cell.check:
        cell.check.update(pixels=TINY["width"] * TINY["height"], frames=2)
    return cell


def added_cell(tmp_path, name: str, config, traffic, check: dict,
               files=None):
    """Copy BENCHMARK.json and benchmark/ under ``tmp_path``, add the cell
    ``name`` to the copy as new files and entries alone, and find it there
    at the tests' size.  ``config`` and ``traffic``: (name,
    the file's content), the content None where the copy has the file;
    ``check``: the cell's check file; ``files``: {path under benchmark/:
    text} of more new files."""
    from harness.registry import load_benchmark

    bench_dir = tmp_path / "co" / "benchmark"
    shutil.copytree(BENCH, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = load_benchmark(ROOT)
    (cname, cfg), (tname, mix) = config, traffic
    if cfg is not None:
        (bench_dir / "configs" / f"{cname}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": cname, "source": "x", "reduced": [],
                                 "file": f"benchmark/configs/{cname}.json",
                                 "why": "x"})
    if mix is not None:
        (bench_dir / "traffic" / f"{tname}.json").write_text(json.dumps(mix))
    else:
        mix = json.loads((bench_dir / "traffic" / f"{tname}.json").read_text())
    (bench_dir / "checks" / f"{name}.json").write_text(json.dumps(check))
    for path, text in (files or {}).items():
        (bench_dir / path).parent.mkdir(parents=True, exist_ok=True)
        (bench_dir / path).write_text(text)
    bench["workloads"].append({"name": name, "config": cname,
                               "traffic": tname, "chips": 1, "why": "x"})
    rate = "step_ms" if mix["unit"] == "step" else "frame_ms"
    for m in bench["end_to_end"]:
        if m["name"] == rate:
            m["workloads"].append(name)
    (bench_dir.parent / "BENCHMARK.json").write_text(json.dumps(bench))
    return tiny_cell(name, load_benchmark(bench_dir.parent), bench_dir)

# one torch thread a test process: the tests run in several processes
import torch  # noqa: E402

torch.set_num_threads(1)

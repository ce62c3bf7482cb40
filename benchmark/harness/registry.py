"""Finds what BENCHMARK.json names: a cell's configuration, traffic mix and
check file, and the reader of each per-layer metric, each by its name.

    benchmark/configs/<config>.json    the scene and the settings of a config
    benchmark/traffic/<traffic>.json   the parameters of a traffic mix
    benchmark/checks/<workload>.json   the sizes and limits of a cell's check
    benchmark/metrics/<metric>.py      ``read(ctx) -> float | None``
    benchmark/scenes/<kind>.py         a scene kind other than the built-in
                                       ``quads`` and ``soup``

A new cell, configuration, mix or metric is a new file and a new entry;
no file here changes.  What a configuration may bring as files:

  - a ``scene.kind`` of its own, as ``benchmark/scenes/<kind>.py`` with
    ``description(params, gi_on)``, ``program_scene(desc, device)`` and
    ``reference_scene(desc)``, and, where the kind has materials that the
    base reference raises on, ``Renderer``, a subclass of
    ``reference.render.Renderer`` that every check of its cells builds
    (``harness/scenes.py``);
  - ``"backend": "tree"`` in ``settings``: the program's scene is built
    with the KD tree that backend walks, and only then;
  - a mix with ``"gi": true`` for fit steps as for frames: the scene
    renders with diffuse GI, unsalted, in the steps and in the check;
  - a check's ``pixel_block``: the reference fit renders and
    differentiates the frame in blocks of that many pixels, for frames
    whose whole graph would not fit (``reference/fit.py``).
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
from dataclasses import dataclass

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of BENCHMARK.json with what it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: list  # the metric entries this cell reports with --trace 0
    per_layer: list  # ... with --trace 1
    bench_dir: pathlib.Path = BENCH_DIR  # where its kind's module is found


def _reported(metrics: list, cell: str, e2e_names=None) -> list:
    """The metric entries that ``cell`` reports: those that list it, or
    (without a ``workloads`` key) every cell that reports the end-to-end
    metric they move."""
    out = []
    for m in metrics:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif e2e_names is None or m.get("moves") in e2e_names:
            out.append(m)
    return out


def find_cell(name: str, bench: dict | None = None,
              bench_dir: pathlib.Path = BENCH_DIR) -> Cell:
    """The cell ``name`` with its configuration, traffic and check read
    from their files; KeyError when BENCHMARK.json has no such cell."""
    bench = bench if bench is not None else load_benchmark(bench_dir.parent)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(bench_dir.parent / configs[w["config"]]["file"])
    traffic = _json(bench_dir / "traffic" / f"{w['traffic']}.json")
    check = _json(bench_dir / "checks" / f"{name}.json")
    e2e = _reported(bench["end_to_end"], name)
    e2e_names = {m["name"] for m in e2e}
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, check=check, end_to_end=e2e,
                per_layer=_reported(bench["per_layer"], name, e2e_names),
                bench_dir=bench_dir)


def load_module(path: pathlib.Path, prefix: str):
    """The module of the file ``path``, loaded by its path."""
    spec = importlib.util.spec_from_file_location(
        f"{prefix}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: pathlib.Path = BENCH_DIR):
    """``read(ctx)`` of benchmark/metrics/<name>.py."""
    path = bench_dir / "metrics" / f"{name}.py"
    return load_module(path, "bench_metric").read

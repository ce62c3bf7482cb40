"""BENCHMARK.json resolves, and a new cell, configuration, mix and metric
are found by name from new files alone."""

import json
import re
import shutil

import pytest

from bench_setup import BENCH, ROOT

from harness.registry import find_cell, load_benchmark, metric_reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_resolves():
    bench = load_benchmark()
    for w in bench["workloads"]:
        cell = find_cell(w["name"], bench)
        assert cell.traffic["unit"] in ("frame", "step")
        assert "limits" in cell.check
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_every_metric_has_a_reader():
    bench = load_benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(metric_reader(m["name"]))


def test_names_and_keys_keep_to_the_contract():
    bench = load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in bench[k]}) == len(bench[k])
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in e2e[m["moves"]].get("workloads", [w])
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")


def test_a_new_cell_needs_only_new_files(tmp_path):
    """Copy the benchmark, add a configuration, a mix, a check and a
    metric as files and entries, and find each by name."""
    root = tmp_path / "co"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "quads64_1080p.json").read_text())
    cfg["scene"]["num_quads"] = 8
    (root / "benchmark" / "configs" / "quads8_720p.json").write_text(
        json.dumps(cfg))
    (root / "benchmark" / "traffic" / "still.json").write_text(json.dumps(
        {"unit": "frame", "gi": False, "jitter": False, "warmup_units": 1,
         "trace_units": 2}))
    (root / "benchmark" / "checks" / "quads8.still.json").write_text(
        json.dumps({"frames": 1, "pixels": 64, "pixel_tol": 1e-3,
                    "limits": {"px_off_share": 0.01}}))
    (root / "benchmark" / "metrics" / "frames_seen.py").write_text(
        "def read(ctx):\n    return ctx.window.units\n")
    bench["configs"].append({"name": "quads8_720p", "source": "x",
                             "file": "benchmark/configs/quads8_720p.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "quads8.still", "config": "quads8_720p",
                               "traffic": "still", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "frames_seen", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "frame_ms",
                               "workloads": ["quads8.still"]})
    bench["end_to_end"][0]["workloads"].append("quads8.still")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = find_cell("quads8.still", load_benchmark(root), root / "benchmark")
    assert cell.config["scene"]["num_quads"] == 8
    assert cell.traffic["jitter"] is False
    assert [m["name"] for m in cell.per_layer] == ["frames_seen"]
    read = metric_reader("frames_seen", root / "benchmark")

    class W:
        units = 3

    class Ctx:
        window = W

    assert read(Ctx) == 3
    with pytest.raises(KeyError):
        find_cell("no.such", load_benchmark(root), root / "benchmark")

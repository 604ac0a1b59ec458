"""The benchmark's files: BENCHMARK.json against the rules it is held to,
every configuration, cell and metric a file of its own found by name, and
a new cell that needs no edit of an existing file."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from bench_gpu import harness, tiny_cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return tiny_cells.bench()


def _line_ok(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_keys_names_and_units(bench):
    assert set(bench) == TOP
    assert bench["command"] == ["python3", "bench_gpu/run.py"]
    assert bench["paths"] == ["bench_gpu"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) <= 64 * 1024
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"bench_gpu/configs/{c['name']}.json"
        assert _line_ok(c["source"]) and _line_ok(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line_ok(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    pairs = {(w["config"], w["traffic"]) for w in bench["workloads"]}
    assert len(pairs) == len(bench["workloads"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(m["name"])
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))


def test_metrics_follow_the_contract(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert _line_ok(m["layer"]) and m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        reported = harness.cell_metrics(bench, cell, "end_to_end")
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert harness.cell_metrics(bench, cell, "per_layer")
    # Beside each kernel's roofline, a whole step's mfu moves the same metric.
    for m in bench["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert any("mfu" in o["name"] and o["moves"] == m["moves"] for o in bench["per_layer"])


def test_every_name_has_its_file(bench):
    for c in bench["configs"]:
        cfg = harness.load_json(harness.ROOT, c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
    for w in bench["workloads"]:
        spec = harness.load_json(harness.BENCH, "cells", f"{w['name']}.json")
        assert (spec["config"], spec["traffic"], spec["why"]) == (w["config"], w["traffic"],
                                                                   w["why"])
        assert os.path.exists(os.path.join(harness.BENCH, "traffic", f"{spec['driver']}.py"))
        assert spec["limits"], "every cell compares something"
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert hasattr(harness.load_module("metrics", m["name"]), "read")


def test_every_cell_file_is_whole():
    """Every cell file, in BENCHMARK.json or kept for a later one, names a
    configuration and a driver that exist, gives its limits and a why."""
    for name in sorted(os.listdir(os.path.join(harness.BENCH, "cells"))):
        spec = harness.load_json(harness.BENCH, "cells", name)
        assert set(spec) == {"config", "traffic", "driver", "params", "limits", "why"}
        harness.load_json(harness.BENCH, "configs", f"{spec['config']}.json")
        assert os.path.exists(os.path.join(harness.BENCH, "traffic", f"{spec['driver']}.py"))
        assert NAME.match(spec["traffic"]) and _line_ok(spec["why"]) and spec["limits"]


def test_run_seconds_fit_the_check_with_24_cells(bench):
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_a_new_cell_is_found_by_name_with_no_file_edited(tmp_path):
    """A copy of the benchmark gains a cell (its cell file and its
    configuration's file, and its workload entry in BENCHMARK.json) and
    runs it; no file of bench_gpu/ that was there changes."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, root / "bench_gpu",
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    before = {p: (root / "bench_gpu" / p).read_bytes()
              for p in _files(root / "bench_gpu")}
    bench = tiny_cells.bench()
    bench["workloads"].append({"name": "tiny_count", "config": "tiny_genome",
                               "traffic": "tiny_passes", "chips": 1, "why": "a test cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cfg = tiny_cells.config("genome13_count")
    cfg["name"] = "tiny_genome"
    (root / "bench_gpu" / "configs" / "tiny_genome.json").write_text(json.dumps(cfg))
    spec = tiny_cells.spec("genome13_count")
    spec.update(config="tiny_genome", traffic="tiny_passes", why="a test cell")
    (root / "bench_gpu" / "cells" / "tiny_count.json").write_text(json.dumps(spec))
    code = ("import sys, json; sys.path.insert(0, sys.argv[1]); sys.path.append(sys.argv[2]); "
            "from bench_gpu import harness; "
            "print(json.dumps(harness.run_cell('tiny_count', 5, 0.2, False, device='cpu')))")
    out = subprocess.run([sys.executable, "-c", code, str(root), harness.ROOT],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and set(line["metrics"]) == {"setup_s"}
    assert {p: (root / "bench_gpu" / p).read_bytes() for p in before} == before


def _files(base):
    return [os.path.relpath(os.path.join(d, f), base) for d, _, fs in os.walk(base)
            for f in fs if "__pycache__" not in d]

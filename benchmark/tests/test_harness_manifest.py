"""BENCHMARK.json and the files it names keep to the benchmark's contract:
names and units of the allowed characters, each metric with its layer and
the end-to-end metric it moves, reported by every cell it lists, and every
configuration, traffic mix, limit and metric reader in a file of its own."""

import json
import os
import re

import pytest

from benchmark import loops, run

M = run.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = {w["name"]: w for w in M["workloads"]}
E2E = {e["name"]: e for e in M["end_to_end"]}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert os.path.getsize(os.path.join(run.ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(M["command"]) <= 32 and all(_line(w) for w in M["command"])
    assert all(not w.startswith("/") and ".." not in w for w in M["command"])
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.endswith("_torch")
    files = [w for w in M["command"] if os.path.exists(os.path.join(run.ROOT, w))]
    assert all(any(f.startswith(p + "/") for p in M["paths"]) for f in files)
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's 43200 s
    assert (2 + 14 * 24) * (M["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_and_units():
    names = ([c["name"] for c in M["configs"]] + list(CELLS) + list(E2E)
             + [p["name"] for p in M["per_layer"]])
    assert all(NAME.match(n) for n in names)
    for group in (M["configs"], M["workloads"], M["end_to_end"], M["per_layer"]):
        assert len({g["name"] for g in group}) == len(group)
    for metric in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")


def test_configs():
    assert 1 <= len(M["configs"]) <= 24
    files = [c["file"] for c in M["configs"]]
    assert len(set(files)) == len(files)
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("benchmark/configs/")
        with open(os.path.join(run.ROOT, c["file"])) as f:
            json.load(f)
        used = [w for w in M["workloads"] if w["config"] == c["name"]]
        assert used, f"configuration {c['name']} has no cell"


def test_cells():
    assert 1 <= len(M["workloads"]) <= 24
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        loop = loops.find(run.cell(w["name"])[3]["loop"])
        assert callable(loop.run) and callable(loop.numbers)
        assert w["chips"] in (1, 4) and _line(w["why"]) and NAME.match(w["traffic"])
        assert os.path.exists(os.path.join(run.HERE, "traffic", f"{w['traffic']}.json"))
        assert os.path.exists(os.path.join(run.HERE, "limits", f"{w['name']}.json"))
        reported = [e for e in M["end_to_end"] if w["name"] in e.get("workloads", [w["name"]])]
        assert "setup_s" in {e["name"] for e in reported} and len(reported) >= 2
        assert any(w["name"] in p.get("workloads", [w["name"]]) for p in M["per_layer"])


def test_end_to_end():
    assert 1 <= len(E2E) <= 16 and "setup_s" in E2E
    for e in M["end_to_end"]:
        assert os.path.exists(run.reader_path(e["name"])) and callable(run.reader(e["name"]))
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
        assert all(w in CELLS for w in e.get("workloads", []))


@pytest.mark.parametrize("metric", M["per_layer"], ids=lambda p: p["name"])
def test_per_layer(metric):
    assert set(metric) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert _line(metric["layer"]) and metric["moves"] in E2E
    moved = E2E[metric["moves"]]
    for w in metric.get("workloads", CELLS):
        assert w in CELLS and w in moved.get("workloads", CELLS)
    assert os.path.exists(run.reader_path(metric["name"]))
    assert callable(run.reader(metric["name"]))
    if metric["unit"] == "%" and ("roofline" in metric["name"] or "mfu" in metric["name"]):
        assert metric["better"] == "higher"


def test_layers_named_alike():
    """Metrics of one layer give the same layer name, letter for letter."""
    by_layer = {}
    for p in M["per_layer"]:
        by_layer.setdefault(p["layer"].lower(), set()).add(p["layer"])
    assert all(len(v) == 1 for v in by_layer.values())

"""BENCHMARK.json and the benchmark's data files hold together: every cell,
and configuration file loads and names what exists; names and units
use the allowed characters; every per-layer metric has a reader and moves an
end-to-end metric that each of its cells reports."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HERE = os.path.join(ROOT, "portbench")
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = {w["name"]: w for w in BENCH["workloads"]}
CONFIGS = {c["name"]: c for c in BENCH["configs"]}


def load(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_files(name):
    cell = load("workloads", f"{name}.json")
    entry = CELLS[name]
    assert (cell["config"], cell["traffic"], cell["chips"], cell["why"]) == (
        entry["config"], entry["traffic"], entry["chips"], entry["why"])
    assert name == f"{cell['config']}.{cell['traffic']}"
    assert cell["config"] in CONFIGS
    assert os.path.exists(os.path.join(HERE, "modes", f"{cell['mode']}.py"))
    assert int(cell["batch"]) > 0 and (cell.get("tier") or cell.get("precision"))
    assert cell["limits"] and all(isinstance(v, (int, float)) for v in cell["limits"].values())
    assert entry["chips"] == 1 and 1 <= len(entry["why"]) <= 200


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_files(name):
    entry = CONFIGS[name]
    cfg = json.load(open(os.path.join(ROOT, entry["file"])))
    assert entry["file"].startswith("portbench/")
    assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"] == []
    assert os.path.exists(os.path.join(ROOT, cfg["model"]))
    assert len(cfg["anchors"]) % 3 == 0


def test_names_and_units():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + list(CELLS) + list(CONFIGS)
    assert len(names) == len(set(names))
    for n in names + [w["config"] for w in CELLS.values()] + [w["traffic"] for w in CELLS.values()]:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_moves_what_its_cells_report(metric):
    assert os.path.exists(os.path.join(HERE, "metrics", f"{metric['name']}.py"))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    moved = e2e[metric["moves"]]
    for cell in metric["workloads"]:
        assert cell in CELLS
        assert cell in moved.get("workloads", [cell])
    if "roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_every_cell_reports_setup_another_e2e_and_a_per_layer_metric():
    for cell in CELLS:
        e2e = [m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])]
        layer = [m["name"] for m in BENCH["per_layer"] if cell in m.get("workloads", [cell])]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer

"""BENCHMARK.json against the benchmark's contract, and every file that a
name in it leads to."""

import json
import re

import pytest

from gnnbench.tests.small import ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
GNN = ROOT / "gnnbench"


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["gnnbench"]
    assert MANIFEST["command"][1] == "gnnbench/run.py"
    assert 1 <= MANIFEST["run_seconds"] <= 51
    cells = len(MANIFEST["workloads"])
    assert 1 <= cells <= 24
    assert (2 + 14 * 24) * (MANIFEST["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(section):
    names = [e["name"] for e in MANIFEST[section]]
    assert len(names) == len(set(names))
    for e in MANIFEST[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_configs_found_by_name():
    for c in MANIFEST["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and c["file"].startswith("gnnbench/configs/")
        assert c["reduced"] == cfg["reduced"]
        assert set(c) == {"name", "source", "file", "reduced", "why"}


def test_cells_find_their_files():
    configs = {c["name"] for c in MANIFEST["configs"]}
    used = set()
    for w in MANIFEST["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
        traffic = json.loads((GNN / "traffic" / f"{w['traffic']}.json").read_text())
        assert (GNN / "drivers" / f"{traffic['driver']}.py").exists()
        limits = json.loads((GNN / "limits" / f"{w['name']}.json").read_text())["checks"]
        assert limits and all("limit" in v for v in limits.values())
        used.add(w["config"])
    assert used == configs
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in MANIFEST["workloads"]) <= max(1, len(pairs) // 4)


def test_metrics():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = [w["name"] for w in MANIFEST["workloads"]]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")

    def has(metric, cell):
        return "workloads" not in metric or cell in metric["workloads"]

    for cell in cells:
        assert sum(has(m, cell) for m in e2e.values()) >= 2
        assert any(has(m, cell) for m in MANIFEST["per_layer"])
    for m in MANIFEST["per_layer"]:
        assert (GNN / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in e2e and "bound" not in m
        for cell in m.get("workloads", cells):
            assert has(e2e[m["moves"]], cell), (m["name"], cell)
    layers = {}
    for m in MANIFEST["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert set(layers) <= {"step", "host dispatch", "distributed", "sampler", "gather ops", "GAT ops", "device"}

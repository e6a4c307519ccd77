"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
finds its file."""

import glob
import json
import os
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def m():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_manifest_has_exactly_the_contract_keys(m):
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10
    assert 1 <= m["run_seconds"] <= 51
    assert isinstance(m["run_seconds"], int)
    assert 1 <= len(m["command"]) <= 32
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    for word in m["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word


def test_entries_have_only_their_keys(m):
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                         "source"}
    for e in m["per_layer"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "source",
                                         "layer", "moves"}


def test_names_units_and_texts_keep_to_their_characters(m):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in m[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in m["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in m["configs"]:
        assert 1 <= len(c["source"]) <= 200 and "\t" not in c["source"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key)
    for e in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(e["unit"]), e["unit"]
        assert e["better"] in ("lower", "higher")
        assert e["source"] in SOURCES
    for e in m["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for e in m["per_layer"]:
        assert 1 <= len(e["layer"]) <= 200 and "\n" not in e["layer"]


def test_every_cell_finds_its_config_and_traffic_files(m):
    configs = {c["name"]: c for c in m["configs"]}
    for w in m["workloads"]:
        cfg = configs[w["config"]]
        assert cfg["file"].startswith(m["paths"][0] + "/")
        with open(os.path.join(ROOT, cfg["file"])) as f:
            assert json.load(f)["name"] == w["config"]
        assert os.path.exists(os.path.join(
            ROOT, "ecbench/traffic", w["traffic"] + ".json"))
        from ecbench.manifest import Cell
        assert callable(Cell(ROOT, w["name"]).entry().op)
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(pairs) == len(set(pairs))
    files = [c["file"] for c in m["configs"]]
    assert len(files) == len(set(files))


def test_every_mix_names_an_entry_file():
    for path in glob.glob(os.path.join(ROOT, "ecbench/traffic/*.json")):
        with open(path) as f:
            entry = json.load(f)["entry"]
        assert os.path.exists(os.path.join(
            ROOT, "ecbench/entries", entry + ".py")), (path, entry)


def test_each_configuration_keeps_a_cell(m):
    used = {w["config"] for w in m["workloads"]}
    assert used == {c["name"] for c in m["configs"]}


def test_every_metric_has_a_reader(m):
    from ecbench.manifest import Cell
    cell = Cell(ROOT, m["workloads"][0]["name"])
    for e in m["end_to_end"] + m["per_layer"]:
        assert callable(cell.reader(e["name"]))


def test_per_layer_metrics_move_what_their_cells_report(m):
    e2e = {e["name"]: e for e in m["end_to_end"]}
    cells = {w["name"] for w in m["workloads"]}
    layers = {}
    for e in m["per_layer"]:
        assert e["moves"] in e2e
        for w in e.get("workloads", cells):
            assert w in cells
            assert w in e2e[e["moves"]].get("workloads", cells)
        layers.setdefault(e["layer"].lower(), set()).add(e["layer"])
    # one spelling per layer
    assert all(len(v) == 1 for v in layers.values())


def test_every_cell_reports_setup_another_rate_and_a_layer(m):
    from ecbench.manifest import Cell
    for w in m["workloads"]:
        cell = Cell(ROOT, w["name"])
        e2e = [e["name"] for e in cell.metrics(trace=False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.metrics(trace=True)

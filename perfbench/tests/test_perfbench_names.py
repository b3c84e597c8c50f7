"""``BENCHMARK.json`` against the contract's shapes: keys, names, units,
lengths, and every named file where the harness looks for it."""

import json
import os
import re

import pytest

from perfbench import harness

ROOT = os.path.dirname(harness.HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"] and 1 <= bench["run_seconds"] <= 51
    assert all(LINE.match(w) and not w.startswith("/") and ".." not in w
               for w in bench["command"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"] == f"perfbench/configs/{c['name']}.yaml"
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert len(names) == len(set(names))


def test_metrics_wiring(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and LINE.match(m["layer"])
        for cell in m["workloads"]:
            assert cell in cells and cell in e2e[m["moves"]].get("workloads", [cell])
    for cell in cells:
        assert len(harness.cell_metrics(bench, cell, False)) >= 2
        assert harness.cell_metrics(bench, cell, True)


def test_every_named_file_is_there(bench):
    for w in bench["workloads"]:
        mix = harness.load_json("mixes", w["traffic"])
        harness.find("drivers", mix["driver"], ".py")
        assert "limits" in harness.load_json("workloads", w["name"])
        harness.load_config(w["config"])
    for m in bench["per_layer"]:
        harness.find("metrics", m["name"], ".py")
    for name in os.listdir(harness.HERE):
        assert re.match(r"^[A-Za-z0-9_.-]+$", name), name

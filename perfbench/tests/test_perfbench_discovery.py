"""A new cell, configuration, traffic mix and per-layer metric are files
dropped into the folders: the harness finds them with no change to code."""

import json
import os
import shutil

from perfbench import harness


def test_new_files_are_found(tmp_path):
    base = tmp_path / "perfbench"
    shutil.copytree(harness.HERE, base, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(base / "configs" / "ayolo-r18-shipped.yaml", base / "configs" / "new-config.yaml")
    (base / "mixes" / "new_mix.json").write_text(json.dumps({"driver": "batch_dir", "x": 1}))
    (base / "workloads" / "new-cell.json").write_text(json.dumps({"limits": {"conf_gap_rel": 0.1}}))
    (base / "metrics" / "new_metric.batch.py").write_text(
        "def read(trace, facts):\n    return 42.0\n")
    with open(os.path.join(os.path.dirname(harness.HERE), "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "new-cell", "config": "new-config",
                               "traffic": "new_mix", "chips": 1, "why": "a test"})
    bench["end_to_end"][1].setdefault("workloads", []).append("new-cell")
    bench["per_layer"].append({"name": "new_metric.batch", "unit": "%", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": bench["end_to_end"][1]["name"],
                               "workloads": ["new-cell"]})
    assert harness.load_config("new-config", str(base))["config"]["block_layers"]
    mix = harness.load_json("mixes", "new_mix", str(base))
    assert harness.driver(mix["driver"], str(base)).run
    assert harness.load_json("workloads", "new-cell", str(base))["limits"]["conf_gap_rel"] == 0.1
    wanted = [m["name"] for m in harness.cell_metrics(bench, "new-cell", True)]
    assert wanted == ["new_metric.batch"]
    assert harness.metric_reader("new_metric.batch", str(base)).read({}, {}) == 42.0
    assert [m["name"] for m in harness.cell_metrics(bench, "new-cell", False)] == [
        "setup_s", bench["end_to_end"][1]["name"]]

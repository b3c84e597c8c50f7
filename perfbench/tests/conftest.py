"""CPU fixtures: the cells' drivers at a tiny size (4 s windows, one block
a stage, batch 4), no card, no tracing."""

from __future__ import annotations

import copy
import os
import sys
import types

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import harness  # noqa: E402


def tiny_config(name: str = "ayolo-r18-shipped") -> dict:
    doc = harness.load_config(name)
    cfg = copy.deepcopy(doc["config"])
    cfg["sample_duration"] = 4
    cfg["block_layers"] = [1, 1, 1, 1]
    cfg["train_config"]["batch_size"] = 4
    doc["config"] = cfg
    return doc


def cell_entry(cell: str) -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        import json

        return {w["name"]: w for w in json.load(f)["workloads"]}[cell]


def tiny_mix(cell: str) -> dict:
    t = harness.load_json("mixes", cell_entry(cell)["traffic"])
    if "files" in t:
        t["files"] = {"length_seed": 0, "groups": [{"count": 3, "seconds": 4},
                                                   {"count": 2, "log_uniform_s": [6, 12]}]}
    return t


@pytest.fixture
def tiny_ctx(tmp_path):
    import torch

    def make(cell: str, seed: int = 5, seconds: float = 0.5, weights_seed: int = None):
        """``weights_seed``: a checkpoint other than the configuration's."""
        args = types.SimpleNamespace(workload=cell, seed=seed, seconds=seconds, trace=0)
        config = tiny_config(cell_entry(cell)["config"])
        if weights_seed is not None:
            config["weights_seed"] = weights_seed
        ctx = harness.Context(args, tiny_mix(cell), harness.load_json("workloads", cell)["limits"],
                              config, torch.device("cpu"), 0.0)
        ctx.tmp = str(tmp_path / f"run{seed}")
        os.makedirs(ctx.tmp, exist_ok=True)
        return ctx

    torch.set_num_threads(2)
    return make


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")

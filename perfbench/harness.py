"""One run of one cell: find its files by name, check the card, hand the
driver its context, then assemble the result line.

A cell of ``BENCHMARK.json`` names its configuration (``configs/<config>.yaml``)
and its traffic mix (``mixes/<traffic>.json``, whose ``driver`` names the
generator, ``drivers/<driver>.py``); ``workloads/<cell>.json`` holds the
cell's limits on the numbers its driver compares.

A driver module (``drivers/<name>.py``) defines ``run(ctx) -> dict`` with
the keys ``metrics`` ({end-to-end metric: value}), ``attempted``,
``failed``, ``checks`` ({name: (value, limit)}), ``facts`` (numbers the
per-layer metrics read) and ``memory_peak_bytes``. ``correct`` is true when
every check's value is at or under its limit and nothing failed.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import tempfile
import time
from types import ModuleType
from typing import Any, Dict, List

import yaml

from .trace import Tracer, breakdown

HERE = os.path.dirname(os.path.abspath(__file__))


class NoCard(RuntimeError):
    pass


def load_module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find(kind: str, name: str, ext: str, base: str = HERE) -> str:
    path = os.path.join(base, kind, name + ext)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return path


def load_json(kind: str, name: str, base: str = HERE) -> Dict[str, Any]:
    with open(find(kind, name, ".json", base)) as f:
        return json.load(f)


def load_config(name: str, base: str = HERE) -> Dict[str, Any]:
    """The configuration file: ``config`` (as run), ``weights_seed`` (the
    checkpoint's seed), ``source``, ``changed`` and ``assumed``."""
    with open(find("configs", name, ".yaml", base)) as f:
        return yaml.safe_load(f)


def driver(name: str, base: str = HERE) -> ModuleType:
    return load_module(find("drivers", name, ".py", base), f"perfbench_driver_{name}")


def metric_reader(name: str, base: str = HERE) -> ModuleType:
    return load_module(find("metrics", name, ".py", base),
                       "perfbench_metric_" + name.replace(".", "_"))


def cell_metrics(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The end-to-end metrics a cell reports (those that list it, and those
    without a list), or with ``trace`` its per-layer metrics (those that
    list it)."""
    if trace:
        return [m for m in bench["per_layer"] if cell in m["workloads"]]
    return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]


def judge(out: Dict[str, Any]):
    """(correct, {check: {"value", "limit"}}) of a driver's output: nothing
    failed and every compared number at or under its limit."""
    checks = {k: {"value": float(v), "limit": float(lim)} for k, (v, lim) in out["checks"].items()}
    ok = out["failed"] == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


class Context:
    """What a driver gets: the run's arguments, its cell and configuration,
    the device, a private temporary directory, the tracer and the clock."""

    def __init__(self, args, mix: Dict, limits: Dict, config: Dict, device, t_start: float):
        self.args, self.seed, self.seconds = args, int(args.seed), float(args.seconds)
        self.mix, self.limits, self.config = mix, limits, config
        self.cfg = config["config"]
        self.device = device
        self.tracer = Tracer(bool(args.trace))
        self.t_start = t_start
        self.tmp = tempfile.mkdtemp(prefix="perfbench-")

    def setup_s(self) -> float:
        return time.perf_counter() - self.t_start


class Run:
    def __init__(self, root: str, args, t_start: float):
        import torch

        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.bench = json.load(f)
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if args.workload not in cells:
            raise KeyError(f"BENCHMARK.json has no workload {args.workload!r}")
        chips = int(cells[args.workload]["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise NoCard(f"the cell needs {chips} CUDA card(s); "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
        self.args, self.chips = args, chips
        cell = cells[args.workload]
        mix = load_json("mixes", cell["traffic"])
        self.ctx = Context(args, mix, load_json("workloads", args.workload)["limits"],
                           load_config(cell["config"]), torch.device("cuda", 0), t_start)
        self.driver = driver(mix["driver"])

    def execute(self) -> Dict[str, Any]:
        import torch

        ctx = self.ctx
        try:
            out = self.driver.run(ctx)
        finally:
            shutil.rmtree(ctx.tmp, ignore_errors=True)
        correct, checks = judge(out)
        metrics: Dict[str, Dict[str, Any]] = {}
        wanted = cell_metrics(self.bench, self.args.workload, bool(self.args.trace))
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": self.chips,
                  "memory_peak_bytes": int(out["memory_peak_bytes"])}
        result: Dict[str, Any] = {"correct": bool(correct), "attempted": int(out["attempted"]),
                                  "failed": int(out["failed"])}
        summary = ctx.tracer.summary
        if self.args.trace:
            if summary is None:
                raise RuntimeError("the traced run recorded no slice")
            device["busy_s"], device["window_s"] = summary["busy_s"], summary["window_s"]
            for m in wanted:
                value = metric_reader(m["name"]).read(summary, out["facts"])
                if value is not None:
                    metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        else:
            for m in wanted:
                metrics[m["name"]] = {"value": float(out["metrics"][m["name"]]), "unit": m["unit"]}
        result["metrics"] = metrics
        result["device"] = device
        if self.args.trace:
            result["breakdown"] = breakdown(summary)
        result["checks"] = checks
        return result

"""Readings for setting a cell's limits: the compared numbers of the
program on many seeds, and of its control, in one process on the card.

    python3 -m perfbench.calibrate --workload <cell> --seeds 1 2 3 [--controls NAME ...]

Prints one JSON line per seed and control (the program itself where no
control is named). The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import shutil
import time
import types


def main(argv=None) -> None:
    from . import run as entry

    entry._pin_caches()
    import torch

    from . import harness

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", nargs="+", default=["program"],
                   help="controls the driver names; 'program' is the program itself")
    a = p.parse_args(argv)
    with open("BENCHMARK.json") as f:
        cell = {w["name"]: w for w in json.load(f)["workloads"]}[a.workload]
    mix = harness.load_json("mixes", cell["traffic"])
    drv = harness.driver(mix["driver"])
    for control, seed in ((c, s) for c in a.controls for s in a.seeds):
        args = types.SimpleNamespace(workload=a.workload, seed=seed, seconds=0.0, trace=0)
        ctx = harness.Context(args, mix, harness.load_json("workloads", a.workload)["limits"],
                              harness.load_config(cell["config"]), torch.device("cuda", 0),
                              time.perf_counter())
        try:
            got = drv.readings(ctx, control=None if control == "program" else control)
        finally:
            shutil.rmtree(ctx.tmp, ignore_errors=True)
        print(json.dumps({"workload": a.workload, "seed": seed, "control": control,
                          "s": time.perf_counter() - ctx.t_start, **got}), flush=True)


if __name__ == "__main__":
    main()

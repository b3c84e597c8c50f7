"""Run one cell of the benchmark and print its result as the last line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``perfbench/``
and ``audioyolo_tpu_torch``. Everything that belongs to one cell, one
configuration or one per-layer metric is a file found by its name:
``workloads/<cell>.json`` names its configuration (``configs/<config>.yaml``)
and its driver (``drivers/<driver>.py``); each per-layer metric of
``BENCHMARK.json`` is read by ``metrics/<metric>.py``. The run needs a CUDA
card: without one, or with fewer than the cell asks for, it exits 2 and
prints no result; so it does if any module of JAX, flax or the JAX package
is loaded once the window has closed.
"""

from __future__ import annotations

import os
import time


def _process_age_s() -> float:
    """Seconds since this process started (``/proc``), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age_s()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "audioyolo_tpu")
ROOT = os.getcwd()


def _pin_caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    base = os.path.join(ROOT, ".perfbench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    _pin_caches()
    from . import harness

    try:
        run = harness.Run(ROOT, args, T_START)
    except harness.NoCard as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    result = run.execute()
    found = forbidden_modules()
    if found:
        print(f"perfbench: modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())

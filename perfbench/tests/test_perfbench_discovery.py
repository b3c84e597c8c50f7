"""A new cell, configuration, traffic mix, per-layer metric and backbone
are files dropped into the folders: the harness finds them with no change
to code."""

import importlib
import importlib.util
import json
import math
import os
import shutil
import sys

import pytest

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


TOY_BACKBONE = '''"""A toy backbone: a 4x4/4 stem, a pointwise pair of 2-D weights with a
GELU between and a layer scale on a residual, then three 2x2/2 convs."""
import math

import torch
import torch.nn.functional as F

FE = "feature_extractor"
WIDTHS = (8, 12, 16, 24)


def shapes(cfg):
    c, h = WIDTHS[0], int(cfg["toy_hidden"])
    s = {FE + ".stem.weight": (c, 2, 4, 4), FE + ".stem.bias": (c,),
         FE + ".pw1.weight": (h, c), FE + ".pw2.weight": (c, h), FE + ".gamma": (c,)}
    for i in range(3):
        s[f"{FE}.down{i}.weight"] = (WIDTHS[i + 1], WIDTHS[i], 2, 2)
    return s, WIDTHS


def draw(name, shape, u):
    if name.endswith((".pw1.weight", ".pw2.weight")):
        return (2.0 * u - 1.0) * math.sqrt(6.0 / sum(shape))
    if name.endswith(".gamma"):
        return 0.5 + 0.1 * u
    return None


def forward(det, x):
    sd, r = det.sd, det.r
    x = det.conv(x, FE + ".stem", 4)
    y = r(F.gelu(r(torch.einsum("bchw,dc->bdhw", x, r(sd[FE + ".pw1.weight"])))))
    y = r(torch.einsum("bdhw,cd->bchw", y, r(sd[FE + ".pw2.weight"])))
    out = [r(x + r(y * r(sd[FE + ".gamma"]).view(1, -1, 1, 1)))]
    for i in range(3):
        out.append(r(F.gelu(det.conv(out[-1], f"{FE}.down{i}", 2))))
    return out
'''


@pytest.fixture
def toy_copy(tmp_path):
    """A copy of the harness with one new file, ``reference/backbones/toy.py``,
    imported as its own package."""
    base = tmp_path / "perfbench_toy"
    shutil.copytree(harness.HERE, base, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (base / "reference" / "backbones" / "toy.py").write_text(TOY_BACKBONE)
    name = "perfbench_toy_copy"
    spec = importlib.util.spec_from_file_location(name, base / "__init__.py",
                                                  submodule_search_locations=[str(base)])
    sys.modules[name] = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(sys.modules[name])
        yield base, name
    finally:
        for m in [m for m in sys.modules if m == name or m.startswith(name + ".")]:
            del sys.modules[m]


def test_new_backbone_is_one_new_file(toy_copy):
    """A backbone with a 2-D pointwise weight and a layer scale of its own
    draw: the copy's weights, reference and FLOP count take it, and the
    copy differs from the harness by the one file."""
    import torch

    base, name = toy_copy
    new = {os.path.relpath(os.path.join(d, f), base) for d, _, fs in os.walk(base) for f in fs}
    old = {os.path.relpath(os.path.join(d, f), harness.HERE)
           for d, _, fs in os.walk(harness.HERE) for f in fs}
    assert new - old == {os.path.join("reference", "backbones", "toy.py")}
    weights = importlib.import_module(name + ".weights")
    detector = importlib.import_module(name + ".reference.detector")
    model_flops = importlib.import_module(name + ".count.model_flops")
    toy = detector.backbone_module({"backbone": "toy"})

    torch.set_num_threads(2)
    cfg = dict(harness.load_config("ayolo-r18-shipped")["config"], backbone="toy", toy_hidden=16)
    seed = 2 ** 31 + 9
    sd = weights.make(cfg, 2, seed, "cpu", fit_windows=1)
    shapes = detector.checkpoint_shapes(cfg, 2)
    assert set(sd) == set(shapes) and "feature_extractor.gamma" in sd
    gen = torch.Generator().manual_seed(seed)
    flat = torch.rand(sum(math.prod(s) for s in shapes.values()), generator=gen)
    off = 0
    for leaf, shape in shapes.items():
        n = math.prod(shape)
        if leaf.endswith((".pw1.weight", ".gamma")):
            assert torch.equal(sd[leaf], toy.draw(leaf, shape, flat[off: off + n].view(shape)))
        off += n
    assert float(sd["feature_extractor.pw1.weight"].min()) < 0.0      # not a norm scale
    assert float(sd["feature_extractor.gamma"].min()) >= 0.5          # not a conv bias

    window = int(round(float(cfg["sample_duration"]) * int(cfg["sample_rate"])))
    wave = 0.1 * torch.randn(1, window, generator=torch.Generator().manual_seed(1))
    preds = detector.Detector(cfg, sd, "cpu")(wave)
    assert preds.shape == (1, 630, 5) and bool(torch.isfinite(preds).all())

    # the pointwise pair at 8x240 positions: 2 products of 2*8*hidden a position
    flops = {h: model_flops.forward_flops_per_window(dict(cfg, toy_hidden=h), 2) for h in (8, 16)}
    assert flops[16] - flops[8] == 2 * 2 * 8 * (16 - 8) * 8 * 240

"""The port's metric plots and log format on the CPU against the JAX
package's: ``TrainerPipeline._save_plot`` of both packages, called unbound on
plain namespaces (nothing is built or compiled), draw the same figures from
the same metric dicts (file names, size, subplot count, titles, axis labels,
grids and plotted values, captured at ``Figure.savefig``); a split without
rows writes nothing; without matplotlib the port warns once and the CSVs are
written; ``setup_logging`` configures the root logger with JAX's format.
``tests/test_torch_train_cli.py::test_train_cli_end_to_end_on_the_cpu``
checks that a ``train_cli`` run writes both images.
"""

import functools
import logging
import math
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from audioyolo_tpu.train.trainer import TrainerPipeline as JTrainer
from audioyolo_tpu.utils import logging as j_logging

from audioyolo_tpu_torch.train import METRIC_KEYS, TrainerPipeline
from audioyolo_tpu_torch.utils import logging as t_logging

FIGSIZE = (25, 10)


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    rows = [{k: float(v) for k, v in zip(METRIC_KEYS, rng.uniform(0, 5, len(METRIC_KEYS)))}
            for _ in range(n)]
    if rows:
        rows[-1]["f1"] = math.nan
    return rows


@pytest.fixture()
def figures(monkeypatch):
    """What every saved figure holds, in save order."""
    from matplotlib.figure import Figure

    seen = []
    real = Figure.savefig

    def record(fig, path, *a, **k):
        axes = [dict(title=ax.get_title(), xlabel=ax.get_xlabel(), ylabel=ax.get_ylabel(),
                     grid=[g.get_visible() for g in ax.get_xgridlines() + ax.get_ygridlines()],
                     lines=[np.asarray(line.get_ydata(), np.float64) for line in ax.lines])
                for ax in fig.axes]
        seen.append(dict(name=os.path.basename(path), size=tuple(fig.get_size_inches()),
                         axes=axes))
        return real(fig, path, *a, **k)

    monkeypatch.setattr(Figure, "savefig", record)
    return seen


def _port_ns(path, train, eval_):
    ns = SimpleNamespace(rank=0, metrics_path=str(path), train_metrics=train,
                         eval_metrics=eval_)
    ns._save_plot = functools.partial(TrainerPipeline._save_plot, ns)
    return ns


@pytest.mark.parametrize("n_eval", [3, 0], ids=["both", "empty_eval"])
def test_plots_match_jax(n_eval, tmp_path, figures):
    train, eval_ = _rows(4, 1), _rows(n_eval, 2)
    jns = SimpleNamespace(_train_metrics=train, _eval_metrics=eval_,
                          metrics_path=str(tmp_path / "jax"))
    for mode in ("train", "eval"):
        JTrainer._save_plot(jns, mode, FIGSIZE)
    ref = list(figures)
    figures.clear()
    TrainerPipeline.save_metrics_plots(_port_ns(tmp_path / "port", train, eval_),
                                       figsize=FIGSIZE)
    want = ["train_metrics_plot.jpg"] + (["eval_metrics_plot.jpg"] if n_eval else [])
    assert [f["name"] for f in figures] == [f["name"] for f in ref] == want
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    for ours, theirs in zip(figures, ref):
        assert ours["size"] == theirs["size"] == FIGSIZE
        assert len(ours["axes"]) == len(theirs["axes"]) == len(METRIC_KEYS)
        for a, b in zip(ours["axes"], theirs["axes"]):
            assert (a["title"], a["xlabel"], a["ylabel"], a["grid"]) == \
                (b["title"], b["xlabel"], b["ylabel"], b["grid"])
            assert len(a["lines"]) == len(b["lines"]) == 1
            np.testing.assert_array_equal(a["lines"][0], b["lines"][0])
    assert figures[0]["axes"][0]["title"] == "[Train] Aggregate Loss vs Epoch"


def test_no_plots_for_other_ranks(tmp_path, figures):
    ns = _port_ns(tmp_path, _rows(2, 3), _rows(2, 4))
    ns.rank = 1
    TrainerPipeline.save_metrics_plots(ns)
    assert not figures and not os.path.exists(tmp_path / "train_metrics_plot.jpg")


def test_without_matplotlib_warns_once_and_writes_the_csvs(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    ns = _port_ns(tmp_path, _rows(2, 5), _rows(2, 6))
    TrainerPipeline.metrics_to_csv(ns)
    with pytest.warns(UserWarning, match="matplotlib") as caught:
        TrainerPipeline.save_metrics_plots(ns)
    assert len(caught) == 1
    assert sorted(os.listdir(tmp_path)) == ["eval_metrics.csv", "train_metrics.csv"]


def test_setup_logging_uses_the_jax_format(monkeypatch):
    assert (t_logging.LOG_FORMAT, t_logging.LOG_DATE_FORMAT) == \
        (j_logging.LOG_FORMAT, j_logging.LOG_DATE_FORMAT)
    root = logging.getLogger()
    got = []
    for setup in (j_logging.setup_logging, t_logging.setup_logging):
        monkeypatch.setattr(root, "handlers", [])
        monkeypatch.setattr(root, "level", logging.NOTSET)
        setup()
        (handler,) = root.handlers
        got.append((handler.formatter._fmt, handler.formatter.datefmt, root.level))
    assert got[0] == got[1] == (j_logging.LOG_FORMAT, j_logging.LOG_DATE_FORMAT, logging.WARNING)

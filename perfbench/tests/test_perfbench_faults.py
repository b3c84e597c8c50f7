"""Each inference cell's comparison, driven on the CPU at a tiny size with
the timed path broken underneath, sees ``correct`` come out false; and its
control (the int8 body) reads above the program on the same seed."""

import pytest

from perfbench import harness

drop_rows = harness.driver("batch_dir").drop_rows

BATCH = "r18-batch-mixed"


def altered(out):
    """An answer altered where it is produced: every row's class flipped."""
    out = out.clone()
    out[..., 2] = 1.0 - out[..., 2]
    return out


def half_batch(out):
    """Half of the batch left out: the second half's windows answer nothing."""
    out = out.clone()
    out[out.shape[0] // 2:, :, 5] = 0.0
    return out


def times_shifted(out):
    """Every row's times 0.05 s late."""
    out = out.clone()
    out[..., 3] += 0.05
    return out


def test_sound_batch_run_is_correct(tiny_ctx):
    ok, checks = harness.judge(harness.driver("batch_dir").run(tiny_ctx(BATCH)))
    assert ok, checks


@pytest.mark.parametrize("fault, check, seed", [(altered, "conf_gap_rel", 5),
                                                (half_batch, "empty_windows", 5),
                                                (drop_rows, "nms_wrong_pct", 3),
                                                (times_shifted, "time_gap_rel", 5)],
                         ids=["answer_altered", "half_batch", "rows_dropped", "times_shifted"])
def test_batch_fault_is_caught(tiny_ctx, fault, check, seed):
    """Each on the weights and audio of ``seed``. Rows are dropped on a seed
    whose tiny windows hold more than one row each (seed 5's hold one or
    two, and every other row is then few)."""
    ctx = tiny_ctx(BATCH, seed=seed, weights_seed=seed)
    ok, checks = harness.judge(harness.driver("batch_dir").run(ctx, wrap=fault))
    assert not ok and checks[check]["value"] > checks[check]["limit"], checks


@pytest.mark.parametrize("iou, conf, cell_conf", [(1.0, None, None), (None, 0.0, 0.4)],
                         ids=["nms_skipped", "threshold_ignored"])
def test_nms_fault_is_caught(tiny_ctx, monkeypatch, iou, conf, cell_conf):
    """The program's kernel 2 given thresholds that suppress nothing (IoU
    1.0) or pass every proposal (confidence 0), the reference the cell's.
    At this size no proposal under 0.2 outlives NMS, so the second fault
    runs a cell whose threshold is 0.4, which half the rows pass."""
    from audioyolo_tpu_torch import inference_cli

    build = inference_cli.build_worker
    monkeypatch.setattr(inference_cli, "build_worker",
                        lambda cfg, path, cmap, i, c, **kw: build(
                            cfg, path, cmap, i if iou is None else iou,
                            c if conf is None else conf, **kw))
    ctx = tiny_ctx(BATCH)
    if cell_conf is not None:
        ctx.mix["conf_threshold"] = cell_conf
    ok, checks = harness.judge(harness.driver("batch_dir").run(ctx))
    assert not ok and checks["nms_wrong_pct"]["value"] > checks["nms_wrong_pct"]["limit"], checks


def test_sound_run_at_the_higher_threshold_is_correct(tiny_ctx):
    ctx = tiny_ctx(BATCH)
    ctx.mix["conf_threshold"] = 0.4
    ok, checks = harness.judge(harness.driver("batch_dir").run(ctx))
    assert ok, checks


def test_csv_writer_fault_is_caught(tiny_ctx, monkeypatch):
    """A CSV that does not say what the rows say (the RLE merge skipped)."""
    from audioyolo_tpu_torch.infer import streaming

    monkeypatch.setattr(streaming, "rle_merge", lambda rows: [dict(r) for r in rows])
    ok, checks = harness.judge(harness.driver("batch_dir").run(tiny_ctx(BATCH)))
    assert not ok and checks["csv_mismatch"]["value"] > 0, checks


def test_batch_control_reads_above_the_program(tiny_ctx):
    drv = harness.driver("batch_dir")
    sound = drv.readings(tiny_ctx(BATCH, seed=11))
    control = drv.readings(tiny_ctx(BATCH, seed=11), control="int8_transfer")
    for k in ("conf_gap_rel", "time_gap_rel"):
        assert control[k] > 2.0 * sound[k], (k, sound, control)


@pytest.mark.parametrize("fault", ["nms_off", "rows_dropped"])
def test_planted_nms_faults_read_above_the_program(tiny_ctx, fault):
    """The faults the calibration plants in the program's NMS read far
    above the sound program's ``nms_wrong_pct``, which reads as the
    yardstick's own. On the weights and audio of seed 12, whose tiny
    windows hold rows enough for every other one to count."""
    drv = harness.driver("batch_dir")
    sound = drv.readings(tiny_ctx(BATCH, seed=12, weights_seed=12))
    bad = drv.readings(tiny_ctx(BATCH, seed=12, weights_seed=12), control=fault)
    assert sound["nms_wrong_pct"] <= sound["yard_nms_wrong_pct"] + 1.0, sound
    assert bad["nms_wrong_pct"] > 10.0 + sound["nms_wrong_pct"], (sound, bad)

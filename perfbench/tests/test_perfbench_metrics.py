"""The metric arithmetic on a synthetic profile, against hand-worked values."""

import types

import pytest

from perfbench import harness, metrics_common, trace
from perfbench.count import mel_kernel, peaks


def ev(name, kind, start_us, end_us, tid=1):
    """A kineto event as this torch gives it: the device it ran on, and
    the harness's spans by name."""
    import torch

    on = torch.autograd.DeviceType
    device = on.CUDA if kind in trace.DEVICE_ACTIVITIES + ("gpu_user_annotation",) else on.CPU
    return types.SimpleNamespace(
        name=lambda: name, device_type=lambda: device, start_ns=lambda: start_us * 1000,
        end_ns=lambda: end_us * 1000, start_thread_id=lambda: tid)


EVENTS = [
    ev("pb.slice", "user_annotation", 0, 1000),
    ev("pb.batch_dir.infer_fn", "user_annotation", 100, 450),
    ev("aten::copy_", "cpu_op", 600, 900, tid=2),
    ev("stage_frames_kernel<float>", "kernel", 100, 150),
    ev("mel_power_kernel", "kernel", 150, 250),
    ev("mel_power_kernel", "kernel", 200, 300),   # overlaps the one before
    ev("Memcpy HtoD", "gpu_memcpy", 500, 550),
    ev("other", "kernel", 1200, 1300),            # outside the slice
]


def test_reduce_busy_idle_and_gaps():
    s = trace.reduce(EVENTS)
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx(250e-6)          # 100-300 and 500-550
    assert metrics_common.idle_pct(s, {}) == pytest.approx(75.0)
    assert s["kernels"]["mel_power_kernel"] == [pytest.approx(200e-6), 2]
    gaps = s["idle_gaps"]
    assert gaps[0][1] == pytest.approx(450e-6) and "aten::copy_" in gaps[0][0]  # 550-1000
    assert gaps[1][1] == pytest.approx(200e-6) and gaps[1][0].startswith("pb.batch_dir.infer_fn")
    assert [round(g[1] * 1e6) for g in gaps] == [450, 200, 100]


def test_device_twins_of_spans_are_annotations():
    """A program span's device twin adds no busy time, no kernel and no
    gap; ``device_spans`` holds the device's work inside it (100-300 and
    500-550 clipped to 120-520: 180 + 20 us), not its length. A harness
    span's twin counts for nothing, as before."""
    base = trace.reduce(EVENTS)
    assert base["device_spans"] == {}
    twins = [ev("ayt.model.stage1", "gpu_user_annotation", 120, 520),
             ev("ayt.model.stage1", "gpu_user_annotation", 560, 700),   # nothing ran
             ev("ayt.model.stage2", "gpu_user_annotation", 0, 1000),
             ev("pb.batch_dir.infer_fn", "gpu_user_annotation", 100, 450)]
    s = trace.reduce(EVENTS + twins)
    for key in ("window_s", "busy_s", "kernels", "spans", "idle_gaps"):
        assert s[key] == base[key], key
    assert trace.breakdown(s) == trace.breakdown(base)
    assert s["device_spans"]["ayt.model.stage1"] == [pytest.approx(200e-6), 2]
    assert s["device_spans"]["ayt.model.stage2"] == [pytest.approx(250e-6), 1]
    assert set(s["device_spans"]) == {"ayt.model.stage1", "ayt.model.stage2"}


def test_kernel1_roofline_and_mfu():
    s = trace.reduce(EVENTS)
    facts = {"kernel1": ("stage_frames_kernel", "mel_power_kernel"), "mel_bound_s": 25e-6,
             "flops": 0.5 * peaks.BF16_FLOPS * 1e-3}
    # (50 + 200) us of kernel 1 over 2 launches: 125 us a launch
    assert metrics_common.kernel1_roofline_pct(s, facts) == pytest.approx(20.0)
    assert metrics_common.mfu_pct(s, facts) == pytest.approx(50.0)
    assert metrics_common.kernel1_roofline_pct(s, {"kernel1": ("nothing",), "mel_bound_s": 1}) is None


def test_mel_kernel_count_by_hand():
    b = mel_kernel.bound(frames=10, frame_len=4, n_freq=3, n_mels=2, in_bytes=4)
    assert b["flops"] == 2 * 10 * 4 * 6 + 3 * 10 * 3 + 2 * 10 * 3 * 2
    assert b["bytes"] == 10 * 4 * 4 + 10 * 2 * 4 + 4 * 6 * 2 + 3 * 2 * 2
    assert b["bound_by"] == "bytes"


def test_readers_found_for_every_per_layer_metric():
    import json
    import os

    with open(os.path.join(harness.HERE, os.pardir, "BENCHMARK.json")) as f:
        bench = json.load(f)
    s = trace.reduce(EVENTS)
    for m in bench["per_layer"]:
        value = harness.metric_reader(m["name"]).read(s, {"p50_ms": 3.0, "flops": 1.0,
                                                        "kernel1": ("mel_power_kernel",),
                                                        "mel_bound_s": 1e-6})
        assert value is None or value >= 0


def test_card_profile_counts_operations_not_span_twins():
    """The whole window's card profile: the union of the device's
    operations (100-300 and 500-550, and 1200-1300, which a profile of the
    card alone holds too), launches by name; span twins and host events
    count for nothing."""
    twins = [ev("ayt.stream.read", "gpu_user_annotation", 0, 2000),
             ev("pb.batch_dir.infer_fn", "gpu_user_annotation", 100, 450)]
    got = trace.card(EVENTS + twins)
    assert got["busy_s"] == pytest.approx(350e-6)
    assert got["counts"] == {"stage_frames_kernel<float>": 1, "mel_power_kernel": 2,
                             "Memcpy HtoD": 1, "other": 1}


@pytest.mark.parametrize("launches, batches", [(12, 12), (11, 12)])
def test_card_busy_per_audio_hour_and_dropped_operations(launches, batches):
    """Busy seconds over the audio-hours of the window; a profile that
    holds fewer launches of kernel 1 than the window ran batches stops
    the run instead of reading low."""
    drv = harness.driver("batch_dir")
    ctx = types.SimpleNamespace(tracer=types.SimpleNamespace(card_summary={
        "busy_s": 3.0, "counts": {"void mel_power_kernel<32>": launches, "other": 99}}))
    passes = [[None] * 6, [None] * (batches - 6)]
    if launches == batches:
        assert drv.card_busy(ctx, passes, 0.5) == {"card_busy_s_per_audio_h": 6.0}
    else:
        with pytest.raises(RuntimeError, match="11 launches"):
            drv.card_busy(ctx, passes, 0.5)
    ctx.tracer.card_summary = None
    assert drv.card_busy(ctx, passes, 0.5) == {}

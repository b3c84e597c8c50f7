"""The frontend's readers on a synthetic trace, against hand-worked values;
None where the program has no frontend span or no resampling staging
kernel, as a program before them."""

import pytest

from perfbench import harness, program_spans

DRAINS = {program_spans.DRAIN: {"count": 8, "total_s": 0.08, "self_s": 0.08}}
KERNELS = {
    "void (anonymous namespace)::stage_frames_kernel_resample<short>(short const*, ...)":
        [0.0004, 8],
    "(anonymous namespace)::mel_power_kernel(CUtensorMap, ...)": [0.0016, 8],
    "void (anonymous namespace)::stage_frames_kernel<float>(float const*, ...)": [0.0006, 2],
    "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8": [0.006, 8],
}
TRACE = {"busy_s": 0.05, "window_s": 2.0, "kernels": KERNELS,
         "device_spans": {"ayt.model.frontend": [0.0032, 8], "ayt.model.backbone": [0.012, 8]}}


@pytest.mark.parametrize("metric, trace, want", [
    ("frontend_ms_per_batch.batch", TRACE, 1e3 * 0.0032 / 8),
    ("resample_staged_pct.batch", TRACE, 100.0),
    ("resample_staged_pct.batch",
     dict(TRACE, kernels=dict(KERNELS, **{"(anonymous namespace)::mel_power_kernel(x)": [0.0, 2]})),
     80.0),
])
def test_frontend_readers(metric, trace, want, monkeypatch):
    monkeypatch.setattr(program_spans, "program_totals", lambda: dict(DRAINS))
    assert harness.metric_reader(metric).read(trace, {}) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["frontend_ms_per_batch.batch", "resample_staged_pct.batch"])
def test_frontend_readers_of_a_program_without_them(metric, monkeypatch):
    """The parent's trace: no frontend span, the staging kernel without
    resampling and the resampler's GEMM."""
    monkeypatch.setattr(program_spans, "program_totals", lambda: dict(DRAINS))
    kernels = {k: v for k, v in KERNELS.items() if "resample" not in k}
    old = dict(TRACE, kernels=kernels, device_spans={"ayt.model.backbone": [0.012, 8]})
    assert harness.metric_reader(metric).read(old, {}) is None
    monkeypatch.setattr(program_spans, "program_totals", dict)
    assert harness.metric_reader(metric).read(dict(old, kernels={}), {}) is None

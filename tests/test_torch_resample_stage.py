"""Kernel 1's resampling staging pass (``ops/mel_kernel.py::ResampleStage``,
``stage_frames_kernel_resample`` in ``csrc/fused_mel_power.cu``).

On the CPU: the bank's nonzero taps and their window layout, the plain
version against the chain it replaces (``Resampler`` -> ``frame_signal`` ->
``stage_frames_plain``), the routing of ``SpectralFrontend.forward`` and the
branch's features. Tests marked ``card`` hold the kernel to the same chain
on the card and skip without one; on the card run them with
``python -m pytest --noconftest tests/test_torch_resample_stage.py -m card``
(this file imports no JAX and uses none of ``conftest.py``'s fixtures)."""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from audioyolo_tpu_torch.config import Config, load_config
from audioyolo_tpu_torch.ops import frontend as tfe
from audioyolo_tpu_torch.ops import fused_frontend
from audioyolo_tpu_torch.ops import mel_kernel as mk
from audioyolo_tpu_torch.ops.resample import (Resampler, polyphase_taps, sinc_resample_kernel,
                                              window_bank)

PAIRS = (22050, 44100, 48000)
# nonzero taps a phase (fewest, most) of each rate pair's bank at 16 kHz
NONZERO = {22050: (16, 17), 44100: (33, 34), 48000: (37, 37)}
# input samples a run of 8 outputs reads (the window bank's U), rounded up to 4
WINDOW = {22050: 28, 44100: 56, 48000: 60}
N_FFT, FP = 1000, 1024


def _stage(orig: int) -> tuple:
    r = Resampler(orig, 16000)
    return r, mk.ResampleStage(r.kernel[:, 0].numpy(), r.width, r.q, r.p, N_FFT, FP)


def _wave(orig: int, seconds: float, dtype: str, b: int = 2, seed: int = 3,
          device: str = "cpu") -> torch.Tensor:
    """(b, 1, S) full-scale noise at ``orig`` Hz, S = orig * seconds + 3 (a
    partial resampler block and a partial last frame unless whole)."""
    s = int(orig * seconds) + (0 if float(seconds).is_integer() else 3)
    rng = np.random.default_rng([seed, orig, s])
    if dtype == "int16":
        x = rng.integers(-32768, 32768, (b, 1, s)).astype(np.int16)
    else:
        x = (rng.standard_normal((b, 1, s)) * 0.3).astype(np.float32)
    return torch.from_numpy(x).to(device)


def _chain(r: Resampler, wave: torch.Tensor) -> torch.Tensor:
    """Today's waveform path before the main pass, in float32: the dequant,
    the resampler's GEMMs, the frames."""
    x = wave[:, 0]
    x = x.float() * (1.0 / 32768.0) if x.dtype == torch.int16 else x
    return tfe.frame_signal(r(x), N_FFT, N_FFT, False, "reflect")


def _ordered(t: torch.Tensor) -> torch.Tensor:
    i = t.view(torch.int16).int()
    return torch.where(i < 0, -(i & 0x7FFF), i)


def _ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 units in the last place between two bf16 tensors."""
    return (_ordered(a) - _ordered(b)).abs()


def _explained(got: torch.Tensor, ref: torch.Tensor, gap: float) -> torch.Tensor:
    """Whether each bf16 value of ``got`` is the rounding of a float32 value
    within ``gap`` of ``ref``'s: a sum of the same products in another order
    (near zero, where the sum cancels, that is several bf16 steps)."""
    _, e = torch.frexp(got.float())
    half = torch.where(got == 0, torch.zeros_like(got.float()), torch.ldexp(torch.ones_like(
        got.float()), e - 9))
    return (got.double() - ref.double()).abs() <= gap + half.double()


@pytest.mark.parametrize("orig", PAIRS)
def test_compact_bank_drops_only_exact_zeros(orig):
    """``polyphase_taps`` keeps each phase's taps from its first nonzero to its
    last (16-17 of 459 at 22,050 Hz); every entry it drops is exactly 0.0 in
    float32. ``window_bank`` lays each phase's taps out whole at its offset,
    exact zeros elsewhere."""
    kernel, width = sinc_resample_kernel(orig, 16000)
    taps, first = polyphase_taps(kernel)
    nz = (kernel != 0).sum(axis=1)
    assert (nz.min(), nz.max()) == NONZERO[orig] and taps.shape[1] == NONZERO[orig][1]
    if orig == 22050:
        assert kernel.shape == (320, 459) and width == 9
    rebuilt = np.zeros_like(kernel)
    for j in range(kernel.shape[0]):
        n = min(taps.shape[1], kernel.shape[1] - first[j])
        rebuilt[j, first[j]: first[j] + n] = taps[j, :n]
        assert not taps[j, n:].any()
    np.testing.assert_array_equal(rebuilt, kernel)  # the dropped entries are +0.0 or -0.0
    kept = np.zeros(kernel.shape, bool)
    for j in range(kernel.shape[0]):
        kept[j, first[j]: first[j] + taps.shape[1]] = True
    assert (kernel[~kept] == 0).all()
    r = Resampler(orig, 16000)
    wbank, wstart = window_bank(taps, first, r.q, r.p)
    row = 8 * wbank.shape[0]
    assert row % r.p == 0 and wbank.shape[2] == WINDOW[orig]
    n = np.arange(row)
    s = (n // r.p) * r.q + first[n % r.p]
    for run in range(wbank.shape[0]):
        assert wstart[run] == s[8 * run]
        for e in range(8):
            d = s[8 * run + e] - s[8 * run]
            want = np.zeros(wbank.shape[2], np.float32)
            want[d: d + taps.shape[1]] = taps[(8 * run + e) % r.p]
            np.testing.assert_array_equal(wbank[run, e], want)


@pytest.mark.parametrize("dtype", ["int16", "float32"])
@pytest.mark.parametrize("orig, seconds, b", [(22050, 60, 1), (22050, 7.3, 2), (44100, 3.3, 2),
                                              (48000, 3.3, 2)],
                         ids=["22050-60s", "22050-partial", "44100-partial", "48000-partial"])
def test_plain_stage_matches_resampler_chain(orig, seconds, b, dtype):
    """The plain version against ``Resampler`` -> ``frame_signal`` ->
    ``stage_frames_plain`` (48 kHz: the resampler's strided-conv branch), on
    the shipped 60 s and on lengths with a partial last block and frame:
    float32 within 1e-6 of the signal's peak before rounding; the bf16
    scratch equal but where the rounding of a float32 value within that gap
    of the chain's explains it."""
    r, stage = _stage(orig)
    wave = _wave(orig, seconds, dtype, b=b)
    ref = _chain(r, wave)
    got = mk.resample_frames_plain(wave, stage.bank(wave.dtype), stage.wstart, r.q, r.p, r.width, N_FFT)
    assert got.shape == ref.shape and stage.frames(wave.shape[-1]) == ref.shape[1]
    gap = (got - ref).abs().max().item()
    assert gap <= 1e-6 * ref.abs().max().item()
    a = mk.stage_frames_resample_plain(wave, stage.bank(wave.dtype), stage.wstart, r.q, r.p, r.width,
                                       N_FFT, FP)
    b = mk.stage_frames_plain(ref[:, None].contiguous(), FP)
    assert a.shape == b.shape == (1, wave.shape[0] * ref.shape[1], FP)
    assert not a[..., N_FFT:].float().any()
    off = a != b
    assert off.float().mean().item() <= 1e-4
    assert _explained(a[off], F.pad(ref, (0, FP - N_FFT)).reshape(1, -1, FP)[off], gap).all()


@pytest.fixture(autouse=True)
def _no_framed_path(monkeypatch):
    """The waveform path these tests drive needs none of the framed path's
    composed matrices, which take ~10 s to build: their builder reports the
    framed path unavailable here."""
    def unavailable(*args, **kwargs):
        raise ValueError("the framed path is not built in these tests")

    monkeypatch.setattr(fused_frontend, "get_fused_frame_dft", unavailable)


def _frontend(raw: dict) -> tfe.SpectralFrontend:
    return tfe.SpectralFrontend(Config(copy.deepcopy(raw)))


def _kernel_raw(**mel) -> dict:
    raw = copy.deepcopy(load_config("config/config.yaml").raw)
    raw.setdefault("tpu_config", {}).update(frontend_precision="default", pallas_frontend="on")
    for m in (raw["melspectrogram_config"], raw["mfcc_config"]["melkwargs"]):
        m.update(mel)
    return raw


def _highest_raw() -> dict:
    raw = _kernel_raw()
    raw["tpu_config"]["frontend_precision"] = "highest"
    return raw


def _close_to_the_old_chain(new, old, highest) -> None:
    """The kernel branch's image against today's, within a twentieth of the
    posture's own gap to the float32 frontend, at most and on average."""
    gap, own = (new - old).abs(), (old - highest).abs()
    assert gap.max().item() <= own.max().item() / 20, (gap.max().item(), own.max().item())
    assert gap.mean().item() <= own.mean().item() / 20, (gap.mean().item(), own.mean().item())


def _raw_case(case: str) -> dict:
    raw = _kernel_raw()
    if case in ("highest", "high"):
        raw["tpu_config"]["frontend_precision"] = case
    elif case == "overlapping":
        raw = _kernel_raw(hop_length=500)
    elif case == "centered":
        raw = _kernel_raw(center=True)
    elif case == "equal_rates":
        raw["sample_rate"] = raw["new_sample_rate"]
    elif case == "window_over_bound":
        raw["sample_rate"] = 96000  # 73 taps a phase, a window of 116 samples
    elif case == "taper":
        raw["taper_input"] = True
    return raw


@pytest.mark.parametrize("case", ["highest", "high", "overlapping", "centered", "equal_rates",
                                  "window_over_bound", "taper", "cpu_tensor"])
def test_routing_keeps_todays_path(case, monkeypatch):
    """Only kernel 1 on the card, at another rate than the model's, with
    non-overlapping frames and no taper, resamples in its staging pass:
    every other case builds no ``ResampleStage`` and runs the resampler, and
    a CPU tensor runs it though the stage exists. A window over the kernel's
    bound builds the stage, and the kernel's launcher turns it down on the
    card (``test_card_routing_asks_the_kernel``)."""
    fe = _frontend(_raw_case(case))
    if case == "cpu_tensor":
        assert tuple(fe.resample_stage.wbank.shape) == (40, 8, 28)
        assert torch.equal(fe.resample_stage.wbank_i16 * 32768, fe.resample_stage.wbank)
    elif case == "window_over_bound":
        assert fe.resample_stage.wbank.shape[-1] == 116
    else:
        assert fe.resample_stage is None
    calls = []
    monkeypatch.setattr(mk.ResampleStage, "forward", lambda self, w: calls.append(w))
    seen = []
    real = Resampler.forward
    monkeypatch.setattr(Resampler, "forward", lambda self, x: seen.append(1) or real(self, x))
    wave = _wave(fe.sr_in, 60 if case == "taper" else 2, "int16", b=1)
    with torch.no_grad():
        fe(wave)
    assert calls == [] and seen == [1]
    assert not fe._kernel_resamples(wave[:, 0])


@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_kernel_branch_features_match_todays_path(dtype, monkeypatch):
    """The branch the card takes, run here on the op's CPU registration (the
    plain version): the feature image of a 60 s clip against today's
    path. The staged bf16 frames differ only at rounding boundaries
    (``test_plain_stage_matches_resampler_chain``): a few pixels move (by up
    to 3.0e-3 here, a sample one bf16 step off in a quiet band), the rest by
    float32 noise; held to a twentieth of what kernel 1's bf16 rounding
    itself moves the image against the float32 frontend (1.41-1.47 at most,
    2.4e-3-2.6e-3 on average), at most and on average."""
    fe = _frontend(_kernel_raw())
    wave = _wave(fe.sr_in, 60, dtype, b=1)
    with torch.no_grad():
        old, highest = fe(wave), _frontend(_highest_raw())(wave)
        monkeypatch.setattr(tfe.SpectralFrontend, "_kernel_resamples", lambda self, a: True)
        new = fe(wave)
    assert new.shape == old.shape == (1, 32, 960, 2)
    _close_to_the_old_chain(new, old, highest)


def test_op_registrations_agree():
    """``torch.library.opcheck``: the schema, the fake's shape and dtype
    against the CPU registration, and its dispatch."""
    r, stage = _stage(22050)
    for wave in (_wave(22050, 0.25, "int16", b=2), _wave(22050, 0.2, "float32", b=1)[:, 0]):
        torch.library.opcheck(torch.ops.audioyolo_tpu_torch.stage_frames_resample.default,
                              (wave, stage.bank(wave.dtype), stage.wstart, r.q, r.p, r.width, N_FFT, FP))


# ------------------------------------------------------------------ card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _card_stage(orig: int, dev) -> tuple:
    r, stage = _stage(orig)
    return r.to(dev), stage.to(dev)


@pytest.mark.card
@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_card_stage_matches_the_chain_it_replaces(card, dtype):
    """B = 32 clips of 60 s at 22,050 Hz: the kernel's bf16 scratch against
    the resampler's float32 GEMMs and the staging kernel, equal in at least
    99.99 % of elements; elsewhere the rounding of a float32 value within
    1e-6 of the signal's peak of the chain's (the float32 bound of
    ``test_plain_stage_matches_resampler_chain``)."""
    r, stage = _card_stage(22050, card)
    wave = _wave(22050, 60, dtype, b=32, device=card)
    got = stage(wave)
    frames = _chain(r, wave)
    want = mk.stage_frames(frames[:, None].contiguous(), FP)
    torch.cuda.synchronize()
    off = got != want
    assert got.shape == want.shape and off.float().mean().item() <= 1e-4
    padded = F.pad(frames, (0, FP - N_FFT)).reshape(1, -1, FP)
    assert _explained(got[off], padded[off], 1e-6 * frames.abs().max().item()).all()


@pytest.mark.card
@pytest.mark.parametrize("orig", PAIRS)
@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_card_kernel_repeats_the_plain_version(card, orig, dtype):
    """The kernel against its plain version on the same card: 3 clips of a
    partial length, read from a pointer off 16 bytes; equal but for a rare
    float64 double rounding of the plain version's FMA, one bf16 step."""
    r, stage = _card_stage(orig, card)
    wave = _wave(orig, 7.3, dtype, b=3, device=card)
    flat = torch.empty(wave.numel() + 1, dtype=wave.dtype, device=card)
    odd = flat[1:].view(wave.shape)
    odd.copy_(wave)
    assert odd.data_ptr() % 16 != 0
    launches = mk.stage_frames_resample.launches
    got = stage(odd)
    want = mk.stage_frames_resample_plain(wave, stage.bank(wave.dtype), stage.wstart, r.q, r.p, r.width,
                                          N_FFT, FP)
    torch.cuda.synchronize()
    assert mk.stage_frames_resample.launches == launches + 1
    off = got != want
    assert off.float().mean().item() <= 1e-6
    assert not off.any() or _ulps(got[off], want[off]).max().item() <= 1


@pytest.mark.card
@pytest.mark.parametrize("orig", PAIRS + (96000,))
def test_card_routing_asks_the_kernel(card, orig, monkeypatch):
    """The kernel's launcher decides which rate pairs it takes: the three
    shipped ones, not 96 kHz (a window of 116 samples); a frontend at a rate
    it turns down runs the resampler on the card, and at one it takes, the
    staging pass alone."""
    raw = _kernel_raw()
    raw["sample_rate"] = orig
    fe = _frontend(raw).to(card)
    assert fe.resample_stage.fits() == (orig != 96000)
    seen = []
    real = Resampler.forward
    monkeypatch.setattr(Resampler, "forward", lambda self, x: seen.append(1) or real(self, x))
    launches = mk.stage_frames_resample.launches
    with torch.no_grad():
        fe(_wave(orig, 2, "int16", b=1, device=card))
    torch.cuda.synchronize()
    took = orig != 96000
    assert seen == ([] if took else [1])
    assert mk.stage_frames_resample.launches == launches + took


@pytest.mark.card
def test_card_frontend_features_match_the_old_chain(card, monkeypatch):
    """The whole frontend on the card, the kernel branch against today's path
    (the resampler's GEMMs, then kernel 1) on the same 32 int16 clips, as
    ``test_kernel_branch_features_match_todays_path`` holds them."""
    fe = _frontend(_kernel_raw()).to(card)
    wave = _wave(fe.sr_in, 60, "int16", b=32, device=card)
    with torch.no_grad():
        launches = mk.stage_frames_resample.launches
        new = fe(wave)
        assert mk.stage_frames_resample.launches == launches + 1
        highest = _frontend(_highest_raw()).to(card)(wave)
        monkeypatch.setattr(tfe.SpectralFrontend, "_kernel_resamples", lambda self, a: False)
        old = fe(wave)
    _close_to_the_old_chain(new, old, highest)


@pytest.mark.card
def test_card_stage_replays_in_a_cuda_graph(card):
    """The op captures into a CUDA graph; a replay on new input equals an
    eager call on it."""
    r, stage = _card_stage(22050, card)
    static = _wave(22050, 60, "int16", b=4, device=card)
    stage(static)  # builds and loads the kernel outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = stage(static)
    static.copy_(_wave(22050, 60, "int16", b=4, seed=9, device=card))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, stage(static))


@pytest.mark.card
def test_card_export_round_trip(card, tmp_path):
    """The model with the kernel branch, exported on the card and loaded back:
    its program holds the op and gives the live function's output."""
    from audioyolo_tpu_torch.infer.decode import make_inference_fn
    from audioyolo_tpu_torch.infer.export import (build_serving_exported, load_serving_artifact,
                                                  save_serving_artifact)
    from audioyolo_tpu_torch.models import AudioDetectionModel

    raw = _kernel_raw()
    raw["block_layers"] = [1, 1, 1, 1]
    model = AudioDetectionModel.from_config(Config(raw), 2, deploy=True)
    sd = model.state_dict()
    programs = build_serving_exported(model, sd, 2, input_dtype="int16", platforms=("cuda",))
    ops = {str(n.target) for n in programs["cuda"].graph.nodes if n.op == "call_function"}
    assert "audioyolo_tpu_torch.stage_frames_resample.default" in ops
    path = str(tmp_path / "m.aytx")
    save_serving_artifact(path, programs, idx2class_map={0: "alarm", 1: "music"},
                          sample_duration=float(model.cfg.sample_duration),
                          input_sample_rate=int(model.cfg.sample_rate))
    fn, _ = load_serving_artifact(path, device=card)
    wave = _wave(22050, 60, "int16", b=2, device=card)
    live = make_inference_fn(model, sd, device=card)
    with torch.no_grad():
        got = fn.program(wave)
        want = live(wave)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)

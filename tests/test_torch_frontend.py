"""The PyTorch port's frontend against the JAX package's, on the CPU.

Host constants must be bit-equal; the feature image must match
``SpectralFrontend.__call__`` at ``frontend_precision: highest`` within the
bounds of ``tests/test_fused_frontend.py::_compare_images``; and kernel 1's
plain version must match the Pallas kernel run in interpret mode."""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audioyolo_tpu.config import Config as JConfig, load_config as jload_config
from audioyolo_tpu.ops import frontend as jfe
from audioyolo_tpu.ops import resample as jrs
from audioyolo_tpu.ops.fused_frontend import get_fused_frame_dft as jfused
from audioyolo_tpu.ops.pallas_frontend import PallasMelFrontend

from audioyolo_tpu_torch.config import Config, load_config
from audioyolo_tpu_torch.ops import frontend as tfe
from audioyolo_tpu_torch.ops import resample as trs
from audioyolo_tpu_torch.ops.fused_frontend import get_fused_frame_dft as tfused
from audioyolo_tpu_torch.ops.mel_kernel import (MelKernelFrontend, fused_mel_power_plain,
                                               stage_frames_plain)


@pytest.fixture(scope="module")
def full_raw():
    return jload_config("config/config.yaml").to_dict()


@pytest.fixture(scope="module")
def jax_full(full_raw):
    """The JAX frontend on the shipped config, and its Pallas constants."""
    jf = jfe.SpectralFrontend(JConfig(copy.deepcopy(full_raw)))
    return jf, PallasMelFrontend(jf.fused, jf.mel.mel_fb_np)


def test_window_and_dft_constants():
    for n in (1, 200, 1000):
        for periodic in (True, False):
            np.testing.assert_array_equal(tfe.hann_window(n, periodic), jfe.hann_window(n, periodic))
    for name in ("hann", "hamming", "blackman", "bartlett", "kaiser"):
        for periodic in (True, False):
            np.testing.assert_array_equal(tfe.taper_window(name, 64, periodic),
                                          jfe.taper_window(name, 64, periodic))
    w = jfe.hann_window(1000, True, np.float64)
    np.testing.assert_array_equal(tfe.dft_power_matrix(1000, w), jfe.dft_power_matrix(1000, w))


@pytest.mark.parametrize("scale", ["htk", "slaney"])
def test_mel_filterbank_constants(scale):
    for norm in ("slaney", None):
        for sr, nf in ((16000, 501), (8000, 101)):
            np.testing.assert_array_equal(
                tfe.mel_filterbank(nf, 32, sr, mel_scale=scale, norm=norm),
                jfe.mel_filterbank(nf, 32, sr, mel_scale=scale, norm=norm))


def test_dct_and_sinc_constants():
    for ortho in (True, False):
        np.testing.assert_array_equal(tfe.dct_matrix(32, 32, ortho), jfe.dct_matrix(32, 32, ortho))
    for pair in ((22050, 16000), (16000, 22050), (8000, 16000), (44100, 16000)):
        k_t, w_t = trs.sinc_resample_kernel(*pair)
        k_j, w_j = jrs.sinc_resample_kernel(*pair)
        assert w_t == w_j
        np.testing.assert_array_equal(k_t, k_j)


@pytest.mark.parametrize("pair", [(22050, 16000), (16000, 22050), (8000, 16000)])
def test_resampler_matches_jax(pair):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 1, 7 * pair[0] // 5)) * 0.1).astype(np.float32)
    ref = np.asarray(jrs.Resampler(*pair)(jnp.asarray(x)))
    out = trs.Resampler(*pair)(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("which", ["full", "tiny"])
def test_fused_frame_dft_constants(which, full_raw, tiny_cfg):
    raw = full_raw if which == "full" else tiny_cfg.to_dict()
    cfg = Config(raw)
    mel = raw["melspectrogram_config"]
    args = (cfg.sample_rate, cfg.new_sample_rate, mel["n_fft"], mel["hop_length"],
            mel["win_length"] or mel["n_fft"], cfg.n_frames)
    t, j = tfused(*args), jfused(*args)
    assert (t.n_ph, t.span, t.width, t.frame_len, t.n_groups) == \
        (j.n_ph, j.span, j.width, j.frame_len, j.n_groups)
    np.testing.assert_array_equal(t.offsets, j.offsets)
    np.testing.assert_array_equal(t.c, j.c)
    rng = np.random.default_rng(5)
    wav = (rng.standard_normal((2, cfg.clip_samples)) * 3000).astype(np.int16)
    for x in (wav, wav.astype(np.float32) / 32768.0):
        np.testing.assert_array_equal(t.frame_host(x), j.frame_host(x))


def test_mel_kernel_constants(jax_full):
    """K-major constants: C_r^T and [M; M]^T, bit-equal to the Pallas
    frontend's, transposed, and zero in the padding."""
    jf, pm = jax_full
    mk = MelKernelFrontend(jf.fused.c, jf.mel.mel_fb_np)
    r, f, k2 = jf.fused.c.shape
    assert tuple(mk.ct.shape) == (r, 1024, 1792) and tuple(mk.mel2t.shape) == (32, 1024)
    for ours, theirs in ((mk.ct, pm.c), (mk.ct_i16, pm.c_i16)):
        np.testing.assert_array_equal(ours[:, :k2, :f].transpose(1, 2).float().numpy(),
                                      np.asarray(theirs, np.float32))
        assert not ours[:, k2:].any() and not ours[:, :, f:].any()
    np.testing.assert_array_equal(mk.mel2t[:, :k2].t().float().numpy(), np.asarray(pm.mel2, np.float32))
    assert not mk.mel2t[:, k2:].any()


@pytest.mark.parametrize("case", ["int16_extremes", "float32", "ragged_b3", "waveform"])
def test_stage_frames_plain_layout(case):
    """The staging pass's plain version: ``framed.to(bf16)`` phase-major (R,
    B*G, Fp) and zero-padded, bit for bit (int16 extremes included)."""
    rng = np.random.default_rng(9)
    shape = {"int16_extremes": (2, 8, 5, 1782), "float32": (2, 8, 5, 1782),
             "ragged_b3": (3, 8, 7, 1782), "waveform": (2, 1, 9, 1000)}[case]
    if case == "float32" or case == "waveform":
        x = (rng.standard_normal(shape) * 0.3).astype(np.float32)
        x.flat[:4] = [1e-40, -0.0, 3.0e38, 1.00390625]  # subnormal, -0, large, a bf16 tie
    else:
        x = rng.integers(-32768, 32768, shape).astype(np.int16)
        x[..., :2] = [-32768, 32767]
    b, r, g, f = shape
    fp = -(-f // 64) * 64
    xs = stage_frames_plain(torch.from_numpy(x), fp)
    assert xs.dtype == torch.bfloat16 and tuple(xs.shape) == (r, b * g, fp)
    ref = torch.from_numpy(x).to(torch.bfloat16)
    for bi in range(b):
        for ri in range(r):
            rows = xs[ri, bi * g:(bi + 1) * g]
            assert torch.equal(rows[:, :f].view(torch.int16), ref[bi, ri].view(torch.int16))
            assert not rows[:, f:].float().any()
    if case == "int16_extremes":
        assert xs[0, 0, 0].item() == -32768.0 and xs[0, 0, 1].item() == 32768.0


def _images_close(ours, ref):
    """``_compare_images`` bounds: mel channel strict, MFCC channel strict away
    from the double-dB discontinuity."""
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours[..., 0], ref[..., 0], atol=1e-4, rtol=1e-4)
    d = np.abs(ours[..., 1] - ref[..., 1])
    assert (d > 1e-3).mean() < 2e-3, (d.max(), (d > 1e-3).mean())


@pytest.mark.parametrize("which", ["tiny", "full"])
def test_image_matches_jax_highest(which, full_raw, tiny_cfg):
    raw = full_raw if which == "full" else tiny_cfg.to_dict()
    jf = jfe.SpectralFrontend(JConfig(copy.deepcopy(raw)))
    tf = tfe.SpectralFrontend(Config(copy.deepcopy(raw)))
    assert tf.fused.n_ph == (8 if which == "full" else 1)
    b = 1 if which == "full" else 2
    rng = np.random.default_rng(6)
    wav = (rng.standard_normal((b, jf.cfg.clip_samples)) * 0.1).astype(np.float32)
    wav16 = np.clip(np.round(wav * 32768), -32768, 32767).astype(np.int16)
    for x in (wav, wav16):
        ref = np.asarray(jf(jnp.asarray(x)))
        with torch.no_grad():
            _images_close(tf(torch.from_numpy(x)).numpy(), ref)
            _images_close(tf(torch.from_numpy(tf.frame_host(x))).numpy(), ref)


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_plain_mel_matches_pallas_interpret(dtype, jax_full):
    """Full shapes, B=1. Both sides round x, C, spec^2 and [M; M] to bf16 at
    the same points; the bound is that of test_pallas_mel_kernel_matches_xla
    (rel < 2e-2 with a 1e-3 floor). Observed max rel ~8e-4: fp32 sums taken
    in another order flip the odd bf16 rounding of spec^2."""
    jf, pm = jax_full
    mk = MelKernelFrontend(jf.fused.c, jf.mel.mel_fb_np)
    rng = np.random.default_rng(7)
    wav = (rng.standard_normal((1, jf.cfg.clip_samples)) * 0.1).astype(np.float32)
    if dtype == "int16":
        wav = np.clip(np.round(wav * 32768), -32768, 32767).astype(np.int16)
    framed = jf.frame_host(wav)
    ref = np.asarray(pm(jnp.asarray(framed), interpret=True))
    with torch.no_grad():
        out = mk(torch.from_numpy(framed)).numpy()
        ct = mk.ct_i16 if dtype == "int16" else mk.ct
        np.testing.assert_array_equal(fused_mel_power_plain(torch.from_numpy(framed), ct, mk.mel2t).numpy(), out)
    assert out.shape == ref.shape == (1, 8, 120, 32)
    rel = np.abs(out - ref) / (np.abs(ref) + 1e-3)
    print(f"plain vs Pallas interpret ({dtype}): max rel {rel.max():.3e}")
    assert rel.max() < 2e-2, rel.max()


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_plain_mel_two_passes_match_direct_form(dtype):
    """Staging + K-major constants compute what the direct form (B, R, G, F) @
    C_r, squared, @ [M; M] computes, on a ragged batch: only the fp32
    summation order differs, which may flip the odd bf16 rounding of
    spec^2 (same bound as the Pallas comparison)."""
    rng = np.random.default_rng(10)
    b, r, g, f, nf = 3, 2, 5, 100, 51
    c = (rng.standard_normal((r, f, 2 * nf)) * 0.1).astype(np.float32)
    fb = rng.uniform(0, 1, (nf, 32)).astype(np.float32)
    mk = MelKernelFrontend(c, fb)
    assert tuple(mk.ct.shape) == (r, 256, 128) and tuple(mk.mel2t.shape) == (32, 256)
    x = rng.standard_normal((b, r, g, f)).astype(np.float32)
    if dtype == "int16":
        x = np.clip(np.round(x * 8000), -32768, 32767).astype(np.int16)
        c = c / np.float32(32768.0)
    framed = torch.from_numpy(x)
    with torch.no_grad():
        out = mk(framed)
        xb = framed.float().to(torch.bfloat16).float()
        spec = torch.matmul(xb, torch.from_numpy(c).to(torch.bfloat16).float().unsqueeze(0))
        sq = (spec * spec).to(torch.bfloat16).float()
        mel2 = torch.from_numpy(np.concatenate([fb, fb])).to(torch.bfloat16).float()
        ref = torch.matmul(sq, mel2)
    assert out.shape == ref.shape == (b, r, g, 32)
    rel = ((out - ref).abs() / (ref.abs() + 1e-3)).max().item()
    assert rel < 2e-2, rel


def _posture_raw(raw, prec, pallas="off"):
    raw = copy.deepcopy(raw)
    raw.setdefault("tpu_config", {}).update(frontend_precision=prec, pallas_frontend=pallas)
    return raw


def _posture_images(raw, prec, b, seed=6):
    """The port's and the JAX package's feature images of the same int16
    clips in posture ``prec``, waveform and framed, and JAX's ``highest``."""
    jf = jfe.SpectralFrontend(JConfig(_posture_raw(raw, prec)))
    tf = tfe.SpectralFrontend(Config(_posture_raw(raw, prec)))
    rng = np.random.default_rng(seed)
    wav = (rng.standard_normal((b, jf.cfg.clip_samples)) * 0.1).astype(np.float32)
    wav16 = np.clip(np.round(wav * 32768), -32768, 32767).astype(np.int16)
    j32 = np.asarray(jfe.SpectralFrontend(JConfig(copy.deepcopy(raw)))(jnp.asarray(wav16)))
    out = {}
    for name, x in (("wave", wav16), ("framed", tf.frame_host(wav16))):
        with torch.no_grad():
            out[name] = (tf(torch.from_numpy(x)).numpy(), np.asarray(jf(jnp.asarray(x))))
    return tf, jf, wav16, out, j32


def _bf16_images_close(ours, ref):
    """The bound of a posture whose GEMM operands the port rounds to bf16
    where JAX's CPU does not (it ignores ``Precision``): one bf16 rounding
    (relative 2^-9) of each DFT and mel operand moves the standardized
    image by 1.5e-3 to 3e-3 on average and by at most 3.8e-2 (observed on
    the tiny and the shipped config); the bound is about 3x that: mel
    channel max 0.1 and mean 1e-2, MFCC channel mean 1e-2 and 99th
    percentile 5e-2 (the second dB map of the MFCC image turns coefficients
    near 0 into O(1) pixels, so its maximum says nothing)."""
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    d = np.abs(ours - ref)
    assert d[..., 0].max() < 0.1 and d[..., 0].mean() < 1e-2, (d[..., 0].max(), d[..., 0].mean())
    assert d[..., 1].mean() < 1e-2 and np.percentile(d[..., 1], 99) < 5e-2


@pytest.mark.parametrize("prec", ["bf16", "int8", "high"])
def test_unported_postures_raise(prec, tiny_cfg):
    """The postures that raised before they were ported now run, on the
    waveform and on frames, each against its oracle:

    - ``high`` (three bf16 passes, ~16 bits per operand): JAX's ``highest``
      image at ``_images_close``'s float32 bounds (observed mel max 4e-5);
    - ``bf16`` and ``int8`` (one bf16 pass; ``bf16`` stores the framed
      spectrum in bf16): JAX's image in the same posture, which on the CPU
      runs its GEMMs in float32 on unrounded operands (``bf16``: its DFT on
      bf16 operands into a bf16 spectrum, as the port), at
      ``_bf16_images_close``. An unknown posture still raises."""
    raw = tiny_cfg.to_dict()
    tf, _, _, out, j32 = _posture_images(raw, prec, b=2)
    assert tf.precision == prec and not tf.use_kernel
    for ours, ref in out.values():
        if prec == "high":
            _images_close(ours, j32)
        else:
            _bf16_images_close(ours, ref)
    with pytest.raises(ValueError, match="unknown frontend_precision"):
        tfe.SpectralFrontend(Config(_posture_raw(raw, "fp8")))


@pytest.mark.parametrize("prec", ["default", "bf16", "int8", "high"])
def test_postures_at_full_width(prec, full_raw):
    """The shipped config (8 phases, frame_len 1782) at B=1, each posture
    against its oracle as ``test_unported_postures_raise`` states; without
    ``pallas_frontend: on`` the ``default`` posture runs the bf16 GEMMs."""
    tf, _, _, out, j32 = _posture_images(full_raw, prec, b=1)
    assert not tf.use_kernel
    for ours, ref in out.values():
        if prec == "high":
            _images_close(ours, j32)
        else:
            _bf16_images_close(ours, ref)


def test_posture_matmul_roundings():
    """``default``: the float64 product of the bf16-rounded operands (each
    bf16 product is exact in float32; the float32 sum of 300 terms adds at
    most ~300 * 2^-24 relative to sum |a||b|); ``high``: within 2^-15 of
    the float64 product relative to sum |a||b| (bf16 x 3 keeps ~16 bits of
    each operand); ``highest``: float32."""
    rng = np.random.default_rng(2)
    a = rng.standard_normal((3, 7, 300)).astype(np.float32)
    b = rng.standard_normal((300, 40)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    r = lambda t: t.to(torch.bfloat16).double().numpy()  # noqa: E731
    got = tfe.posture_matmul(ta, tb, "default").double().numpy()
    assert (np.abs(got - r(ta) @ r(tb)) / scale).max() < 1e-6
    assert (np.abs(got - exact) / scale).max() > 1e-4  # it did round to bf16
    got = tfe.posture_matmul(ta, tb, "high").double().numpy()
    assert (np.abs(got - exact) / scale).max() < 2 ** -15
    got = tfe.posture_matmul(ta, tb, "highest").double().numpy()
    assert (np.abs(got - exact) / scale).max() < 1e-6


def test_bf16_spectrum_matches_jax(full_raw):
    """The ``bf16`` posture's framed spectrum against JAX's
    ``FusedFrameDFT.__call__(storage_dtype=bfloat16)``, which on the CPU
    too rounds the frames and ``C`` to bf16 and stores the spectrum in bf16:
    the power agrees to two bf16 ulps of the spectrum (2 * 2^-8 * 2
    relative, for a float32 sum taken in another order landing on the other
    side of a rounding), relative to the frame's largest power."""
    jf = jfe.SpectralFrontend(JConfig(_posture_raw(full_raw, "bf16")))
    tf = tfe.SpectralFrontend(Config(_posture_raw(full_raw, "bf16")))
    rng = np.random.default_rng(4)
    wav = np.clip(rng.standard_normal((1, jf.cfg.clip_samples)) * 3000, -32768,
                  32767).astype(np.int16)
    framed = tf.frame_host(wav)
    ref = np.asarray(jf.fused(jnp.asarray(framed), reorder=False, storage_dtype=jnp.bfloat16))
    with torch.no_grad():
        ours = tf.fused(torch.from_numpy(framed), tf.fused_c, reorder=False,
                        storage_dtype=torch.bfloat16).numpy()
    rel = np.abs(ours - ref) / ref.max(axis=-1, keepdims=True)
    assert rel.max() < 2 * 2 ** -8 * 2, rel.max()
    assert (ours != ref).mean() < 0.05


def test_default_posture_runs_kernel_plain_version_on_cpu(tiny_cfg):
    """``default`` + ``pallas_frontend: on``: both the framed and the waveform
    path go through kernel 1's wrapper (its plain version on the CPU) and
    stay close to the float32 posture. Without the kernel the ``default``
    posture runs the bf16 GEMMs (``posture_matmul``), held to the kernel's
    plain version (the same bf16 operands; the kernel rounds re^2 and im^2
    apart, the GEMMs their sum) at ``_bf16_images_close``. With power 1 the
    kernel (power 2 only) gives way to the GEMMs, as JAX falls back to its
    GEMM pair."""
    raw = tiny_cfg.to_dict()
    raw["tpu_config"].update(frontend_precision="default", pallas_frontend="on")
    fe16 = tfe.SpectralFrontend(Config(raw))
    fe32 = tfe.SpectralFrontend(load_config(tiny_cfg.to_dict()))
    assert fe16.fused_kernel is not None and fe16.mel.kernel is not None
    rng = np.random.default_rng(8)
    wav = torch.from_numpy((rng.standard_normal((2, tiny_cfg.clip_samples)) * 0.1).astype(np.float32))
    with torch.no_grad():
        a, b = fe16(wav), fe32(wav)
        framed = fe16(torch.from_numpy(fe16.frame_host(wav.numpy())))
    assert torch.isfinite(a).all() and (a - b).abs().mean() < 0.05
    np.testing.assert_allclose(framed.numpy(), a.numpy(), atol=1e-5)
    raw["tpu_config"]["pallas_frontend"] = "off"
    gemm = tfe.SpectralFrontend(Config(copy.deepcopy(raw)))
    assert gemm.fused_kernel is None and gemm.mel.kernel is None and gemm.precision == "default"
    with torch.no_grad():
        _bf16_images_close(gemm(wav).numpy(), a.numpy())
        _bf16_images_close(gemm(torch.from_numpy(gemm.frame_host(wav.numpy()))).numpy(),
                           a.numpy())
    raw["tpu_config"]["pallas_frontend"] = "on"
    for mel in (raw["melspectrogram_config"], raw["mfcc_config"]["melkwargs"]):
        mel["power"] = 1
    p1 = tfe.SpectralFrontend(Config(raw))
    assert p1.fused_kernel is None and p1.mel.kernel is None and p1.precision == "default"
    with torch.no_grad():
        assert torch.isfinite(p1(wav)).all()


def test_kernel_posture_rejects_other_mel_widths(tiny_cfg):
    """Kernel 1 computes 32 mel bands; another width fails at construction,
    not at the first call on the card."""
    raw = tiny_cfg.to_dict()
    raw["tpu_config"].update(frontend_precision="default", pallas_frontend="on")
    raw["melspectrogram_config"]["n_mels"] = 16
    raw["mfcc_config"]["melkwargs"]["n_mels"] = 16
    with pytest.raises(ValueError, match="32 mel bands"):
        tfe.SpectralFrontend(Config(raw))


def test_kernel_posture_rejects_wide_spectra(tiny_cfg):
    """Kernel 1 keeps [M; M]^T (32 x 2F', padded to 1024) in shared memory;
    n_fft = 1024 (513 bins) fails at construction, not on the card."""
    raw = tiny_cfg.to_dict()
    raw["tpu_config"].update(frontend_precision="default", pallas_frontend="on")
    for mel in (raw["melspectrogram_config"], raw["mfcc_config"]["melkwargs"]):
        mel.update(n_fft=1024, hop_length=1024)
    with pytest.raises(ValueError, match="at most 512 frequency bins"):
        tfe.SpectralFrontend(Config(raw))

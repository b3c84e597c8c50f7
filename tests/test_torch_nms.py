"""The PyTorch port's NMS and decode against the JAX package's, on the CPU.

Keep flags must be bit-identical to ``_greedy_suppress_rows`` and to the
Pallas kernels in interpret mode; confidences agree to 1e-6 (sigmoid and
softmax are computed by two libraries)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audioyolo_tpu.infer.decode import detection_postprocess_graph as j_post
from audioyolo_tpu.infer.decode import pack_detections as j_pack
from audioyolo_tpu.ops.nms import _greedy_suppress_rows, batched_interval_nms as j_nms
from audioyolo_tpu.ops.nms import interval_iou_matrix as j_iou
from audioyolo_tpu.ops.pallas_nms import greedy_suppress_pallas, greedy_suppress_pallas_blocked

from audioyolo_tpu_torch.infer.decode import detection_postprocess_graph, pack_detections
from audioyolo_tpu_torch.ops import nms_kernel
from audioyolo_tpu_torch.ops.nms import batched_interval_nms, interval_iou_matrix
from audioyolo_tpu_torch.ops.nms_kernel import (greedy_suppress_rows, resolve_words_plain,
                                                suppression_words_plain)


def _intervals(rng, b, k):
    c = rng.uniform(0, 60, (b, k)).astype(np.float32)
    w = rng.uniform(0.2, 20, (b, k)).astype(np.float32)
    return np.clip(c - w / 2, 0, 60), np.clip(c + w / 2, 0, 60)


def _all_three(x1, x2, thr):
    ours = greedy_suppress_rows(torch.from_numpy(x1), torch.from_numpy(x2), thr).numpy()
    rows = np.asarray(_greedy_suppress_rows(jnp.asarray(x1), jnp.asarray(x2), thr))
    valid = jnp.ones(x1.shape, bool)
    pallas = np.asarray(greedy_suppress_pallas_blocked(
        jnp.asarray(x1), jnp.asarray(x2), valid, thr, interpret=True))
    return ours, rows, pallas


@pytest.mark.parametrize("thr", [0.1, 0.45])
@pytest.mark.parametrize("shape", [(2, 630), (3, 100)])
def test_plain_keep_bit_identical(shape, thr):
    x1, x2 = _intervals(np.random.default_rng(11), *shape)
    ours, rows, pallas = _all_three(x1, x2, thr)
    np.testing.assert_array_equal(ours, rows)
    np.testing.assert_array_equal(ours, pallas)
    assert 0 < ours.sum() < ours.size


def test_long_suppression_chain():
    """Each interval overlaps only its neighbour: greedy keeps the evens, the
    deepest dependency chain there is."""
    x1 = (np.arange(100, dtype=np.float32) * 0.6)[None, :]
    x2 = x1 + 1.0
    ours, rows, pallas = _all_three(x1, x2, 0.2)
    np.testing.assert_array_equal(ours, rows)
    np.testing.assert_array_equal(ours, pallas)
    assert ours[0, ::2].all() and not ours[0, 1::2].any()


def test_non_finite_bounds_match_jax():
    """NaN and infinite bounds: a NaN IoU suppresses nothing on either side."""
    rng = np.random.default_rng(16)
    x1, x2 = _intervals(rng, 2, 200)
    for arr, value in ((x1, np.nan), (x2, np.inf), (x1, -np.inf), (x2, np.nan)):
        arr[rng.random(arr.shape) < 0.05] = value
    ours = greedy_suppress_rows(torch.from_numpy(x1), torch.from_numpy(x2), 0.2).numpy()
    rows = np.asarray(_greedy_suppress_rows(jnp.asarray(x1), jnp.asarray(x2), 0.2))
    np.testing.assert_array_equal(ours, rows)
    assert ours[np.isnan(x1) | np.isnan(x2)].all()


def _iou32(x1i, x2i, x1j, x2j):
    """The kernels' float32 IoU, elementwise in numpy."""
    f = np.float32
    wi, wj = np.maximum(x2i - x1i, f(0)), np.maximum(x2j - x1j, f(0))
    inter = np.maximum(np.minimum(x2i, x2j) - np.maximum(x1i, x1j), f(0))
    return inter / np.maximum(wi + wj - inter, f(1e-12))


def _near_threshold(thr, n=60):
    """Pairs [0, 1] and [a, b] (IoU (1-a)/b) whose float32 IoU lands one ulp
    below, on, and one ulp above the threshold."""
    t32 = np.float32(thr)
    steps = np.arange(-300, 300, dtype=np.int32)
    a = (np.float32(0.5).view(np.int32) + steps).view(np.float32)[:, None]
    b = (np.float32(0.5 / thr).view(np.int32) + steps).view(np.float32)[None, :]
    iou = _iou32(np.float32(0), np.float32(1), a, b)
    x1, x2 = [], []
    for target in (np.nextafter(t32, np.float32(0)), t32, np.nextafter(t32, np.float32(1))):
        hit = np.argwhere(iou == target)
        if hit.size:
            x1 += [0.0, float(a[hit[0, 0], 0])]
            x2 += [1.0, float(b[0, hit[0, 1]])]
    found = len(x1) // 2
    x1 = np.array(x1 * (n // len(x1) + 1), np.float32)[:n][None, :]
    x2 = np.array(x2 * (n // len(x2) + 1), np.float32)[:n][None, :]
    return x1, x2, found


@pytest.mark.parametrize("thr", [0.1, 0.45])
def test_keep_at_threshold_ulps(thr):
    x1, x2, found = _near_threshold(thr)
    assert found == 3
    ours, rows, pallas = _all_three(x1, x2, thr)
    np.testing.assert_array_equal(ours, rows)
    np.testing.assert_array_equal(ours, pallas)


def _bounds(case, k, thr):
    """(B, K) float32 bounds for one case of the kernels' mirror test."""
    rng = np.random.default_rng(17 + k)
    if case == "chain":
        x1 = (np.arange(k, dtype=np.float32) * np.float32(0.6))[None, :]
        return x1, x1 + np.float32(1)
    if case == "near":
        return _near_threshold(thr, n=k)[:2]
    x1, x2 = _intervals(rng, 2, k)
    if case == "non-finite":
        for arr, value in ((x1, np.nan), (x2, np.inf), (x1, -np.inf), (x2, np.nan)):
            arr[rng.random(arr.shape) < 0.05] = value
    return x1, x2


@pytest.mark.parametrize("k", [1, 31, 32, 33, 77, 630])
@pytest.mark.parametrize("case,thr", [("random", 0.1), ("random", 0.45), ("chain", 0.1),
                                      ("near", 0.1), ("near", 0.45), ("non-finite", 0.2)])
def test_kernel_phases_mirror_bit_identical(case, thr, k):
    """The kernels' two phases, mirrored in plain code (mask words, then the
    chunked or the row-by-row resolve), give the greedy keep flags bit for bit:
    the plain version, the JAX rows and both Pallas kernels in interpret mode.
    The blocked Pallas kernel gathers bounds with 0/1 matrix products, where a
    NaN or infinite bound spreads to every column, so it is left out of the
    non-finite case."""
    x1, x2 = _bounds(case, k, thr)
    t1, t2 = torch.from_numpy(x1), torch.from_numpy(x2)
    words = suppression_words_plain(t1, t2, thr)
    assert words.shape == (x1.shape[0], k, -(-k // 32)) and words.dtype == torch.int32
    ours, rows, pallas = _all_three(x1, x2, thr)
    valid = jnp.ones(x1.shape, bool)
    unblocked = np.asarray(greedy_suppress_pallas(jnp.asarray(x1), jnp.asarray(x2), valid, thr,
                                                  interpret=True))
    refs = [rows, unblocked] + ([] if case == "non-finite" else [pallas])
    for chunked in (True, False):
        got = resolve_words_plain(words, k, chunked).numpy()
        np.testing.assert_array_equal(got, ours)
        for ref in refs:
            np.testing.assert_array_equal(got, ref)
    if case == "chain" and k > 1:
        assert ours[0, ::2].all() and not ours[0, 1::2].any()


def test_suppression_words_layout():
    """Bit t of word w of row i is IoU(i, 32w + t) > thr for later columns
    inside K only: the diagonal and below, and the pad columns, stay unset."""
    x1, x2 = _intervals(np.random.default_rng(18), 2, 77)
    x1[:, 70:] = x1[:, 69:70]  # the last rows overlap fully, so later columns are set
    x2[:, 70:] = x2[:, 69:70]
    words = suppression_words_plain(torch.from_numpy(x1), torch.from_numpy(x2), 0.3).numpy()
    bits = (words.astype(np.uint32)[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    bits = bits.reshape(2, 77, 96).astype(bool)
    iou = _iou32(x1[:, :, None], x2[:, :, None], x1[:, None, :], x2[:, None, :])
    later = np.triu(np.ones((77, 77), bool), 1)
    np.testing.assert_array_equal(bits[..., :77], (iou > np.float32(0.3)) & later)
    assert not bits[..., 77:].any() and bits[:, 69, 70:77].all()


@pytest.mark.parametrize("thr", [0.1, 0.45, 0.0, -0.1, 1.0, 1e-30, np.inf])
def test_mask_phase_product_test_decides_like_the_divide(thr):
    """The mask phase decides RN(inter / den) > thr by the signs of
    inter - thr * den and inter - next_float(thr) * den (each one fused
    multiply-add, one rounding) and divides only where neither settles it.
    Emulated here (float64 holds both products exactly), on random,
    within-an-ulp and non-finite pairs, it gives the divide's bits."""
    f32 = np.float32
    x1, x2 = _intervals(np.random.default_rng(19), 1, 400)
    near = _near_threshold(0.1)[:2] + _near_threshold(0.45)[:2]
    x1 = np.concatenate([x1[0], near[0][0], near[2][0]])
    x2 = np.concatenate([x2[0], near[1][0], near[3][0]])
    x1[::37], x2[::41], x1[::43], x2[::47] = np.nan, np.inf, -np.inf, np.nan
    a1, a2, b1, b2 = x1[:, None], x2[:, None], x1[None, :], x2[None, :]
    with np.errstate(invalid="ignore", over="ignore"):
        inter = np.maximum(np.minimum(a2, b2) - np.maximum(a1, b1), f32(0))
        w1, w2 = np.maximum(a2 - a1, f32(0)), np.maximum(b2 - b1, f32(0))
        den = np.maximum(w1 + w2 - inter, f32(1e-12))
        t, t_up = f32(thr), np.nextafter(f32(thr), f32(np.inf))
        # one rounding to float32 keeps the sign of the exact difference
        below = (inter.astype(np.float64) - np.float64(t) * den).astype(f32)
        above = (inter.astype(np.float64) - np.float64(t_up) * den).astype(f32)
        exact = inter / den > t
    assert inter.dtype == den.dtype == np.float32
    unsure = ~(below < 0) & ~(above > 0)
    decided = (above > 0) | (unsure & exact)
    np.testing.assert_array_equal(decided, exact)
    if thr == 0.1:  # the divide is rare on intervals that are not built to tie
        assert unsure[:400, :400][np.isfinite(den[:400, :400])].mean() < 1e-3


def test_kernel_limit_raises_before_launch():
    """Above K_MAX the wrapper raises; it does not fall back to the plain version."""
    x = torch.zeros((1, nms_kernel.K_MAX + 1))
    with pytest.raises(ValueError, match=str(nms_kernel.K_MAX)):
        nms_kernel._launch(x, x, 0.1, nms_kernel.greedy_suppress_blocked)


def test_interval_iou_matrix_matches():
    x1, x2 = _intervals(np.random.default_rng(12), 2, 50)
    ref = np.asarray(j_iou(jnp.asarray(x1), jnp.asarray(x2)))
    np.testing.assert_array_equal(interval_iou_matrix(torch.from_numpy(x1), torch.from_numpy(x2)).numpy(), ref)


def _preds(rng, b=3, k=630, c=2):
    p = rng.standard_normal((b, k, 3 + c)).astype(np.float32)
    p[..., -2] = rng.uniform(0, 60, (b, k))
    p[..., -1] = rng.uniform(0.5, 20, (b, k))
    return p


def test_batched_interval_nms_matches():
    p = _preds(np.random.default_rng(13))
    j_order, j_keep, j_conf = map(np.asarray, j_nms(jnp.asarray(p), 0.1, 0.2, 60.0))
    order, keep, conf = batched_interval_nms(torch.from_numpy(p), 0.1, 0.2, 60.0)
    np.testing.assert_array_equal(order.numpy(), j_order)
    np.testing.assert_array_equal(keep.numpy(), j_keep)
    np.testing.assert_allclose(conf.numpy(), j_conf, atol=1e-6, rtol=0)
    assert 0 < keep.sum() < keep.numel()


def test_postprocess_packed_matches_on_valid_rows():
    p = _preds(np.random.default_rng(14))
    ref = np.asarray(j_pack(j_post(jnp.asarray(p), 0.1, 0.2, 60.0, 128)))
    out = pack_detections(detection_postprocess_graph(torch.from_numpy(p), 0.1, 0.2, 60.0, 128)).numpy()
    assert out.shape == ref.shape == (3, 128, 6)
    np.testing.assert_array_equal(out[..., 5], ref[..., 5])
    v = ref[..., 5] > 0.5
    assert v.any()
    np.testing.assert_array_equal(out[v][:, 2], ref[v][:, 2])
    np.testing.assert_allclose(out[v], ref[v], atol=1e-6, rtol=0)


def test_cpu_tensors_take_the_plain_version():
    x1, x2 = _intervals(np.random.default_rng(15), 2, 64)
    t1, t2 = torch.from_numpy(x1), torch.from_numpy(x2)
    before = (nms_kernel.greedy_suppress_blocked.launches,
              nms_kernel.greedy_suppress_unblocked.launches)
    ref = greedy_suppress_rows(t1, t2, 0.3)
    assert torch.equal(nms_kernel.greedy_suppress_blocked(t1, t2, 0.3), ref)
    assert torch.equal(nms_kernel.greedy_suppress_unblocked(t1, t2, 0.3), ref)
    assert (nms_kernel.greedy_suppress_blocked.launches,
            nms_kernel.greedy_suppress_unblocked.launches) == before

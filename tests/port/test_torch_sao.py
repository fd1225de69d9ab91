"""PyTorch port, SAO: `hevc_tpu_torch.ops.sao` on the CPU against the
JAX `hevc_tpu.ops.sao` on the same numpy-seeded planes, tolerance 0:
the per-CTU statistics (all four arrays), the normative apply with
random parameters, and the whole estimate + apply of a frame; plus the
port's twins of the unit tests of tests/test_sao.py."""

import gc

import jax
import numpy as np
import pytest
import torch

from hevc_tpu.ops import sao as j_sao
from hevc_tpu_torch.ops import sao as t_sao

from tests.port.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs():
    yield
    jax.clear_caches()
    gc.collect()


def _pair(h, w, seed, noise=6, band_bias=0):
    """(orig, rec) int32: smooth content plus blocky structure, and a
    reconstruction off by small seeded errors; band_bias shifts the
    reconstruction of the samples in bands 12..15 (a band-offset case)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    orig = (110 + 50 * np.sin(xx / 9.0) * np.cos(yy / 13.0)
            + 30 * ((xx // 8 + yy // 8) % 3) + rng.randint(-3, 4, (h, w)))
    orig = np.clip(orig, 0, 255).astype(np.int32)
    rec = orig + rng.randint(-noise, noise + 1, (h, w))
    rec += np.where((orig >> 5) == 3, band_bias, 0)
    return orig, np.clip(rec, 0, 255).astype(np.int32)


@pytest.mark.parametrize("h,w,seed", [(64, 64, 31), (36, 64, 32),
                                      (80, 96, 33)])
def test_eo_categories_of_all_classes_match_jax(h, w, seed):
    """The port's `_eo_cat` gives all four classes at once, 0 where a
    neighbour lies outside the plane: the JAX category where it is valid."""
    _, rec = _pair(h, w, seed)
    got = t_sao._eo_cat(torch.from_numpy(rec)).numpy()
    assert got.shape == (4, h, w)
    for cls in range(4):
        cat, valid = j_sao._eo_cat(rec, cls)
        np.testing.assert_array_equal(
            got[cls], np.where(np.asarray(valid), np.asarray(cat), 0))
    assert set(np.unique(got)) == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("h,w,ctu,seed", [
    (64, 64, 64, 1), (64, 128, 64, 2), (80, 96, 64, 3),
    (32, 64, 32, 4), (40, 48, 32, 5), (36, 64, 32, 6)])
def test_sao_stats_match_jax(h, w, ctu, seed):
    orig, rec = _pair(h, w, seed)
    got = t_sao.sao_stats(torch.from_numpy(orig), torch.from_numpy(rec), ctu)
    want = j_sao.sao_stats(orig, rec, ctu)
    for g, wv in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))
    assert got[0].sum() > 0 and got[2].sum() == h * w


@pytest.mark.parametrize("h,w,ctu,seed", [
    (64, 64, 64, 11), (80, 96, 64, 12), (40, 48, 32, 13), (36, 64, 32, 14)])
def test_sao_apply_matches_jax(h, w, ctu, seed):
    _, rec = _pair(h, w, seed)
    rng = np.random.RandomState(seed)
    B = -(-h // ctu) * -(-w // ctu)
    type_idx = rng.randint(0, 3, B).astype(np.int32)
    eo_class = rng.randint(0, 4, B).astype(np.int32)
    band_pos = rng.randint(0, 32, B).astype(np.int32)
    offsets = rng.randint(-7, 8, (B, 4)).astype(np.int32)
    got = t_sao.sao_apply(torch.from_numpy(rec), type_idx, eo_class,
                          band_pos, offsets, ctu)
    want = j_sao.sao_apply(rec, type_idx, eo_class, band_pos, offsets, ctu)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), rec)


@pytest.mark.parametrize("h,w,qp,seed,bias", [
    (64, 64, 22, 21, 0), (64, 128, 32, 22, 0), (80, 96, 37, 23, 0),
    (72, 128, 45, 24, 0), (64, 128, 27, 25, -6), (80, 96, 32, 26, 5)])
def test_estimate_and_apply_frame_match_jax(h, w, qp, seed, bias):
    oy, ry = _pair(h, w, seed, noise=1 if bias else 6, band_bias=bias)
    ocb, rcb = _pair(h // 2, w // 2, seed + 1, noise=4)
    ocr, rcr = _pair(h // 2, w // 2, seed + 2, noise=4)
    t = lambda a: torch.from_numpy(a)
    got = t_sao.estimate_frame(t(oy), t(ocb), t(ocr), t(ry), t(rcb), t(rcr),
                               qp)
    want = j_sao.estimate_frame(oy, ocb, ocr, ry, rcb, rcr, qp)
    for name in t_sao.SaoParams._fields:
        g, wv = getattr(got, name), getattr(want, name)
        assert g.dtype == wv.dtype, name
        np.testing.assert_array_equal(g, wv, err_msg=name)
    assert (got.type_idx == (t_sao.SAO_BAND if bias else t_sao.SAO_EDGE)
            ).any()
    out = t_sao.apply_frame(t(ry), t(rcb), t(rcr), got)
    ref = j_sao.apply_frame(ry, rcb, rcr, want)
    for g, wv in zip(out, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))


# the port's twins of tests/test_sao.py's unit tests

def test_sao_apply_band_known():
    """BO: +3 on bands pos..pos+3 shifts exactly those samples."""
    rec = np.arange(64 * 64, dtype=np.int32).reshape(64, 64) % 256
    pos = 10
    t = np.array([1], np.int32)
    offs = np.array([[3, 3, 3, 3]], np.int32)
    out = t_sao.sao_apply(torch.from_numpy(rec), t, np.zeros(1, np.int32),
                          np.array([pos], np.int32), offs, 64).numpy()
    band = rec >> 3
    in_win = ((band - pos) & 31) < 4
    np.testing.assert_array_equal(out[in_win], np.clip(rec[in_win] + 3, 0, 255))
    np.testing.assert_array_equal(out[~in_win], rec[~in_win])


def test_sao_apply_edge_smooths_impulse():
    """EO class 0 (horizontal) with negative cat-4 offset pulls down a
    horizontal impulse (local max)."""
    rec = np.full((64, 64), 100, np.int32)
    rec[10, 20] = 120            # local max along the row
    t = np.array([2], np.int32)
    offs = np.array([[0, 0, 0, -5]], np.int32)
    out = t_sao.sao_apply(torch.from_numpy(rec), t, np.zeros(1, np.int32),
                          np.zeros(1, np.int32), offs, 64).numpy()
    assert out[10, 20] == 115
    assert out[10, 21] == 100    # cat1/2 offsets are 0


def test_sao_estimator_reduces_sse():
    """Estimated params never increase SSE when applied."""
    rng = np.random.RandomState(0)
    orig = rng.randint(0, 256, (128, 128)).astype(np.int32)
    rec = np.clip(orig + rng.randint(-6, 7, orig.shape), 0, 255)
    ocb = rng.randint(0, 256, (64, 64)).astype(np.int32)
    rcb = np.clip(ocb + rng.randint(-4, 5, ocb.shape), 0, 255)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    p = t_sao.estimate_frame(t(orig), t(ocb), t(ocb), t(rec), t(rcb), t(rcb),
                             qp=32)
    y2, cb2, cr2 = t_sao.apply_frame(t(rec), t(rcb), t(rcb), p)
    sse_before = ((orig - rec) ** 2).sum()
    sse_after = ((orig - y2.numpy()) ** 2).sum()
    assert sse_after <= sse_before
    assert p.type_idx.shape == (3, 4)

"""PyTorch port, inter prediction: `hevc_tpu_torch.ops.inter` on the CPU
against the JAX `hevc_tpu.ops.inter` on the same numpy-seeded windows,
planes, origins and MVs, tolerance 0 (all of it is int32 arithmetic).

The cases reach what a transcription gets wrong: every fraction pair of
both filters, negative and odd MVs (arithmetic `>>` and two's-complement
`&`), windows clamped at each picture border, multi-reference gathers,
rectangular blocks, and flat content where every candidate ties (the
first in raster order must win)."""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevc_tpu.ops import inter as j_inter
from hevc_tpu_torch.ops import inter as t_inter

from tests.port.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs():
    yield
    jax.clear_caches()
    gc.collect()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(a)


def _eq(got, want):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == np.int32, got.dtype
    np.testing.assert_array_equal(got, want)


def _grid(w, h):
    ys, xs = np.mgrid[0:-(-h // 64), 0:-(-w // 64)]
    return np.stack([xs.ravel() * 64, ys.ravel() * 64], -1).astype(np.int32)


def _moving(seed, w=192, h=128, shift=(3, -2), noise=4):
    """(cur, ref) planes: ref random, cur = ref moved by np.roll plus
    small noise, so the search has a clear but not exact match."""
    rng = np.random.RandomState(seed)
    ref = rng.randint(0, 256, (h, w))
    cur = np.roll(ref, shift, axis=(0, 1)) + rng.randint(-noise, noise + 1,
                                                         (h, w))
    return np.clip(cur, 0, 255).astype(np.int32), ref.astype(np.int32)


# ---------------------------------------------------------------- MC filters

@pytest.mark.parametrize("fx,fy", [
    (0, 0), (0, 1), (0, 2), (0, 3), (1, 0), (1, 1), (1, 2), (1, 3),
    (2, 0), (2, 1), (2, 2), (2, 3), (3, 0), (3, 1), (3, 2), (3, 3)])
def test_mc_luma_matches_jax(fx, fy):
    rng = np.random.RandomState(10 + 4 * fx + fy)
    win = rng.randint(0, 256, (3, 71, 71)).astype(np.int32)
    _eq(t_inter.mc_luma(_t(win), fx, fy, 64, 64),
        j_inter.mc_luma(_j(win), fx, fy, 64, 64))


@pytest.mark.parametrize("fx", [0, 1, 2, 3, 4, 5, 6, 7])
def test_mc_chroma_matches_jax(fx):
    rng = np.random.RandomState(40 + fx)
    win = rng.randint(0, 256, (3, 35, 35)).astype(np.int32)
    for fy in range(8):
        _eq(t_inter.mc_chroma(_t(win), fx, fy, 32, 32),
            j_inter.mc_chroma(_j(win), fx, fy, 32, 32))


def test_mc_luma_10bit_and_uint8_input():
    rng = np.random.RandomState(50)
    win10 = rng.randint(0, 1024, (2, 15, 15)).astype(np.int32)
    for fx, fy in ((0, 0), (1, 3), (2, 0), (0, 2)):
        _eq(t_inter.mc_luma(_t(win10), fx, fy, 8, 8, bit_depth=10),
            j_inter.mc_luma(_j(win10), fx, fy, 8, 8, bit_depth=10))
    win8 = rng.randint(0, 256, (2, 15, 15)).astype(np.uint8)
    _eq(t_inter.mc_luma(_t(win8), 3, 1, 8, 8),
        j_inter.mc_luma(_j(win8), 3, 1, 8, 8))


# ------------------------------------------------------------ integer search

_search_jit = jax.jit(j_inter.integer_search_ctu, static_argnames=("radius",))
_grid8_jit = jax.jit(j_inter.sad_grid8, static_argnames=("radius",))


def _search_case(kind):
    """(cur tiles, ref plane, origins): every CTU of a 192x128 frame, so
    each picture border clamps some window."""
    w, h = 192, 128
    org = _grid(w, h)
    if kind == "flat":
        ref = np.full((h, w), 90, np.int32)
        cur = np.full((h, w), 90, np.int32)
    elif kind == "random":
        rng = np.random.RandomState(60)
        ref = rng.randint(0, 256, (h, w)).astype(np.int32)
        cur = rng.randint(0, 256, (h, w)).astype(np.int32)
    else:
        cur, ref = _moving(61)
    tiles = np.stack([cur[y:y + 64, x:x + 64] for x, y in org])
    if kind == "uint8":
        tiles, ref = tiles.astype(np.uint8), ref.astype(np.uint8)
    return tiles, ref, org


@pytest.mark.parametrize("kind,radius", [
    ("moving", 8), ("moving", 4), ("random", 8), ("random", 4),
    ("flat", 8), ("flat", 4), ("uint8", 8)])
def test_integer_search_ctu_matches_jax(kind, radius):
    tiles, ref, org = _search_case(kind)
    mv, sad = t_inter.integer_search_ctu(_t(tiles), _t(ref), _t(org),
                                         radius=radius)
    j_mv, j_sad = _search_jit(_j(tiles), _j(ref), _j(org), radius=radius)
    _eq(mv, j_mv)
    _eq(sad, j_sad)
    if kind == "flat":            # every candidate ties: raster index 0
        assert (mv.numpy() == -radius).all() and (sad.numpy() == 0).all()
    if kind == "moving":
        # np.roll(+3 rows, -2 cols): cur[y][x] = ref[y-3][x+2] -> mv
        # (+2, -3) for the CTU at (64, 64), whose window nothing clamps
        assert tuple(mv.numpy()[4]) == (2, -3), mv


@pytest.mark.parametrize("kind,radius", [("moving", 8), ("random", 4),
                                         ("flat", 8)])
def test_sad_grid8_matches_jax(kind, radius):
    tiles, ref, org = _search_case(kind)
    got = t_inter.sad_grid8(_t(tiles), _t(ref), _t(org), radius=radius)
    _eq(got, _grid8_jit(_j(tiles), _j(ref), _j(org), radius=radius))
    # aggregated over the 8x8 grid it is the integer search's SAD field
    mv, sad = t_inter.integer_search_ctu(_t(tiles), _t(ref), _t(org),
                                         radius=radius)
    tot = got.sum((2, 3))
    np.testing.assert_array_equal(tot.min(0).values.numpy(), sad.numpy())


# --------------------------------------------------------- MC of whole blocks

_pred_jit = jax.jit(j_inter.predict_inter_blocks,
                    static_argnames=("size", "is_luma", "size_w"))


@pytest.mark.parametrize("is_luma,size,size_w,n_refs", [
    (True, 64, None, 0), (True, 16, None, 0), (True, 16, 8, 0),
    (True, 8, 16, 0), (False, 32, None, 0), (False, 8, 4, 0),
    (True, 16, 8, 3), (False, 8, None, 3)])
def test_predict_inter_blocks_matches_jax(is_luma, size, size_w, n_refs):
    """Negative and odd MVs (every fraction of the component), blocks at
    and beyond each border, one reference or several (`ref_idx`)."""
    rng = np.random.RandomState(70 + size + 3 * n_refs + int(is_luma))
    h, w = (128, 192) if is_luma else (64, 96)
    shape = (n_refs, h, w) if n_refs else (h, w)
    ref = rng.randint(0, 256, shape).astype(np.int32)
    B = 24
    org = np.stack([rng.randint(-8, w - size + 8, B),
                    rng.randint(-8, h - size + 8, B)], -1).astype(np.int32)
    org[:4] = [[0, 0], [w - size, 0], [0, h - size], [w - size, h - size]]
    mv = rng.randint(-37, 38, (B, 2)).astype(np.int32)
    mv[4:8] = [[-1, -1], [-5, 3], [7, -9], [-33, -31]]
    ref_idx = (rng.randint(0, n_refs, B).astype(np.int32) if n_refs
               else None)
    got = t_inter.predict_inter_blocks(
        _t(ref), _t(org), _t(mv), size, is_luma=is_luma,
        ref_idx=None if ref_idx is None else _t(ref_idx), size_w=size_w)
    want = _pred_jit(_j(ref), _j(org), _j(mv), size=size, is_luma=is_luma,
                     ref_idx=None if ref_idx is None else _j(ref_idx),
                     size_w=size_w)
    _eq(got, want)
    assert got.shape == (B, size, size_w or size)
    if size == (64 if is_luma else 32) and size_w is None and not n_refs:
        _eq(t_inter.predict_inter_ctu(_t(ref), _t(org), _t(mv),
                                      is_luma=is_luma), want)


# -------------------------------------------------------- quarter-pel sweep

_refine_jit = jax.jit(j_inter.quarter_refine_blocks,
                      static_argnames=("size", "size_w"))


@pytest.mark.parametrize("kind,size,size_w,n_refs", [
    ("moving", 64, None, 0), ("moving", 16, 8, 2), ("flat", 64, None, 0),
    ("flat", 16, 8, 2)])
def test_quarter_refine_blocks_matches_jax(kind, size, size_w, n_refs):
    sw = size_w or size
    if kind == "flat":           # all 49 candidates tie: (-3, -3) wins
        cur = np.full((128, 192), 77, np.int32)
        ref = cur.copy()
    else:
        cur, ref = _moving(90 + size, shift=(1, 2), noise=2)
    rng = np.random.RandomState(91)
    B = 12
    org = np.stack([rng.randint(0, 192 - sw + 1, B) // 4 * 4,
                    rng.randint(0, 128 - size + 1, B) // 4 * 4],
                   -1).astype(np.int32)
    org[0] = [0, 0]
    org[1] = [192 - sw, 128 - size]
    blocks = np.stack([cur[y:y + size, x:x + sw] for x, y in org])
    mv_int = rng.randint(-4, 5, (B, 2)).astype(np.int32)
    refs = np.stack([ref, np.roll(ref, 1, axis=1)]) if n_refs else ref
    ref_idx = (np.arange(B, dtype=np.int32) % 2) if n_refs else None
    got = t_inter.quarter_refine_blocks(
        _t(blocks), _t(refs), _t(org), _t(mv_int), size,
        ref_idx=None if ref_idx is None else _t(ref_idx), size_w=size_w)
    want = _refine_jit(_j(blocks), _j(refs), _j(org), _j(mv_int), size=size,
                       ref_idx=None if ref_idx is None else _j(ref_idx),
                       size_w=size_w)
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    if kind == "flat":
        np.testing.assert_array_equal(got[0].numpy(), 4 * mv_int - 3)


# ------------------------- the port's twins of tests/test_inter_ldp.py:18-66

def test_mc_luma_integer_is_copy():
    rng = np.random.RandomState(0)
    ref = rng.randint(0, 256, (2, 71, 71)).astype(np.int32)
    out = t_inter.mc_luma(_t(ref), 0, 0, 64, 64).numpy()
    np.testing.assert_array_equal(out, ref[:, 3:67, 3:67])


def test_mc_luma_half_pel_flat():
    """Half-pel interp of a constant plane is the constant."""
    ref = np.full((1, 71, 71), 100, np.int32)
    assert (t_inter.mc_luma(_t(ref), 2, 2, 64, 64) == 100).all()


def test_mc_luma_half_pel_matches_direct():
    """1-D half-pel against a direct numpy evaluation of the 8-tap."""
    rng = np.random.RandomState(1)
    ref = rng.randint(0, 256, (1, 71, 71)).astype(np.int64)
    out = t_inter.mc_luma(_t(ref.astype(np.int32)), 2, 0, 64, 64).numpy()
    f = t_inter.LUMA_FILTERS[2].astype(np.int64)
    for x in range(5):
        expect = sum(f[t] * ref[0, 3, x + t] for t in range(8))
        expect = (expect * 64 + (1 << 11)) >> 12
        expect = min(max(expect, 0), 255)
        assert out[0, 0, x] == expect, (x, out[0, 0, x], expect)


def test_mc_chroma_integer_is_copy():
    rng = np.random.RandomState(2)
    ref = rng.randint(0, 256, (1, 35, 35)).astype(np.int32)
    out = t_inter.mc_chroma(_t(ref), 0, 0, 32, 32).numpy()
    np.testing.assert_array_equal(out, ref[:, 1:33, 1:33])


def test_integer_search_finds_known_shift():
    rng = np.random.RandomState(3)
    ref = rng.randint(0, 256, (128, 128)).astype(np.int32)
    # block at (32,32) matches ref at (35, 30) -> mv = (+3, -2)
    cur = ref[30:94, 35:99].copy()
    mv, sad = t_inter.integer_search_ctu(
        _t(cur[None]), _t(ref), _t(np.array([[32, 32]], np.int32)),
        radius=8)
    assert tuple(mv.numpy()[0]) == (3, -2), mv
    assert int(sad[0]) == 0

"""PyTorch port, partition/mode search: `search_frame` (CPU tensors)
against the JAX `search_frame` on seeded content — gated and ungated,
with and without chroma, max_depth 1..3, a frame with forced boundary
splits. RD costs: rtol 1e-5 (float32; the bit model sums log2 terms and a
14-wide dot product in another order than XLA). Decisions (every
SearchResult field): equal."""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevc_tpu.core.yuv import pad_frame
from hevc_tpu.entropy import headers as j_headers
from hevc_tpu.pipeline import search as j_search
from hevc_tpu_torch.pipeline import search as t_search

from tests.test_e2e_bitstream import synth_frame
from tests.port.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs():
    """Drop the XLA programs this module compiled once it is done: the
    test process is shared with the rest of the suite and memory is tight."""
    yield
    jax.clear_caches()
    gc.collect()


T = lambda a: torch.from_numpy(np.ascontiguousarray(a))


def _frame(w, h, seed):
    cfg = j_headers.EncoderConfig(width=w, height=h, qp=32)
    pf = pad_frame(synth_frame(w, h, seed=seed), cfg.pad_width,
                   cfg.pad_height)
    return cfg, pf, j_search.ctu_grid(cfg.pad_width, cfg.pad_height)


def _probs(B, seed, max_depth):
    """HCPM probabilities well away from the 0.5 gates, some closed; the
    gates below `max_depth` all closed, as the caller of a narrowed
    search guarantees (search.gate_max_depth)."""
    rng = np.random.RandomState(seed)
    p = np.where(rng.rand(B, 21) < 0.6, 0.8, 0.2).astype(np.float32)
    p[:, 0] = 0.9
    if max_depth < 3:
        p[:, 5:] = 0.2
    if max_depth < 2:
        p[:, 1:] = 0.2
    return p


CASES = [
    # w, h, qp, gated, chroma, max_depth, nxn
    (64, 64, 32, False, True, 3, True),
    (64, 64, 27, True, True, 3, True),
    (64, 64, 32, True, False, 2, True),
    (64, 64, 37, True, True, 1, True),
    (96, 80, 32, True, True, 3, True),
    (96, 80, 32, False, False, 3, False),
]


@pytest.mark.parametrize("w,h,qp,gated,chroma,max_depth,nxn", CASES)
def test_search_frame_equals_jax(w, h, qp, gated, chroma, max_depth, nxn):
    cfg, pf, origins = _frame(w, h, seed=w + qp + max_depth)
    B = origins.shape[0]
    kw = dict(pad_w=cfg.pad_width, pad_h=cfg.pad_height, n_ctu_x=cfg.ctus_x,
              qp=qp, nxn=nxn, max_depth=max_depth)
    probs = _probs(B, qp, max_depth) if gated else None
    if gated:
        kw.update(thr_up=(0.5, 0.5, 0.5), thr_down=(0.5, 0.5, 0.5))
    j_planes = dict(cb_plane=jnp.asarray(pf.cb),
                    cr_plane=jnp.asarray(pf.cr)) if chroma else {}
    t_planes = dict(cb_plane=T(pf.cb), cr_plane=T(pf.cr)) if chroma else {}
    want = jax.jit(lambda y, o, p: j_search.search_frame(
        y, o, hcpm_probs=p, **j_planes, **kw))(
            jnp.asarray(pf.y), jnp.asarray(origins),
            None if probs is None else jnp.asarray(probs))
    got = t_search.search_frame(
        T(pf.y), T(origins.astype(np.int64)),
        hcpm_probs=None if probs is None else T(probs), **t_planes, **kw)
    for name in want._fields:
        g, wv = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == wv.shape, name
        np.testing.assert_array_equal(g, wv, name)
    # the case exercises what it claims to
    d8 = got.depth8.numpy()
    assert d8.max() <= max(max_depth,
                           t_search.forced_depth_floor(cfg.pad_width,
                                                       cfg.pad_height))
    assert t_search.forced_depth_floor(cfg.pad_width, cfg.pad_height) == \
        j_search.forced_depth_floor(cfg.pad_width, cfg.pad_height)


@pytest.mark.parametrize("depth", [0, 2, 4])
def test_leaf_costs_and_best_modes(depth):
    """Per-node best modes / SATDs equal; refined RD costs rtol 1e-5."""
    cfg, pf, origins = _frame(96, 80, seed=21)
    qp = 30
    lam = float(np.float32(0.57 * 2.0 ** ((qp - 12) / 3.0)))
    kw = dict(pad_w=cfg.pad_width, pad_h=cfg.pad_height, n_ctu_x=cfg.ctus_x)
    to = T(origins.astype(np.int64))
    jm, js = jax.jit(lambda y, o: j_search._best_mode_per_node(
        y, o, depth, cfg.pad_width, cfg.pad_height, cfg.ctus_x))(
            jnp.asarray(pf.y), jnp.asarray(origins))
    tm, ts = t_search._best_mode_per_node(T(pf.y), to, depth, cfg.pad_width,
                                          cfg.pad_height, cfg.ctus_x)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jc = jax.jit(lambda y, o, m: j_search._refined_costs(
        y, o, depth, m, qp, jnp.float32(lam), use_dst=depth == 4, **kw))(
            jnp.asarray(pf.y), jnp.asarray(origins), jm)
    tc = t_search._refined_costs(T(pf.y), to, depth, tm, qp, lam,
                                 use_dst=depth == 4, **kw)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5)
    if depth <= 3:
        jcc = jax.jit(lambda c, o, m: j_search._refined_chroma_costs(
            c, o, depth, m, 29, jnp.float32(lam), jnp.float32(1.26),
            bits_qp=qp, **kw))(jnp.asarray(pf.cb), jnp.asarray(origins), jm)
        tcc = t_search._refined_chroma_costs(T(pf.cb), to, depth, tm, 29,
                                             lam, float(np.float32(1.26)),
                                             **kw)
        np.testing.assert_allclose(tcc.numpy(), np.asarray(jcc), rtol=1e-5)
        np.testing.assert_array_equal(
            t_search.forced_split_mask(to, depth, cfg.pad_width,
                                       cfg.pad_height).numpy(),
            np.asarray(j_search.forced_split_mask(
                jnp.asarray(origins), depth, cfg.pad_width, cfg.pad_height)))

"""PyTorch port, tensor ops: transforms, quant, RDOQ-lite, cost, refs,
intra prediction, bit model, HCPM gates — the same numpy-seeded inputs
through the JAX function, its NumPy twin and the port (CPU tensors).
Integer results must be equal; float ones within the stated tolerance."""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevc_tpu.models import hcpm as j_hcpm
from hevc_tpu.ops import (bits as j_bits, cost as j_cost, intra as j_intra,
                          quant as j_quant, rdoq as j_rdoq, refs as j_refs,
                          transforms as j_tr)
from hevc_tpu_torch.models import hcpm as t_hcpm
from hevc_tpu_torch.ops import (bits as t_bits, cost as t_cost,
                                intra as t_intra, quant as t_quant,
                                rdoq as t_rdoq, refs as t_refs,
                                transforms as t_tr)

from tests.port.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs():
    """Drop the XLA programs this module compiled once it is done: the
    test process is shared with the rest of the suite and memory is tight."""
    yield
    jax.clear_caches()
    gc.collect()


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def N(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def eq(got, *wants):
    for w in wants:
        np.testing.assert_array_equal(N(got), N(w))


@pytest.mark.parametrize("n,use_dst", [(4, False), (4, True), (8, False),
                                       (16, False), (32, False)])
def test_transforms_equal(n, use_dst):
    rng = np.random.RandomState(n + use_dst)
    resi = rng.randint(-255, 256, (7, n, n)).astype(np.int32)
    resi[0] = 255
    resi[1] = -255
    f = t_tr.forward_transform(T(resi), use_dst=use_dst)
    eq(f, j_tr.forward_transform(jnp.asarray(resi), use_dst=use_dst),
       j_tr.forward_transform_np(resi, use_dst=use_dst),
       t_tr.forward_transform_np(resi, use_dst=use_dst))
    coef = rng.randint(-32768, 32768, (7, n, n)).astype(np.int32)
    coef[0] = 32767
    i = t_tr.inverse_transform(T(coef), use_dst=use_dst)
    eq(i, j_tr.inverse_transform(jnp.asarray(coef), use_dst=use_dst),
       j_tr.inverse_transform_np(coef, use_dst=use_dst))
    assert f.dtype == torch.int32 and i.dtype == torch.int32


@pytest.mark.parametrize("qp", [22, 32, 37, 45])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_quant_equal(n, qp):
    rng = np.random.RandomState(qp * 7 + n)
    coef = rng.randint(-32768, 32768, (5, n, n)).astype(np.int32)
    lv = t_quant.quantize(T(coef), qp)
    eq(lv, j_quant.quantize(jnp.asarray(coef), qp),
       j_quant.quantize_np(coef, qp))
    dq = t_quant.dequantize(lv, qp)
    eq(dq, j_quant.dequantize(jnp.asarray(N(lv)), qp),
       j_quant.dequantize_np(N(lv), qp))
    assert t_quant.chroma_qp(qp) == j_quant.chroma_qp(qp)


@pytest.mark.parametrize("qp", [22, 37])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_rdoq_lite_equal(n, qp):
    """Includes the coefficient-group pool: 16 float32 costs summed in
    the fixed dx-then-dy order and compared with <=."""
    rng = np.random.RandomState(qp + n)
    lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
    # transform-like content: a few large low-frequency values, many
    # small ones near the rounding boundaries
    coef = (rng.laplace(0, 40, (64, n, n))
            * (1 + 20 * (rng.rand(64, n, n) < 0.05))).astype(np.int32)
    got = t_rdoq.rd_quantize(T(coef), qp, lam)
    eq(got, j_rdoq.rd_quantize(jnp.asarray(coef), qp, lam),
       j_rdoq.rd_quantize_np(coef, qp, lam),
       t_rdoq.rd_quantize_np(coef, qp, lam))
    assert t_rdoq.alpha(n) == j_rdoq.alpha(n)
    lv = np.arange(0, 3000, dtype=np.int32)
    eq(t_rdoq._level_bits(T(lv)), j_rdoq._level_bits(jnp.asarray(lv)))


@pytest.mark.parametrize("block,size", [(4, 4), (8, 8), (8, 16), (8, 64)])
def test_cost_equal(block, size):
    rng = np.random.RandomState(size)
    a = rng.randint(0, 256, (3, 1, size, size)).astype(np.int32)
    b = rng.randint(0, 256, (3, 5, size, size)).astype(np.int32)
    eq(t_cost.satd(T(a), T(b), block=block),
       j_cost.satd(jnp.asarray(a), jnp.asarray(b), block=block),
       j_cost.satd_np(np.broadcast_to(a, b.shape), b, block=block))
    eq(t_cost.sad(T(a), T(b)), j_cost.sad(jnp.asarray(a), jnp.asarray(b)))
    eq(t_cost.sse(T(a), T(b)), j_cost.sse(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("n,scale", [(4, 1), (16, 1), (64, 1), (8, 2)])
def test_refs_equal(n, scale):
    rng = np.random.RandomState(n * 3 + scale)
    pad_w, pad_h, n_ctu_x = 160 // scale, 96 // scale, 3
    plane = rng.randint(0, 256, (pad_h, pad_w)).astype(np.uint8)
    step = max(n, 4)
    xs, ys = np.meshgrid(np.arange(0, pad_w + 32, step),
                         np.arange(0, pad_h + 32, step))
    origins = np.stack([xs.reshape(-1), ys.reshape(-1)], -1).astype(np.int32)
    jo, to = jnp.asarray(origins), T(origins.astype(np.int64))
    eq(t_refs.zaddr(to[:, 0], to[:, 1], n_ctu_x),
       j_refs.zaddr(jo[:, 0], jo[:, 1], n_ctu_x))
    eq(t_refs.gather_refs(T(plane), to, n),
       j_refs.gather_refs(jnp.asarray(plane), jo, n))
    eq(t_refs.availability(to, n, pad_w, pad_h, n_ctu_x, scale),
       j_refs.availability(jo, n, pad_w, pad_h, n_ctu_x, scale))
    eq(t_refs.prepare_refs(T(plane), to, n, pad_w, pad_h, n_ctu_x, scale),
       jax.jit(lambda p, o: j_refs.prepare_refs(p, o, n, pad_w, pad_h,
                                                n_ctu_x, scale))(
           jnp.asarray(plane), jo))


def test_substitute_and_filter_refs_equal():
    rng = np.random.RandomState(1)
    r = rng.randint(0, 256, (40, 33)).astype(np.int32)
    av = rng.rand(40, 33) < 0.5
    av[0] = False
    av[1] = True
    av[2, :20] = False
    got = t_intra.substitute_refs(T(r), T(av))
    eq(got, jax.jit(j_intra.substitute_refs)(jnp.asarray(r), jnp.asarray(av)),
       j_intra.substitute_refs_np(r, av))
    eq(t_intra.filter_refs(got), j_intra.filter_refs(jnp.asarray(N(got))),
       j_intra.filter_refs_np(N(got)))


@pytest.mark.parametrize("component", ["luma", "chroma"])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_intra_all_35_modes_equal(n, component):
    rng = np.random.RandomState(n)
    B = 6
    r = rng.randint(0, 256, (B, 4 * n + 1)).astype(np.int32)
    r[0] = 0
    r[0, 2 * n + 1] = 255     # VER/HOR edge sums go negative before the clip
    r[1] = 255
    r[1, 2 * n] = 0
    got = t_intra.predict_all_modes(T(r), n, component=component)
    eq(got, j_intra.predict_all_modes(jnp.asarray(r), n, component=component))
    for m in range(35):
        eq(got[:, m], j_intra.predict_np(r, m, n, component=component))
    # per-block modes: every mode once, plus the one-block form
    modes = np.arange(35, dtype=np.int32)
    r35 = rng.randint(0, 256, (35, 4 * n + 1)).astype(np.int32)
    sel = t_intra.predict_selected_modes(T(r35), T(modes), n,
                                         component=component)
    eq(sel, j_intra.predict_selected_modes(jnp.asarray(r35),
                                           jnp.asarray(modes), n,
                                           component=component))
    for m in (0, 1, 10, 26, 34):
        eq(t_intra.predict_one_mode(T(r35[m]), m, n, component=component),
           sel[m])
    rf = t_intra.filter_refs(T(r35))
    eq(t_intra.select_filtered_batch(T(r35), rf, T(modes), n),
       j_intra.select_filtered_batch(jnp.asarray(r35), jnp.asarray(N(rf)),
                                     jnp.asarray(modes), n))
    eq(t_intra.select_filtered(T(r35[3]), rf[3], 3, n),
       j_intra.select_filtered(jnp.asarray(r35[3]), jnp.asarray(N(rf[3])),
                               3, n))


@pytest.mark.parametrize("is_luma", [True, False])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_bit_model(n, is_luma):
    """Event counts are integers (equal); rem_log sums log2 values and the
    bits are a float dot product, in another order than XLA's:
    rtol 1e-5 (float32 carries ~7 digits, the sums have <= 1024 terms)."""
    rng = np.random.RandomState(n)
    lv = (rng.laplace(0, 1.5, (50, n, n))
          * (rng.rand(50, n, n) < 0.3)).astype(np.int32)
    lv[0] = 0
    lv[1, -1, -1] = 9
    ft = N(t_bits.tu_features(T(lv)))
    fj = np.asarray(j_bits.tu_features(jnp.asarray(lv)))
    rem = t_bits.FEATURE_NAMES.index("rem_log")
    keep = [i for i in range(ft.shape[-1]) if i != rem]
    np.testing.assert_array_equal(ft[:, keep], fj[:, keep])
    np.testing.assert_allclose(ft[:, rem], fj[:, rem], rtol=1e-5)
    np.testing.assert_allclose(
        N(t_bits.tu_bits(T(lv), is_luma=is_luma)),
        np.asarray(j_bits.tu_bits(jnp.asarray(lv), is_luma=is_luma)),
        rtol=1e-5)


def test_hcpm_gates_and_depth_maps_equal():
    rng = np.random.RandomState(0)
    probs = rng.rand(9, 21).astype(np.float32)
    probs[0, :3] = 0.5                      # exactly on the threshold
    for thr_t, thr_j in ((t_hcpm.DEFAULT_AI, j_hcpm.DEFAULT_AI),
                         (t_hcpm.DEFAULT_LDP, j_hcpm.DEFAULT_LDP)):
        for g, w in zip(t_hcpm.split_gates(T(probs), thr_t),
                        j_hcpm.split_gates(jnp.asarray(probs), thr_j)):
            eq(g, w)
    s0 = rng.rand(9) < 0.6
    s1 = rng.rand(9, 2, 2) < 0.6
    s2 = rng.rand(9, 4, 4) < 0.6
    d = t_hcpm.depth_map_from_decisions(T(s0), T(s1), T(s2))
    eq(d, j_hcpm.depth_map_from_decisions(s0, s1, s2))
    for a, b in zip(t_hcpm.decisions_from_depth_map(N(d)),
                    j_hcpm.decisions_from_depth_map(N(d))):
        eq(a, b)
    line = "0.9 0.1 0.8 0.2 0.7 0.3"
    for order in ("ai", "ldp"):
        assert (t_hcpm.parse_thresholds(line, order).up
                == j_hcpm.parse_thresholds(line, order).up)

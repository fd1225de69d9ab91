"""PyTorch port, deblocking: `hevc_tpu_torch.ops.deblock` on the CPU
against the JAX `hevc_tpu.ops.deblock` on the same numpy-seeded planes
and decisions, tolerance 0. The content is blocky with small noise, so
that the strong, weak and off branches of the luma filter are each taken
(counted independently from the planes, below)."""

import gc

import jax
import numpy as np
import pytest
import torch

from hevc_tpu.ops import deblock as j_dbk
from hevc_tpu_torch.ops import deblock as t_dbk

from tests.test_e2e_bitstream import legalize_depth
from tests.port.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs():
    yield
    jax.clear_caches()
    gc.collect()


def normative_edge_masks(depth8, part8=None):
    """The JAX `edge_masks` with the TU size of `tu_size8(depth8, part8)`:
    a rectangular CU of 16 or 32 splits its TU once (7.4.9.8), so both of
    its inner TU edges are edges (8.7.2.3). The JAX function takes the TU
    size of the depth alone and adds only the prediction edge; HM filters
    the other inner edge too. The JAX reference of a deblocking with
    rectangular PUs is this function in its place."""
    import jax.numpy as jnp
    t8 = j_dbk.tu_size8(depth8, part8)
    h8, w8 = t8.shape
    x8 = jnp.arange(w8)[None, :]
    y8 = jnp.arange(h8)[:, None]
    return ((x8 * 8) % t8 == 0) & (x8 > 0), ((y8 * 8) % t8 == 0) & (y8 > 0)


def _blocky(h, w, rng, block=8):
    """Planes of 8x8 blocks: a random walk of block levels (small steps
    and large jumps), each block flat, lightly noisy or textured."""
    hb, wb = h // block, w // block
    steps = np.where(rng.rand(hb, wb) < 0.6, rng.randint(-3, 4, (hb, wb)),
                     rng.randint(-60, 61, (hb, wb)))
    level = 128 + np.cumsum(steps, axis=1)
    kind = rng.choice(3, (hb, wb), p=[0.5, 0.3, 0.2])
    amp = np.array([0, 1, 25])[kind]
    base = np.repeat(np.repeat(level, block, 0), block, 1)
    noise = rng.randint(-1, 2, (h, w)) * np.repeat(
        np.repeat(amp, block, 0), block, 1)
    return np.clip(base + noise, 0, 255).astype(np.int32)


def _frame(w, h, seed):
    rng = np.random.RandomState(seed)
    d8 = legalize_depth(rng.randint(0, 4, (h // 8, w // 8)).astype(np.int32))
    return (_blocky(h, w, rng), _blocky(h // 2, w // 2, rng, 4),
            _blocky(h // 2, w // 2, rng, 4), d8)


def _luma_branches(plane, vert, qp):
    """(strong, weak, off) counts of the 4-row segments of the vertical
    luma edges where `vert` has an edge (8.7.2.5.3, 8.7.2.5.6): an
    independent numpy statement of the decision."""
    beta = int(j_dbk.BETA_TABLE[qp])
    tc = int(j_dbk.TC_TABLE[qp + 2])
    counts = [0, 0, 0]
    for y8, x8 in zip(*np.nonzero(vert)):
        for r0 in (8 * y8, 8 * y8 + 4):
            seg = plane[r0:r0 + 4, 8 * x8 - 4:8 * x8 + 4]
            p = seg[:, 3::-1]           # p0..p3
            q = seg[:, 4:]              # q0..q3
            dp = np.abs(p[:, 2] - 2 * p[:, 1] + p[:, 0])
            dq = np.abs(q[:, 2] - 2 * q[:, 1] + q[:, 0])
            if dp[0] + dq[0] + dp[3] + dq[3] >= beta:
                counts[2] += 1
                continue
            strong = all(
                2 * (dp[i] + dq[i]) < (beta >> 2)
                and abs(p[i, 3] - p[i, 0]) + abs(q[i, 0] - q[i, 3])
                < (beta >> 3)
                and abs(p[i, 0] - q[i, 0]) < ((5 * tc + 1) >> 1)
                for i in (0, 3))
            counts[0 if strong else 1] += 1
    return counts


@pytest.mark.parametrize("w,h,qp,seed", [
    (64, 64, 27, 1), (64, 64, 37, 2), (64, 64, 45, 3),
    (128, 64, 27, 4), (128, 64, 37, 5), (128, 64, 45, 6),
    (96, 80, 27, 7), (96, 80, 37, 8), (96, 80, 45, 9)])
def test_deblock_frame_matches_jax(w, h, qp, seed):
    y, cb, cr, d8 = _frame(w, h, seed)
    vert = np.asarray(j_dbk.edge_masks(d8)[0])
    strong, weak, off = _luma_branches(y, vert, qp)
    assert strong > 0 and weak > 0 and off > 0, (strong, weak, off)
    got = t_dbk.deblock_frame(torch.from_numpy(y), torch.from_numpy(cb),
                              torch.from_numpy(cr), d8, qp)
    want = j_dbk.deblock_frame(y, cb, cr, d8, qp)
    for g, wv in zip(got, want):
        assert g.dtype == torch.int32 and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))
    assert not np.array_equal(got[0].numpy(), y)      # the filter did work


def test_deblock_frame_leaves_its_input_alone():
    y, cb, cr, d8 = _frame(64, 64, 11)
    planes = [torch.from_numpy(a.astype(np.uint8)) for a in (y, cb, cr)]
    before = [p.clone() for p in planes]
    t_dbk.deblock_frame(*planes, d8, 37)
    for p, b in zip(planes, before):
        assert torch.equal(p, b)


@pytest.mark.parametrize("w,h,qp,seed,with_ref,with_intra,with_part", [
    (64, 64, 32, 21, True, True, True),
    (128, 64, 37, 22, True, True, False),
    (128, 64, 27, 23, False, False, True),
    (64, 64, 45, 24, False, True, False)])
def test_deblock_frame_inter_matches_jax(w, h, qp, seed, with_ref,
                                         with_intra, with_part, monkeypatch):
    """With rectangular PUs the JAX side takes `normative_edge_masks`;
    its own edge masks leave inner TU edges out, which the boundary
    strengths show."""
    y, cb, cr, d8 = _frame(w, h, seed)
    rng = np.random.RandomState(seed + 100)
    h8, w8 = h // 8, w // 8
    mvq8 = rng.randint(-9, 10, (h8, w8, 2)).astype(np.int32)
    coef_y = (rng.randint(-3, 4, (h, w))
              * (rng.rand(h, w) < 0.02)).astype(np.int32)
    kw = {}
    if with_ref:
        kw["ref8"] = rng.randint(0, 2, (h8, w8)).astype(np.int32)
    if with_intra:
        kw["intra8"] = rng.rand(h8, w8) < 0.2
    if with_part:
        kw["part8"] = np.where((d8 == 1) | (d8 == 2),
                               rng.randint(0, 3, (h8, w8)), 0).astype(np.int32)
    if with_part:
        own = j_dbk.inter_bs_masks(d8, mvq8, coef_y, **kw)
        monkeypatch.setattr(j_dbk, "edge_masks", normative_edge_masks)
    got = t_dbk.deblock_frame_inter(y, cb, cr, d8, mvq8, coef_y, qp, **kw)
    want = j_dbk.deblock_frame_inter(y, cb, cr, d8, mvq8, coef_y, qp, **kw)
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))
    bs = t_dbk.inter_bs_masks(d8, mvq8, coef_y, **kw)
    jbs = j_dbk.inter_bs_masks(d8, mvq8, coef_y, **kw)
    for g, wv in zip(bs, jbs):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))
    assert {0, 1} <= set(np.unique(bs[0].numpy()))
    if with_part:
        assert not all(np.array_equal(g.numpy(), np.asarray(o))
                       for g, o in zip(bs, own))

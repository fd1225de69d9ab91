"""Batched P-frame CU-tree RD search on the device.

The inter analogue of pipeline/search.py: for every CTU of a P frame at
once, motion estimation for all 85 quadtree nodes (1 + 4 + 16 + 64),
leaf RD costs (reconstruction SSE + lambda * estimated bits) of AMVP,
merge, skip and intra, then the CU tree decided bottom-up — with the
ETH-LSTM HCPM probabilities gating the split decisions by the
reference's three-way rule (HM-16.5_Test_LDP/TEncCu.cpp:437-470, as
masks; `search.decide_tree` is shared with the intra path).

One integer-pel SAD field at 8x8 granularity per CTU (`inter.sad_grid8`)
is pooled bottom-up into the exact SADs of the 16/32/64 nodes (SAD is
additive over sub-blocks at a fixed MV), so the whole quadtree shares
one search pass; each node then gets its own quarter-pel refinement with
the normative MC filters. Inter prediction has no in-frame dependency,
so every depth's full coding (MC, residual, transform, RDOQ, dequant,
inverse transform, reconstruction) runs batched and the decided depth
map selects the surviving leaves per 8x8 unit.

With `rect_pu` (the default, as in the reference) every CU of 16 to 64
also weighs the rectangular partitions 2NxN and Nx2N: each half pools
its exact SAD from the next depth's field and gets its own reference,
quarter sweep and MC. A per-CTU QP raises. Lambda and the motion rates
are bit-exact against the reference's float32 program (its `exp2` and
its fused `2 log2(x) + 1`, emulated on the host: `frame_lambda`,
`_rate_table`); SSEs are summed exactly and rounded once (equal to the
reference's float32 sums below 2^24, where those are exact); small sums
are added in index order. The RD costs can still differ from the
reference's in their last bits (its program fuses products into sums
and orders the bit model's dot product its own way), so a decision
between near-equal costs can differ.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import bits as bits_lib
from ..ops import inter, quant, rdoq as rdoq_lib, transforms
from . import ldp
from . import search as search_lib

_F32 = np.float32
_INF = 3.4e38
#: integer motion search range, +-RADIUS samples around zero
RADIUS = 8
#: CU modes of `PSearchResult.mode8`
AMVP, MERGE, SKIP, INTRA = 0, 1, 2, 3


class PSearchResult(NamedTuple):
    depth8: torch.Tensor    # [B, 8, 8] int32 depth of each 8x8 unit
    mv8: torch.Tensor       # [B, 8, 8, 2] int32 quarter-pel MV per 8x8 unit
    ref8: torch.Tensor      # [B, 8, 8] int32 L0 refIdx per 8x8 unit
    coef_y: torch.Tensor    # [B, 64, 64] int16 quantized luma levels
    coef_cb: torch.Tensor   # [B, 32, 32] int16
    coef_cr: torch.Tensor   # [B, 32, 32] int16
    rec_y: torch.Tensor     # [B, 64, 64] uint8 reconstruction
    rec_cb: torch.Tensor    # [B, 32, 32] uint8
    rec_cr: torch.Tensor    # [B, 32, 32] uint8
    intra8: torch.Tensor    # [B, 8, 8] bool: CU coded intra (intra-in-P)
    imode8: torch.Tensor    # [B, 8, 8] int32 intra luma mode (where intra8)
    part8: torch.Tensor     # [B, 8, 8] int32 PU partition of the CU
    #                         (0 = 2Nx2N, 1 = 2NxN, 2 = Nx2N)
    # beyond the reference's fields, for instrumentation (the coder does
    # not read it): the mode of the unit's CU (AMVP, MERGE, SKIP, INTRA;
    # a rectangular CU counts as AMVP, part8 gives its PU shape)
    mode8: torch.Tensor     # [B, 8, 8] int32


# --------------------------------------------------- float32 transcendentals

def _fma32(a, b, c):
    """float32 a * b + c rounded once (the product is exact in float64)."""
    return _F32(np.float64(_F32(a)) * np.float64(_F32(b)) + np.float64(_F32(c)))


def _exp_f32(x) -> np.float32:
    """e**x in float32 as the reference's compiled CPU program computes
    it: Cephes-style range reduction x = n ln2 + r by fused multiply-adds,
    a degree-5 polynomial in r, then the scale by 2**n."""
    x = min(max(_F32(x), _F32(-87.33654022216796875)),
            _F32(88.72283935546875))
    n = np.floor(_fma32(x, 1.44269504088896341, 0.5))
    r = _fma32(n, -0.693359375, x)
    r = _fma32(n, 2.12194440e-4, r)
    y = _F32(1.9875691500e-4)
    for p in (1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
              1.6666665459e-1, 5.0000001201e-1):
        y = _fma32(y, r, p)
    y = _fma32(y, _F32(r * r), r)
    return _F32(_F32(y + _F32(1.0)) * _F32(2.0 ** int(n)))


def _exp2_f32(x) -> np.float32:
    """2**x in float32: the reference's `exp2` is exp(x * ln2)."""
    return _exp_f32(_F32(_F32(x) * _F32(np.log(2.0))))


def _log_f32(x):
    """Natural log of positive normal float32 values (array), as the
    reference's compiled CPU program computes it: mantissa in
    [sqrt(1/2), sqrt(2)), a degree-8 Cephes polynomial, the exponent
    added back in two parts."""
    x = np.asarray(x, np.float32)
    bits = x.view(np.int32)
    e = ((bits >> 23) - 126).astype(np.float32)
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(np.float32)
    low = m < _F32(0.707106781186547524)
    e = e - low.astype(np.float32)
    m = (m - _F32(1.0)) + np.where(low, m, _F32(0.0))
    z = m * m
    y = np.full_like(m, _F32(7.0376836292e-2))
    for p in (-1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
              1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1,
              -2.4999993993e-1, 3.3333331174e-1):
        y = y * m + _F32(p)
    y = (y * m) * z
    y = y + e * _F32(-2.12194440e-4)
    y = y - z * _F32(0.5)
    return (m + y) + e * _F32(0.693359375)


@functools.lru_cache(maxsize=None)
def _rate_table(device) -> torch.Tensor:
    """[8 * RADIUS + 7] float32: 2 log2(k + 1) + 1 for the integers k
    the motion rates take (up to 8 * RADIUS + 6), as the reference's
    compiled program computes it: log(k + 1) times the constant 2 / ln 2,
    the product fused with the + 1 (one rounding). The log emulation is
    exact against the reference for arguments below 1340."""
    n = 8 * RADIUS + 7
    lg = _log_f32(np.arange(1, n + 1, dtype=np.float32)).astype(np.float64)
    two_over_ln2 = np.float64(_F32(2.0) * _F32(1.0 / _F32(np.log(2.0))))
    return torch.as_tensor((lg * two_over_ln2 + 1.0).astype(np.float32),
                           device=device)


def frame_lambda(qp: int):
    """(lam, sqrt_lam, dist_w) of a frame QP, float32 as the reference
    computes them from a traced QP: lam = 0.57 * 2**((qp - 12) / 3),
    dist_w = 2**((qp - qp_c) / 3), the chroma distortion weight."""
    lam = _F32(_F32(0.57) * _exp2_f32(_F32(_F32(qp) - _F32(12.0))
                                      / _F32(3.0)))
    dist_w = _exp2_f32(_F32(_F32(qp) - _F32(quant.chroma_qp(qp)))
                       / _F32(3.0))
    return lam, _F32(np.sqrt(lam)), dist_w


def _times_lam(lam, k: float) -> float:
    """lam * k rounded to float32, as a Python float."""
    return float(_F32(lam) * _F32(k))


# ------------------------------------------------------------- node layout

def _node_blocks(tiles, depth: int):
    """[B, S, S] CTU-tiles -> [B * 4^depth, s, s] raster node blocks."""
    B, S, _ = tiles.shape
    n = 1 << depth
    s = S // n
    t = tiles.reshape(B, n, s, n, s).permute(0, 1, 3, 2, 4)
    return t.reshape(B * n * n, s, s)


def _blocks_to_tiles(blocks, depth: int, B: int):
    """Inverse of _node_blocks."""
    n = 1 << depth
    s = blocks.shape[-1]
    t = blocks.reshape(B, n, n, s, s).permute(0, 1, 3, 2, 4)
    return t.reshape(B, n * s, n * s)


def _node_origins(ctu_origins, depth: int, chroma: bool = False):
    """[B * 4^depth, 2] plane coords of every node at `depth`."""
    off = search_lib._node_offsets_t(depth, ctu_origins.device)
    o = (ctu_origins[:, None, :] + off[None]).reshape(-1, 2)
    return o // 2 if chroma else o


def _seq_sum(x):
    """Sum over the last axis, added in index order (float32)."""
    out = x[..., 0]
    for k in range(1, x.shape[-1]):
        out = out + x[..., k]
    return out


def _sse(a, b):
    """[N] float32 SSE of [N, h, w] int32 blocks: summed exactly, then
    rounded once."""
    d = a - b
    return (d * d).sum((-2, -1)).to(torch.float32)


def _to_tus(blocks, tu: int):
    """[N, s, s] blocks -> [N * (s // tu)^2, tu, tu] TUs, raster order
    within each block."""
    N, s, _ = blocks.shape
    g = s // tu
    t = blocks.reshape(N, g, tu, g, tu).permute(0, 1, 3, 2, 4)
    return t.reshape(N * g * g, tu, tu)


def _tu_transform(blocks, qp: int, tu: int, lam: float, use_rdoq: bool,
                  is_luma: bool = True):
    """[N, s, s] inter residual blocks -> (levels, recon residual), both
    [N, s, s], with TUs of size `tu` tiled in place: forward transform,
    RDOQ at `lam` (or the plain quantizer), dequantization and inverse
    transform. The P search and the flat tree share it."""
    N, s, _ = blocks.shape
    g = s // tu
    cf = transforms.forward_transform(_to_tus(blocks, tu))
    if use_rdoq:
        lvl = rdoq_lib.rd_quantize(cf, qp, lam, is_intra=False,
                                   is_luma=is_luma)
    else:
        lvl = quant.quantize(cf, qp, is_intra=False)
    rr = transforms.inverse_transform(quant.dequantize(lvl, qp))

    def back(x):
        x = x.reshape(N, g, g, tu, tu).permute(0, 1, 3, 2, 4)
        return x.reshape(N, s, s)

    return back(lvl), back(rr)


def _mvd_bits(mv_q, pred_q):
    """Estimated MVD rate against an approximate predictor (EG1-like
    length): per component 1 + (2 log2(d + 1) + 1 if d > 0). MVs lie
    within 4 * RADIUS + 3 quarter samples of zero."""
    d = (mv_q - pred_q).abs().long()
    r = _rate_table(mv_q.device)[d]
    t = 1.0 + torch.where(d > 0, r, torch.zeros_like(r))
    return t[..., 0] + t[..., 1]


def _neighbor_motion(mv_map, ref_map, B, n, nx, shift):
    """Same-depth neighbour motion over the whole frame's node grid.

    mv_map [B, n, n, 2], ref_map [B, n, n] with B = nx*ny CTUs in raster
    order; shift = (0, 1) for the left neighbour, (1, 0) for above.
    Frame-edge nodes take the zero-MV/ref-0 candidate (the normative
    zero-fill merge candidate, 8.5.3.2.3). Returns (mv [B*n*n, 2],
    ref [B*n*n]) in node-block order.
    """
    ny = B // nx

    def to_frame(a):
        extra = tuple(a.shape[3:])
        g = a.reshape((ny, nx, n, n) + extra).movedim(2, 1)
        return g.reshape((ny * n, nx * n) + extra)

    def to_blocks(g):
        extra = tuple(g.shape[2:])
        a = g.reshape((ny, n, nx, n) + extra).movedim(1, 2)
        return a.reshape((B * n * n,) + extra)

    dy, dx = shift
    mv_g, ref_g = to_frame(mv_map), to_frame(ref_map)
    mv_s = torch.roll(mv_g, (dy, dx), dims=(0, 1))
    ref_s = torch.roll(ref_g, (dy, dx), dims=(0, 1))
    H, W = mv_g.shape[:2]
    dev = mv_map.device
    valid = ((torch.arange(H, device=dev)[:, None] >= dy)
             & (torch.arange(W, device=dev)[None, :] >= dx))
    mv_s = torch.where(valid[..., None], mv_s, torch.zeros_like(mv_s))
    ref_s = torch.where(valid, ref_s, torch.zeros_like(ref_s))
    return to_blocks(mv_s), to_blocks(ref_s)


def _pick(cond, a, b):
    """where(cond, a, b) with cond [N] broadcast over a's trailing axes."""
    return torch.where(cond.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)


# ------------------------------------------------------------------ search

def p_search_frame(cur_y, cur_cb, cur_cr, ref_y, ref_cb, ref_cr,
                   ctu_origins, *, qp, pad_w: int, pad_h: int,
                   hcpm_probs: Optional[torch.Tensor] = None,
                   thr_up=(1.1, 1.1, 1.1), thr_down=(-0.1, -0.1, -0.1),
                   use_rdoq: bool = True, n_active_refs: int = 1,
                   max_depth: int = 3, intra_in_p: bool = True,
                   rect_pu: bool = True):
    """Full quadtree inter search and coding of one P frame.

    cur_*: padded planes (tensors on one device, any integer dtype; that
    device runs the search). ref_*: reference plane stacks [R, H, W]
    (RefPicList0 order, newest first); only the first `n_active_refs`
    are ever selected. ctu_origins: [B, 2] (x, y). qp: the frame QP
    (int). hcpm_probs: [B, 21] ETH-LSTM outputs or None (pure search).
    max_depth: deepest CU level evaluated (clamped up to the forced-split
    floor); deeper levels get never-selected placeholders. Every node
    weighs AMVP against merge and skip; with intra_in_p, intra nodes (the
    All-Intra search's SATD-best mode and RD cost on original-pixel
    references) compete too, their motion is zeroed, and the encoder
    re-codes them normatively (pipeline/intra_p). rect_pu: CUs of 16 to
    64 also weigh 2NxN and Nx2N PUs.
    Returns PSearchResult.
    """
    if np.ndim(qp) != 0:
        raise NotImplementedError(
            "a per-CTU QP is not ported yet (ROADMAP Queue 1, M11)")
    qp = int(qp)
    dev = cur_y.device
    ctu_origins = torch.as_tensor(ctu_origins, device=dev).to(torch.int64)
    B = ctu_origins.shape[0]
    R = ref_y.shape[0]
    n_act = min(int(n_active_refs), R)
    lam32, sqrt_lam32, dist_w32 = frame_lambda(qp)
    lam = float(lam32)
    cqp = quant.chroma_qp(qp)
    f32, i32 = torch.float32, torch.int32
    # ref_idx_l0 TU bin count per value (cMax = n_act - 1)
    ref_bits_tab = torch.tensor(
        [min(i + 1, max(n_act - 1, 1)) if n_act > 1 else 0
         for i in range(R)], dtype=f32, device=dev)

    cur_y_t = ldp._tiles(cur_y, ctu_origins, 64)
    corg_ctu = ctu_origins // 2
    cur_cb_t = ldp._tiles(cur_cb, corg_ctu, 32)
    cur_cr_t = ldp._tiles(cur_cr, corg_ctu, 32)

    # --- shared integer ME fields (one per reference) -----------------------
    n_side = 2 * RADIUS + 1
    sad_by_depth = {3: torch.stack([
        inter.sad_grid8(cur_y_t, ref_y[r], ctu_origins, radius=RADIUS)
        for r in range(R)])}                         # [R, n_cand, B, 8, 8]
    for d in (2, 1, 0):
        s_ = sad_by_depth[d + 1]
        r_, c, b, n, _ = s_.shape
        sad_by_depth[d] = s_.reshape(r_, c, b, n // 2, 2, n // 2, 2
                                     ).sum((4, 6), dtype=torch.int32)
    rate_tab = _rate_table(dev)
    active = torch.arange(R, device=dev)[:, None] < n_act

    def choose(sads):
        """[R, n_cand, N] integer SADs -> (ref_sel [N], integer MV
        [N, 2]): each reference's best MV (first minimum), then the
        reference by SAD + sqrt(lambda) * (ref_idx bins + rough MV rate),
        the first minimum among the active ones."""
        best = torch.argmin(sads, dim=1)                 # [R, N]
        sad_best = sads.amin(dim=1).to(f32)
        mv_r = torch.stack([best % n_side - RADIUS,
                            best // n_side - RADIUS], -1).to(i32)
        mv_rate = rate_tab[mv_r.abs().sum(-1).long()]
        cost = sad_best + float(sqrt_lam32) * (ref_bits_tab[:, None]
                                               + mv_rate)
        cost = torch.where(active, cost, torch.full_like(cost, _INF))
        ref_sel = torch.argmin(cost, dim=0).to(i32)
        mv = torch.gather(mv_r, 0,
                          ref_sel.long()[None, :, None].expand(1, -1, 2))[0]
        return ref_sel, mv

    # --- per-depth node ME + coding ----------------------------------------
    nx_ctu = -(-pad_w // 64)
    mv_maps, ref_maps, intra_maps, imode_maps, cost_maps = {}, {}, {}, {}, {}
    mode_maps = {}
    # PU partition (0 = 2Nx2N, 1 = 2NxN, 2 = Nx2N) and the second PU's
    # motion (where the partition is not 0)
    part_maps, mv2_maps, ref2_maps = {}, {}, {}
    lvl_d = {c: {} for c in ("y", "cb", "cr")}
    rr_d = {c: {} for c in ("y", "cb", "cr")}
    pred_d = {c: {} for c in ("y", "cb", "cr")}
    max_depth = min(3, max(max_depth,
                           search_lib.forced_depth_floor(pad_w, pad_h)))
    for d in range(4):
        n = 1 << d
        s = 64 >> d
        nd = n * n
        if d > max_depth:
            # never-selected placeholders (same contract as the intra
            # search_frame max_depth)
            mv_maps[d] = torch.zeros((B, n, n, 2), dtype=i32, device=dev)
            ref_maps[d] = torch.zeros((B, n, n), dtype=i32, device=dev)
            intra_maps[d] = torch.zeros((B, n, n), dtype=torch.bool,
                                        device=dev)
            imode_maps[d] = torch.ones((B, n, n), dtype=i32, device=dev)
            cost_maps[d] = torch.full((B, nd), _INF, dtype=f32, device=dev)
            mode_maps[d] = part_maps[d] = ref2_maps[d] = ref_maps[d]
            mv2_maps[d] = mv_maps[d]
            for c, size in (("y", s), ("cb", s // 2), ("cr", s // 2)):
                z = torch.zeros((B * nd, size, size), dtype=i32, device=dev)
                lvl_d[c][d] = rr_d[c][d] = pred_d[c][d] = z
            continue

        ref_sel, mv_int = choose(
            sad_by_depth[d].reshape(R, n_side * n_side, B * nd))

        node_org = _node_origins(ctu_origins, d)
        corg = _node_origins(ctu_origins, d, chroma=True)
        cur_blocks = _node_blocks(cur_y_t, d)
        cur_cb_b = _node_blocks(cur_cb_t, d)
        cur_cr_b = _node_blocks(cur_cr_t, d)
        mv_q, _ = inter.quarter_refine_blocks(cur_blocks, ref_y, node_org,
                                              mv_int, s, ref_idx=ref_sel)
        mv_maps[d] = mv_q.reshape(B, n, n, 2)
        ref_maps[d] = ref_sel.reshape(B, n, n)

        def code(p_y, p_cb, p_cr, tu=min(s, 32)):
            """Residual coding of the node at predictions p_* with luma
            TUs of `tu`: (levels, recon residuals, per-plane bits, SSE of
            the reconstruction). bits [N] float32 = the weights model's
            rate estimate (ops/bits) summed over the node's TUs."""
            out = []
            sse = None
            for cur_b, p, q, t, luma in (
                    (cur_blocks, p_y, qp, tu, True),
                    (cur_cb_b, p_cb, cqp, tu // 2, False),
                    (cur_cr_b, p_cr, cqp, tu // 2, False)):
                lvl, rr = _tu_transform(cur_b - p, q, t, lam, use_rdoq,
                                        is_luma=luma)
                bits = _seq_sum(bits_lib.tu_bits(_to_tus(lvl, t),
                                                 is_luma=luma
                                                 ).reshape(lvl.shape[0], -1))
                e = _sse((p + rr).clamp(0, 255), cur_b)
                sse = e if sse is None else sse + e
                out.append((lvl, rr, bits))
            return out, sse

        pred = inter.predict_inter_blocks(ref_y, node_org, mv_q, s,
                                          is_luma=True, ref_idx=ref_sel)
        pred_cb = inter.predict_inter_blocks(ref_cb, corg, mv_q, s // 2,
                                             is_luma=False, ref_idx=ref_sel)
        pred_cr = inter.predict_inter_blocks(ref_cr, corg, mv_q, s // 2,
                                             is_luma=False, ref_idx=ref_sel)
        coded, sse = code(pred, pred_cb, pred_cr)
        bits = (coded[0][2] + coded[1][2]) + coded[2][2]
        # approximate MVD predictor: zero at depth 0, else the CTU's MV
        if d == 0:
            pred_mv = torch.zeros_like(mv_q)
        else:
            pred_mv = mv_maps[0].reshape(B, 1, 2).expand(B, nd, 2
                                                         ).reshape(B * nd, 2)
        bits = ((bits + _mvd_bits(mv_q, pred_mv)) + 6.0
                ) + ref_bits_tab[ref_sel.long()]
        amvp_cost = sse + lam * bits

        # RD-searched merge/skip (xCheckRDCostMerge2Nx2N, TEncCu.cpp:1274
        # counterpart): the left/above same-depth neighbours' (mv, ref)
        # are candidates, as full modes (coded residual) and as
        # zero-residual SKIP; the cheapest of {AMVP, merge, skip} wins the
        # node and its motion goes into the maps, so the coder's
        # normative candidate derivation prices it as merge/skip where the
        # final neighbours agree.
        cands = []
        for shift in ((0, 1), (1, 0)):                 # left, above
            mv_c, ref_c = _neighbor_motion(mv_maps[d], ref_maps[d], B, n,
                                           nx_ctu, shift)
            p_c = inter.predict_inter_blocks(ref_y, node_org, mv_c, s,
                                             is_luma=True, ref_idx=ref_c)
            pcb_c = inter.predict_inter_blocks(ref_cb, corg, mv_c, s // 2,
                                               is_luma=False, ref_idx=ref_c)
            pcr_c = inter.predict_inter_blocks(ref_cr, corg, mv_c, s // 2,
                                               is_luma=False, ref_idx=ref_c)
            sse_c = ((_sse(cur_blocks, p_c) + _sse(cur_cb_b, pcb_c))
                     + _sse(cur_cr_b, pcr_c))
            cands.append((mv_c, ref_c, p_c, pcb_c, pcr_c, sse_c))
        # the better candidate by prediction SSE (above on a win)
        pick_a = cands[1][5] < cands[0][5]
        mv_m, ref_m, pm_y, pm_cb, pm_cr, sse_skip = (
            _pick(pick_a, b_, a_) for a_, b_ in zip(*cands))
        # SKIP: zero residual; rate ~ skip_flag + merge_idx bins
        skip_cost = sse_skip + _times_lam(lam32, 3.0)
        # merge with residual: full coding at the candidate motion
        coded_m, sse_m = code(pm_y, pm_cb, pm_cr)
        mbits = ((coded_m[0][2] + coded_m[1][2]) + coded_m[2][2]) + 5.0
        merge_cost = sse_m + lam * mbits

        all_costs = torch.stack([amvp_cost, merge_cost, skip_cost], 0)
        choice = torch.argmin(all_costs, dim=0)          # first minimum
        cost = all_costs.amin(dim=0)
        use_cand = choice > 0
        is_skip = choice == 2
        mode_maps[d] = choice.reshape(B, n, n).to(i32)   # AMVP/MERGE/SKIP

        def pick(orig, merged, skipped):
            return _pick(is_skip, skipped, _pick(use_cand, merged, orig))

        mv_maps[d] = pick(mv_q, mv_m, mv_m).reshape(B, n, n, 2)
        ref_maps[d] = pick(ref_sel, ref_m, ref_m).reshape(B, n, n)
        for c, (lvl, rr, _), p, (lvl_m, rr_m, _), p_m in zip(
                ("y", "cb", "cr"), coded, (pred, pred_cb, pred_cr), coded_m,
                (pm_y, pm_cb, pm_cr)):
            z = torch.zeros_like(lvl_m)
            lvl_d[c][d] = pick(lvl, lvl_m, z)
            rr_d[c][d] = pick(rr, rr_m, z)
            pred_d[c][d] = pick(p, p_m, p_m)

        part_maps[d] = torch.zeros((B, n, n), dtype=i32, device=dev)
        mv2_maps[d], ref2_maps[d] = mv_maps[d], ref_maps[d]
        if rect_pu and d <= 2:
            # rectangular PUs (TEncCu.cpp:1399 xCheckRDCostInter
            # SIZE_2NxN / SIZE_Nx2N): each half's exact integer SAD pools
            # from the depth+1 field; the halves get their own reference,
            # quarter sweep and MC, and the CU codes the two-PU prediction
            # at the inferred TU split (7.4.9.8 interSplitFlag: TU s/2 for
            # 16/32 CUs, 32 for 64)
            sub = sad_by_depth[d + 1].reshape(R, n_side * n_side, B, n, 2,
                                              n, 2)
            halves = {1: (sub[:, :, :, :, 0].sum(-1, dtype=i32),  # top
                          sub[:, :, :, :, 1].sum(-1, dtype=i32)),  # bottom
                      2: (sub[..., 0].sum(4, dtype=i32),          # left
                          sub[..., 1].sum(4, dtype=i32))}         # right
            tu_r = 32 if s == 64 else s // 2
            rect = {}
            for part, sads_k in halves.items():
                hh, ww = (s // 2, s) if part == 1 else (s, s // 2)
                pus = []
                for k, sads_h in enumerate(sads_k):
                    r_h, mv_i = choose(sads_h.reshape(R, n_side * n_side,
                                                      B * nd))
                    dx, dy = (0, k * hh) if part == 1 else (k * ww, 0)
                    org_h = node_org + torch.tensor([dx, dy], device=dev)
                    corg_h = corg + torch.tensor([dx // 2, dy // 2],
                                                 device=dev)
                    mv_h, _ = inter.quarter_refine_blocks(
                        cur_blocks[:, dy:dy + hh, dx:dx + ww], ref_y, org_h,
                        mv_i, hh, ref_idx=r_h, size_w=ww)
                    preds = [inter.predict_inter_blocks(
                        ref_y, org_h, mv_h, hh, is_luma=True, ref_idx=r_h,
                        size_w=ww)] + [inter.predict_inter_blocks(
                            ref_c, corg_h, mv_h, hh // 2, is_luma=False,
                            ref_idx=r_h, size_w=ww // 2)
                            for ref_c in (ref_cb, ref_cr)]
                    pus.append((mv_h, r_h, preds))
                pr = [torch.cat(pp, 1 if part == 1 else 2)
                      for pp in zip(pus[0][2], pus[1][2])]
                coded_r, sse_r = code(*pr, tu=tu_r)
                # rate: levels, both PUs' MVD (against the CU's predictor)
                # and ref_idx, part_mode bins and flags
                mvb = _mvd_bits(pus[0][0], pred_mv) + _mvd_bits(pus[1][0],
                                                                pred_mv)
                rbits = (((((coded_r[0][2] + coded_r[1][2]) + coded_r[2][2])
                           + mvb) + 10.0) + ref_bits_tab[pus[0][1].long()]
                         ) + ref_bits_tab[pus[1][1].long()]
                rect[part] = (sse_r + lam * rbits, pus, pr, coded_r)

            pick_2 = rect[2][0] < rect[1][0]             # a tie: 2NxN
            rcost = torch.minimum(rect[1][0], rect[2][0])
            use_rect = rcost < cost                      # a tie: square

            def rect_pick(get, orig):
                """where(use_rect, the picked part's value, orig)."""
                return _pick(use_rect, _pick(pick_2, get(rect[2]),
                                             get(rect[1])), orig)

            cost = torch.minimum(rcost, cost)
            mv_q = rect_pick(lambda r: r[1][0][0], mv_maps[d].reshape(-1, 2))
            ref_sel = rect_pick(lambda r: r[1][0][1], ref_maps[d].reshape(-1))
            mv_maps[d] = mv_q.reshape(B, n, n, 2)
            ref_maps[d] = ref_sel.reshape(B, n, n)
            mv2_maps[d] = rect_pick(lambda r: r[1][1][0], mv_q
                                    ).reshape(B, n, n, 2)
            ref2_maps[d] = rect_pick(lambda r: r[1][1][1], ref_sel
                                     ).reshape(B, n, n)
            part_maps[d] = torch.where(
                use_rect, torch.where(pick_2, 2, 1), 0).to(i32).reshape(
                B, n, n)
            mode_maps[d] = mode_maps[d].masked_fill(
                use_rect.reshape(B, n, n), AMVP)
            for ci, c in enumerate(("y", "cb", "cr")):
                lvl_d[c][d] = rect_pick(lambda r: r[3][ci][0], lvl_d[c][d])
                rr_d[c][d] = rect_pick(lambda r: r[3][ci][1], rr_d[c][d])
                pred_d[c][d] = rect_pick(lambda r: r[2][ci], pred_d[c][d])

        if intra_in_p:
            # intra escape inside P frames (TEncCu.cpp:1438 /
            # HM-16.5_Test_LDP TEncCu.cpp:746-803): the All-Intra
            # search's SATD-best mode and refined RD cost on original-
            # pixel references compete per node with the inter modes
            m_i, _ = search_lib._best_mode_per_node(
                cur_y, ctu_origins, d, pad_w, pad_h, nx_ctu)
            icost = search_lib._refined_costs(
                cur_y, ctu_origins, d, m_i, qp, lam, pad_w=pad_w,
                pad_h=pad_h, n_ctu_x=nx_ctu)
            for cp in (cur_cb, cur_cr):
                icost = icost + search_lib._refined_chroma_costs(
                    cp, ctu_origins, d, m_i, cqp, lam, float(dist_w32),
                    pad_w=pad_w, pad_h=pad_h, n_ctu_x=nx_ctu)
            # overhead: pred_mode + part + intra dir + cbfs
            icost = icost.reshape(-1) + _times_lam(lam32, 11.5)
            is_intra = icost < cost
            cost = torch.minimum(icost, cost)
            intra_maps[d] = is_intra.reshape(B, n, n)
            imode_maps[d] = m_i.reshape(B, n, n).to(i32)
            mv_maps[d] = mv_maps[d].masked_fill(intra_maps[d][..., None], 0)
            ref_maps[d] = ref_maps[d].masked_fill(intra_maps[d], 0)
            part_maps[d] = part_maps[d].masked_fill(intra_maps[d], 0)
            mode_maps[d] = mode_maps[d].masked_fill(intra_maps[d], INTRA)
        else:
            intra_maps[d] = torch.zeros((B, n, n), dtype=torch.bool,
                                        device=dev)
            imode_maps[d] = torch.ones((B, n, n), dtype=i32, device=dev)
        cost_maps[d] = cost.reshape(B, nd)

    _, _, _, depth8 = search_lib.decide_tree(
        cost_maps, ctu_origins, pad_w=pad_w, pad_h=pad_h,
        split_bits=_times_lam(lam32, 2.0), hcpm_probs=hcpm_probs,
        thr_up=thr_up, thr_down=thr_down)
    depth8 = depth8.to(i32)
    dsel = depth8.long()

    # --- the final coding per 8x8 unit: each unit takes its depth's node
    def select_plane(per_depth, unit):
        planes = torch.stack([_blocks_to_tiles(per_depth[d], d, B)
                              for d in range(4)], -1)   # [B, S, S, 4]
        dmap = dsel.repeat_interleave(unit, 1).repeat_interleave(unit, 2)
        return torch.gather(planes, -1, dmap[..., None])[..., 0]

    def up(m, d):
        """[B, n, n, ...] per-node map at depth d -> [B, 8, 8, ...]."""
        return m.repeat_interleave(8 >> d, 1).repeat_interleave(8 >> d, 2)

    def select_unit(per):
        """[B, 8, 8, ...]: each 8x8 unit's value at its depth, from the
        per-depth unit maps `per`."""
        st = torch.stack(per, 3)                         # [B, 8, 8, 4, ...]
        idx = dsel.reshape(B, 8, 8, 1, *([1] * (st.dim() - 4)))
        idx = idx.expand(B, 8, 8, 1, *st.shape[4:])
        return torch.gather(st, 3, idx)[:, :, :, 0]

    def select_maps(maps):
        return select_unit([up(maps[d], d) for d in range(4)])

    def unit_motion(d):
        """(mv, ref) of each 8x8 unit at depth d: the units of the second
        PU of a 2NxN (bottom) or Nx2N (right) CU take mv2 / ref2."""
        u = 8 >> d
        mv, ref = up(mv_maps[d], d), up(ref_maps[d], d)
        if rect_pu and d <= 2:
            pt = up(part_maps[d], d)
            pos = torch.arange(8, device=dev) % u >= u // 2
            in_pu1 = (((pt == 1) & pos[None, :, None])
                      | ((pt == 2) & pos[None, None, :]))
            mv = torch.where(in_pu1[..., None], up(mv2_maps[d], d), mv)
            ref = torch.where(in_pu1, up(ref2_maps[d], d), ref)
        return mv, ref

    motion = [unit_motion(d) for d in range(4)]
    out = {}
    for c, unit in (("y", 8), ("cb", 4), ("cr", 4)):
        out["coef_" + c] = select_plane(lvl_d[c], unit).to(torch.int16)
        rec = select_plane(pred_d[c], unit) + select_plane(rr_d[c], unit)
        out["rec_" + c] = rec.clamp(0, 255).to(torch.uint8)
    return PSearchResult(
        depth8=depth8, mv8=select_unit([m for m, _ in motion]),
        ref8=select_unit([r for _, r in motion]),
        intra8=select_maps(intra_maps), imode8=select_maps(imode_maps),
        part8=select_maps(part_maps), mode8=select_maps(mode_maps), **out)

"""HEVC deblocking filter (H.265 8.7.2) as whole-plane tensor ops.

Behavioral counterpart: HM TComLoopFilter.cpp:130 (loopFilterPic).

Deblocking reads at most 4 samples each side of an 8-aligned edge, and
edges are 8 apart — regions touch but never overlap, so *every* vertical
edge of the picture filters in one tensor op (roll + reshape into
[.., W/8, 8] windows), then every horizontal edge on the result. In
all-intra streams bS is always 2, and intra prediction uses unfiltered
reconstruction, so the filter is a pure post-pass on the recon planes
(the bitstream only changes via the PPS deblocking flags).

Functions take tensors (or arrays) and return int32 tensors on the
plane's device; they never write into a caller's tensor. The chroma
planes of a picture whose padded height (or width) is an odd multiple of
8 luma samples (1080p: 540 chroma rows) are zero-padded to a multiple of
8 for the filter and cropped after it: no edge reads or writes the
padding.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import quant as quant_lib

# Table 8-12 (beta') and tc' tables
BETA_TABLE = np.array(
    [0] * 16 + [6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22,
                24, 26, 28, 30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50,
                52, 54, 56, 58, 60, 62, 64], np.int32)
TC_TABLE = np.array(
    [0] * 18 + [1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4,
                4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20,
                22, 24], np.int32)


def _t(a, device=None, dtype=torch.int32):
    """`a` (tensor or array) as a tensor of `dtype` on `device`; None
    keeps a tensor where it is. A copy only where needed."""
    return torch.as_tensor(a, dtype=dtype, device=device)


def tu_size8(depth8, part8=None):
    """[H8, W8] TU size (min(cu,32)) per 8x8 cell from the depth map.
    Rectangular-PU CUs (part8 != 0) at 16/32 infer one TU split
    (7.4.9.8 interSplitFlag) -> TU = cu/2."""
    depth8 = _t(depth8)
    cu = 64 >> depth8
    tu = cu.clamp(max=32)
    if part8 is not None:
        p = _t(part8, depth8.device)
        tu = torch.where((p != 0) & (cu <= 32), cu // 2, tu)
    return tu


def edge_masks(depth8, part8=None):
    """(vert [H8, W8], horz [H8, W8]) bool: does an edge run along the
    left / top border of each 8x8 cell (TU/CU boundaries, bS=2 intra).

    part8: optional [H8, W8] inter PU partition per cell (0 = 2Nx2N,
    1 = 2NxN, 2 = Nx2N). A rectangular CU's TU splits once (`tu_size8`),
    so every TU edge inside it is an edge (8.7.2.3), its prediction
    edge through the CU middle (8.7.2.2) among them. The reference's
    `edge_masks` takes the TU size of the depth alone and adds only the
    prediction edge, leaving the other inner TU edge of a 16x16 or 32x32
    rectangular CU unfiltered, which HM filters (ROADMAP Queue 3)."""
    t8 = tu_size8(depth8, part8)
    dev = t8.device
    h8, w8 = t8.shape
    x8 = torch.arange(w8, device=dev)[None, :]
    y8 = torch.arange(h8, device=dev)[:, None]
    vert = ((x8 * 8) % t8 == 0) & (x8 > 0)
    horz = ((y8 * 8) % t8 == 0) & (y8 > 0)
    return vert, horz


def _filter_luma_windows(win, edge_on, beta, tc):
    """Filter 8-wide windows around vertical edges.

    win: [G, 4, 8] int32 — G groups of 4 rows; columns p3..p0,q0..q3.
    edge_on: [G] bool; beta, tc: [G] int32. Returns filtered [G, 4, 8].
    """
    p = win
    p3, p2, p1, p0 = p[:, :, 0], p[:, :, 1], p[:, :, 2], p[:, :, 3]
    q0, q1, q2, q3 = p[:, :, 4], p[:, :, 5], p[:, :, 6], p[:, :, 7]

    dp0 = (p2[:, 0] - 2 * p1[:, 0] + p0[:, 0]).abs()
    dp3 = (p2[:, 3] - 2 * p1[:, 3] + p0[:, 3]).abs()
    dq0 = (q2[:, 0] - 2 * q1[:, 0] + q0[:, 0]).abs()
    dq3 = (q2[:, 3] - 2 * q1[:, 3] + q0[:, 3]).abs()
    dpq0 = dp0 + dq0
    dpq3 = dp3 + dq3
    dp = dp0 + dp3
    dq = dq0 + dq3
    d = dpq0 + dpq3
    filter_on = edge_on & (d < beta)

    def strong_cond(i):
        sp = (p3[:, i] - p0[:, i]).abs() + (q0[:, i] - q3[:, i]).abs()
        spq = (p0[:, i] - q0[:, i]).abs()
        dd = dpq0 if i == 0 else dpq3
        return ((2 * dd < (beta >> 2))
                & (sp < (beta >> 3))
                & (spq < ((5 * tc + 1) >> 1)))

    strong = filter_on & strong_cond(0) & strong_cond(3)

    tcc = tc[:, None]

    # strong filter (clipped +-2tc around original)
    def cl(v, ref):
        return torch.clamp(v, ref - 2 * tcc, ref + 2 * tcc)

    sp0 = cl((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3, p0)
    sp1 = cl((p2 + p1 + p0 + q0 + 2) >> 2, p1)
    sp2 = cl((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    sq0 = cl((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3, q0)
    sq1 = cl((p0 + q0 + q1 + q2 + 2) >> 2, q1)
    sq2 = cl((p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3, q2)

    # weak filter
    side_thresh = (beta + (beta >> 1)) >> 3
    dEp = dp < side_thresh
    dEq = dq < side_thresh
    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    weak_on = delta.abs() < 10 * tcc
    dlt = torch.clamp(delta, -tcc, tcc)
    wp0 = (p0 + dlt).clamp(0, 255)
    wq0 = (q0 - dlt).clamp(0, 255)
    tc2 = tcc >> 1
    dp1v = torch.clamp((((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1, -tc2, tc2)
    dq1v = torch.clamp((((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1, -tc2, tc2)
    wp1 = (p1 + dp1v).clamp(0, 255)
    wq1 = (q1 + dq1v).clamp(0, 255)

    s = strong[:, None]
    w = (filter_on & ~strong)[:, None] & weak_on
    wep = w & dEp[:, None]
    weq = w & dEq[:, None]

    out = p.clone()
    out[:, :, 1] = torch.where(s, sp2, p2)
    out[:, :, 2] = torch.where(s, sp1, torch.where(wep, wp1, p1))
    out[:, :, 3] = torch.where(s, sp0, torch.where(w, wp0, p0))
    out[:, :, 4] = torch.where(s, sq0, torch.where(w, wq0, q0))
    out[:, :, 5] = torch.where(s, sq1, torch.where(weq, wq1, q1))
    out[:, :, 6] = torch.where(s, sq2, q2)
    return out


def _deblock_luma_vertical(plane, vert_mask, qp, bs=None):
    """Filter all vertical luma edges. plane: [H, W] int32.

    bs: optional [H8, W8] int32 boundary strength per 8x8 cell (inter
    slices; 0 = no filtering, 1/2 pick the tc index Q = qp + 2*(bS-1),
    8.7.2.5.3). bs=None means all-intra: bS = 2 on every masked edge.
    """
    H, W = plane.shape
    dev = plane.device
    beta = int(BETA_TABLE[min(max(qp, 0), 51)])
    if bs is None:
        edge_cell = vert_mask
        tc_cell = torch.full(edge_cell.shape,
                             int(TC_TABLE[min(max(qp + 2, 0), 53)]),
                             dtype=torch.int32, device=dev)
    else:
        bs = _t(bs, dev)
        edge_cell = vert_mask & (bs > 0)
        qidx = torch.clamp(qp + 2 * (bs - 1), 0, 53)
        tc_cell = _t(TC_TABLE, dev)[qidx.long()]
    rolled = torch.roll(plane, 4, dims=1)        # col 8k-4 -> block k col 0
    # group rows by 4: [H/4, 4, W/8, 8] -> [W/8 * H/4, 4, 8]
    g = rolled.reshape(H // 4, 4, W // 8, 8).permute(2, 0, 1, 3)
    g = g.reshape(-1, 4, 8)
    # edge flags per (x8, 4-row group): masks are per 8x8 cell
    edge_on = edge_cell.T.repeat_interleave(2, dim=1).reshape(-1)
    tcs = tc_cell.T.repeat_interleave(2, dim=1).reshape(-1)
    betas = torch.full_like(tcs, beta)
    out = _filter_luma_windows(g, edge_on, betas, tcs)
    out = out.reshape(W // 8, H // 4, 4, 8).permute(1, 2, 0, 3)
    out = out.reshape(H, W)
    return torch.roll(out, -4, dims=1)


def deblock_luma(plane, depth8, qp: int, bs_vert=None, bs_horz=None,
                 part8=None):
    """Full luma deblock: vertical edges then horizontal edges."""
    plane = _t(plane)
    dev = plane.device
    vert, horz = edge_masks(_t(depth8, dev),
                            None if part8 is None else _t(part8, dev))
    out = _deblock_luma_vertical(plane, vert, qp, bs_vert)
    out = _deblock_luma_vertical(
        out.T, horz.T, qp, None if bs_horz is None else _t(bs_horz, dev).T).T
    return out


def _nz_tu8(coef_y, tu8):
    """[H8, W8] bool: the luma TB containing each 8x8 cell has nonzero
    coefficient levels (bS condition, 8.7.2.4)."""
    coef_y = _t(coef_y, tu8.device)
    H, W = coef_y.shape
    nz8 = (coef_y.reshape(H // 8, 8, W // 8, 8) != 0).any(3).any(1)

    def pool_or(m, k):
        h, w = m.shape
        p = m.reshape(h // k, k, w // k, k).any(3).any(1)
        return p.repeat_interleave(k, 0).repeat_interleave(k, 1)

    nz16 = pool_or(nz8, 2)
    nz32 = pool_or(nz8, 4)
    return torch.where(tu8 == 8, nz8, torch.where(tu8 == 16, nz16, nz32))


def inter_bs_masks(depth8, mvq8, coef_y, ref8=None, intra8=None,
                   part8=None):
    """Boundary strengths for a P slice per 8x8 cell.

    H.265 8.7.2.4 under uni-prediction: bS = 2 on an edge where either
    side is intra-coded (intra8; None = all inter); otherwise bS = 1 on
    a PU/TU edge iff either side's luma TB has nonzero coefficients, the
    two sides use different reference pictures (ref8 = per-8x8 L0
    refIdx; None = all identical), or the MV difference reaches a full
    sample (|dx| >= 4 or |dy| >= 4 quarter-pel units).
    Returns (bs_vert, bs_horz) int32 [H8, W8] aligned with edge_masks.
    """
    depth8 = _t(depth8)
    dev = depth8.device
    mv = _t(mvq8, dev)
    part8 = None if part8 is None else _t(part8, dev)
    tu8 = tu_size8(depth8, part8)
    nz = _nz_tu8(coef_y, tu8)
    vert, horz = edge_masks(depth8, part8)

    mvd_v = (mv - torch.roll(mv, 1, dims=1)).abs().amax(-1) >= 4
    nz_v = nz | torch.roll(nz, 1, dims=1)
    mvd_h = (mv - torch.roll(mv, 1, dims=0)).abs().amax(-1) >= 4
    nz_h = nz | torch.roll(nz, 1, dims=0)
    if ref8 is not None:
        r = _t(ref8, dev)
        mvd_v = mvd_v | (r != torch.roll(r, 1, dims=1))
        mvd_h = mvd_h | (r != torch.roll(r, 1, dims=0))
    bs_v = (vert & (mvd_v | nz_v)).to(torch.int32)
    bs_h = (horz & (mvd_h | nz_h)).to(torch.int32)
    if intra8 is not None:
        it = _t(intra8, dev, torch.bool)
        i_v = it | torch.roll(it, 1, dims=1)
        i_h = it | torch.roll(it, 1, dims=0)
        two = torch.full_like(bs_v, 2)
        bs_v = torch.where(vert & i_v, two, bs_v)
        bs_h = torch.where(horz & i_h, two, bs_h)
    return bs_v, bs_h


def _filter_chroma_windows(win, edge_on, tc):
    """win: [G, 4, 4] columns p1,p0,q0,q1 (4-row groups)."""
    p1, p0 = win[:, :, 0], win[:, :, 1]
    q0, q1 = win[:, :, 2], win[:, :, 3]
    tcc = tc[:, None]
    delta = torch.clamp(((((q0 - p0) << 2) + p1 - q1 + 4) >> 3), -tcc, tcc)
    np0 = (p0 + delta).clamp(0, 255)
    nq0 = (q0 - delta).clamp(0, 255)
    e = edge_on[:, None]
    out = win.clone()
    out[:, :, 1] = torch.where(e, np0, p0)
    out[:, :, 2] = torch.where(e, nq0, q0)
    return out


def _deblock_chroma_vertical(plane, edge16_mask, cqp, edge_fine=None):
    """Chroma vertical edges: every 8 chroma samples where the co-located
    luma 16-grid edge exists. plane: [Hc, Wc]; edge16_mask: [Hc//8, Wc//8]
    (bool per 8-chroma cell == 16-luma cell). edge_fine: optional
    [Hc//4, Wc//8] mask at 4-chroma-row (= one luma 8-cell row)
    granularity — used by the P path where bS = 2 varies along the
    edge; overrides edge16_mask."""
    H, W = plane.shape
    tc = int(TC_TABLE[min(max(cqp + 2, 0), 53)])
    full = torch.roll(plane, 2, dims=1).reshape(H, W // 8, 8)  # new tensor
    win = full[:, :, :4]                                       # p1 p0 q0 q1
    g = win.reshape(H // 4, 4, W // 8, 4).permute(2, 0, 1, 3)
    g = g.reshape(-1, 4, 4)
    if edge_fine is not None:
        vm = edge_fine.T                                       # [W8c, H/4]
    else:
        vm = edge16_mask.T.repeat_interleave(2, dim=1)
    edge_on = vm.reshape(-1)
    tcs = torch.full(edge_on.shape, tc, dtype=torch.int32,
                     device=plane.device)
    out4 = _filter_chroma_windows(g, edge_on, tcs)
    out4 = out4.reshape(W // 8, H // 4, 4, 4).permute(1, 2, 0, 3)
    full[:, :, :4] = out4.reshape(H, W // 8, 4)
    return torch.roll(full.reshape(H, W), -2, dims=1)


def chroma_edge_masks(depth8):
    """Edges on the 16-luma grid for chroma: [ceil(H8/2), ceil(W8/2)]
    bools (the luma edge of every even 8-cell row and column)."""
    vert, horz = edge_masks(depth8)
    return vert[::2, ::2], horz[::2, ::2]


def deblock_chroma(plane, depth8, cqp: int):
    plane = _t(plane)
    H, W = plane.shape
    v16, h16 = chroma_edge_masks(_t(depth8, plane.device))
    # pad to the 8x8 chroma grid of the masks (see the module docstring)
    ph, pw = 8 * v16.shape[0] - H, 8 * v16.shape[1] - W
    if ph or pw:
        plane = F.pad(plane, (0, pw, 0, ph))
    out = _deblock_chroma_vertical(plane, v16, cqp)
    out = _deblock_chroma_vertical(out.T, h16.T, cqp).T
    return out[:H, :W]


def deblock_frame(recon_y, recon_cb, recon_cr, depth8, qp: int):
    """Deblock all planes (post-pass; output/hash picture)."""
    cqp = quant_lib.chroma_qp(qp)
    y = deblock_luma(recon_y, depth8, qp)
    cb = deblock_chroma(recon_cb, depth8, cqp)
    cr = deblock_chroma(recon_cr, depth8, cqp)
    return y, cb, cr


def deblock_frame_inter(recon_y, recon_cb, recon_cr, depth8, mvq8, coef_y,
                        qp: int, ref8=None, intra8=None, part8=None):
    """Deblock a P picture: luma edges at bS >= 1 where the normative
    conditions hold; chroma is filtered only at bS = 2 edges, i.e. where
    an intra-coded CU borders the edge (8.7.2.5.5) — with no intra CUs
    chroma passes through."""
    y = _t(recon_y)
    dev = y.device
    bs_v, bs_h = inter_bs_masks(_t(depth8, dev), mvq8, coef_y, ref8, intra8,
                                part8)
    y = deblock_luma(y, depth8, qp, bs_v, bs_h, part8=part8)
    cb = _t(recon_cb, dev)
    cr = _t(recon_cr, dev)
    if intra8 is not None:
        cqp = quant_lib.chroma_qp(qp)
        # chroma filters only 16-luma-grid edges, at segments where
        # bS = 2; rows keep 8-luma (4-chroma-row) granularity
        fine_v = (bs_v == 2)[:, ::2]       # [H8, W16]
        fine_h = (bs_h == 2)[::2, :]       # [H16, W8]
        z16 = torch.zeros((fine_v.shape[0] // 2, fine_v.shape[1]),
                          dtype=torch.bool, device=dev)
        cb = _deblock_chroma_vertical(cb, z16, cqp, edge_fine=fine_v)
        cb = _deblock_chroma_vertical(cb.T, z16.T, cqp,
                                      edge_fine=fine_h.T).T
        cr = _deblock_chroma_vertical(cr, z16, cqp, edge_fine=fine_v)
        cr = _deblock_chroma_vertical(cr.T, z16.T, cqp,
                                      edge_fine=fine_h.T).T
    return y, cb, cr
